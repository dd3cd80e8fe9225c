"""Seeded scenes for the benchmark's traffic, made on the device.

Everything is drawn from one `torch.Generator` seeded with `--seed`, in a
fixed order and in a few large calls, so one seed gives the same frames on
every run and every seed gives frames of the same sizes.

Stereo: each scene is a textured background plane and a few bulging
objects at 0.4-3 m in front of a rectified rig. The texture is painted on
the surfaces (value noise at three scales, evaluated at the left view's
rectified coordinates), so the right view sees it shifted by the
disparity f * B / Z. Raw frames are rendered through the inverse of the
rig's rectification (undistortion and the rectifying rotation), so that
rectifying them recovers the scene; rectified frames skip that step.

RGB-D: a D415-like camera on an arc around a set of spheres in front of a
wall and above a floor, ray-cast to z16 depth (millimetres, 0 where there
is no return) and a checkered bgr8 colour image.
"""
from __future__ import annotations

import math
import random

import numpy as np
import torch

F64 = torch.float64


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def chosen(seed: int, count: int, lo: int, hi: int) -> list:
    """`count` distinct indices in [lo, hi), drawn from the seed: the frames
    or steps a run compares with the reference."""
    return sorted(random.Random(int(seed) * 7919 + 17).sample(range(lo, hi), count))


def host_frames(t: torch.Tensor, device) -> torch.Tensor:
    """Frames copied to host memory, page-locked when they are to feed a
    card, as a capture pipeline's DMA buffers are (pageable buffers made
    the stereo cells' uploads slow and their rates swing with the host's
    load)."""
    t = t.cpu()
    return t.pin_memory() if torch.device(device).type == "cuda" else t


def _rand(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device, dtype=F64)


def _bilinear(grid: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """grid (n, gh, gw) sampled at float cell coordinates x, y (n, ...),
    clamped to the grid."""
    n, gh, gw = grid.shape
    x = x.clamp(0, gw - 1.001)
    y = y.clamp(0, gh - 1.001)
    x0, y0 = x.floor(), y.floor()
    fx, fy = x - x0, y - y0
    xi, yi = x0.long(), y0.long()
    flat = grid.reshape(n, -1)
    idx = (yi * gw + xi).reshape(n, -1)

    def tap(off):
        return torch.gather(flat, 1, idx + off).reshape(x.shape)

    top = tap(0) * (1 - fx) + tap(1) * fx
    bot = tap(gw) * (1 - fx) + tap(gw + 1) * fx
    return top * (1 - fy) + bot * fy


class StereoScenes:
    """n scenes of an (H, W) rectified rig with focal f (px) and baseline B (m)."""

    CELLS = (48.0, 9.0, 2.5)  # texture scales, px of the left rectified view
    AMPS = (0.45, 0.35, 0.3)
    OBJECTS = 6

    def __init__(self, n, W, H, f, B, seed, device):
        self.n, self.W, self.H, self.fB = n, W, H, f * B
        self.device = torch.device(device)
        g = generator(seed, self.device)
        dev = self.device
        self.grids = [torch.randn((n, int(H / c) + 8, int(W / c) + 24), generator=g, device=dev,
                                  dtype=F64) for c in self.CELLS]
        self.bg = _rand(g, (n, 3), 0.0, 1.0, dev)  # base depth, x and y gradients
        self.obj = _rand(g, (n, self.OBJECTS, 6), 0.0, 1.0, dev)  # x, y, rx, ry, z, bulge
        self.gain = _rand(g, (n, 3), 0.75, 1.05, dev)  # per-channel gain of the colour frames
        self.gen = g

    # depth of the left rectified view at float pixel coordinates (n, ...)
    def depth_left(self, x, y):
        W, H = self.W, self.H
        bg = self.bg.reshape(self.n, *([1] * (x.ndim - 1)), 3)
        z = (2.0 + 0.6 * bg[..., 0]) + (bg[..., 1] - 0.5) * 0.6 * (x / W - 0.5) \
            + (bg[..., 2] - 0.5) * 0.6 * (y / H - 0.5)
        for k in range(self.OBJECTS):
            o = self.obj[:, k].reshape(self.n, *([1] * (x.ndim - 1)), 6)
            cx, cy = o[..., 0] * W, o[..., 1] * H
            rx, ry = (0.04 + 0.12 * o[..., 2]) * W, (0.06 + 0.2 * o[..., 3]) * H
            r2 = ((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2
            zo = 0.45 + 1.1 * o[..., 4] - 0.05 * o[..., 5] * torch.sqrt(torch.clamp(1 - r2, min=0))
            z = torch.where(r2 < 1.0, torch.minimum(z, zo), z)
        return z

    def disparity_left(self, x, y):
        return self.fB / self.depth_left(x, y)

    def texture(self, x, y):
        """Gray level (about 0-255) of the surface seen at left rectified (x, y)."""
        v = 0.0
        for grid, c, a in zip(self.grids, self.CELLS, self.AMPS):
            v = v + a * _bilinear(grid, x / c + 12.0, y / c + 4.0)
        return 128.0 + 70.0 * v

    def right_source(self, xr, y):
        """Left rectified x of the surface point that the right view sees at (xr, y)."""
        xl = xr + self.disparity_left(xr, y)
        for _ in range(2):
            xl = xr + self.disparity_left(xl, y)
        return xl

    def _noise(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device, dtype=F64)

    def rectified_gray(self):
        """(left, right) uint8 (n, H, W) rectified gray frames."""
        ys, xs = torch.meshgrid(torch.arange(self.H, dtype=F64, device=self.device),
                                torch.arange(self.W, dtype=F64, device=self.device), indexing="ij")
        x = xs.expand(self.n, -1, -1)
        y = ys.expand(self.n, -1, -1)
        left = self.texture(x, y)
        right = self.texture(self.right_source(x, y), y)
        out = []
        for img in (left, right):
            img = img + 1.5 * self._noise(img.shape)
            out.append(torch.clamp(torch.round(img), 0, 255).to(torch.uint8))
        return out[0], out[1]

    def raw_bgr(self, rig: dict):
        """(left, right) uint8 (n, H, W, 3) raw colour frames: each raw pixel
        shows the scene at its rectified coordinates under the rig."""
        frames = []
        for side, (K, dist, R, P) in enumerate(((rig["K1"], rig["dist1"], rig["R1"], rig["P1"]),
                                                (rig["K2"], rig["dist2"], rig["R2"], rig["P2"]))):
            x, y = raw_to_rect(K, dist, R, P, self.W, self.H, self.device)
            x = x.expand(self.n, -1, -1)
            y = y.expand(self.n, -1, -1)
            v = self.texture(x if side == 0 else self.right_source(x, y), y)
            gain = self.gain[:, None, None, :]
            img = v[..., None] * gain + 1.5 * self._noise((self.n, self.H, self.W, 3))
            frames.append(torch.clamp(torch.round(img), 0, 255).to(torch.uint8))
        return frames[0], frames[1]


def raw_to_rect(K, dist, R, P, W, H, device, iters=20):
    """Rectified (x, y) float64 (H, W) of every raw pixel of a camera: the
    raw pixel undistorted by fixed-point iteration, turned by the rectifying
    rotation R and projected by P's 3x3 part."""
    K = np.asarray(K, np.float64)
    d = np.zeros(5)
    dd = np.asarray(dist, np.float64).reshape(-1)[:5]
    d[:dd.size] = dd
    k1, k2, p1, p2, k3 = (float(v) for v in d)
    v, u = torch.meshgrid(torch.arange(H, dtype=F64, device=device),
                          torch.arange(W, dtype=F64, device=device), indexing="ij")
    yd = (v - K[1, 2]) / K[1, 1]
    xd = (u - K[0, 2] - K[0, 1] * yd) / K[0, 0]
    x, y = xd.clone(), yd.clone()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    Rm = torch.as_tensor(np.asarray(R, np.float64), device=device)
    ray = torch.stack([x, y, torch.ones_like(x)], -1) @ Rm.T
    P = np.asarray(P, np.float64)
    xr = P[0, 0] * ray[..., 0] / ray[..., 2] + P[0, 2]
    yr = P[1, 1] * ray[..., 1] / ray[..., 2] + P[1, 2]
    return xr, yr


class RGBDOrbit:
    """n posed D415 frames on a seeded arc around a seeded scene."""

    SPHERES = 6

    def __init__(self, n, cam: dict, volume_center, seed, device):
        self.n, self.cam = n, cam
        self.device = torch.device(device)
        g = generator(seed, self.device)
        dev = self.device
        c = torch.as_tensor(volume_center, dtype=F64, device=dev)
        self.center = c
        u = _rand(g, (self.SPHERES, 7), 0.0, 1.0, dev)
        self.sph_c = c + torch.stack([0.56 * u[:, 0] - 0.28, 0.4 * u[:, 1] - 0.2,
                                      0.36 * u[:, 2] - 0.12], -1)
        self.sph_r = 0.05 + 0.1 * u[:, 3]
        self.sph_rgb = 50.0 + 170.0 * u[:, 4:7]
        p = _rand(g, (4,), 0.0, 1.0, dev)
        self.wall_z = float(c[2]) + 0.36 + 0.04 * float(p[0])
        self.floor_y = float(c[1]) + 0.27 + 0.04 * float(p[1])
        self.plane_rgb = _rand(g, (2, 3), 60.0, 210.0, dev)
        theta0 = math.radians(-20.0 + 40.0 * float(p[2]))
        span = math.radians(60.0)
        k = torch.arange(n, dtype=F64, device=dev)
        self.theta = theta0 + (k / max(n - 1, 1) - 0.5) * span
        self.height = -0.12 + 0.05 * torch.sin(3.0 * self.theta + 6.0 * float(p[3]))
        self.radius = 0.85
        self.gen = g

    def world_from_cam(self) -> torch.Tensor:
        """(n, 4, 4) float64 poses looking at the scene's centre (y down)."""
        dev = self.device
        C = self.center + torch.stack([self.radius * torch.sin(self.theta), self.height,
                                       -self.radius * torch.cos(self.theta)], -1)
        z = self.center - C
        z = z / z.norm(dim=-1, keepdim=True)
        down = torch.tensor([0.0, 1.0, 0.0], dtype=F64, device=dev).expand_as(z)
        x = torch.linalg.cross(down, z)
        x = x / x.norm(dim=-1, keepdim=True)
        y = torch.linalg.cross(z, x)
        T = torch.eye(4, dtype=F64, device=dev).repeat(self.n, 1, 1)
        T[:, :3, 0], T[:, :3, 1], T[:, :3, 2], T[:, :3, 3] = x, y, z, C
        return T

    def render(self):
        """(depth z16 (n, H, W) uint16 as int32, colour (n, H, W, 3) uint8,
        world_from_cam (n, 4, 4) float64)."""
        cam, dev = self.cam, self.device
        H, W = cam["height"], cam["width"]
        v, u = torch.meshgrid(torch.arange(H, dtype=F64, device=dev),
                              torch.arange(W, dtype=F64, device=dev), indexing="ij")
        d_cam = torch.stack([(u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"],
                             torch.ones_like(u)], -1)  # (H, W, 3), z = 1
        T = self.world_from_cam()
        dirs = torch.einsum("nij,hwj->nhwi", T[:, :3, :3], d_cam)  # world, per unit camera z
        org = T[:, None, None, :3, 3]
        inf = torch.full(dirs.shape[:-1], float("inf"), dtype=F64, device=dev)
        t_best, rgb = inf.clone(), torch.zeros(dirs.shape, dtype=F64, device=dev)
        for s in range(self.SPHERES):
            oc = org - self.sph_c[s]
            a = (dirs * dirs).sum(-1)
            b = 2 * (oc * dirs).sum(-1)
            cc = (oc * oc).sum(-1) - self.sph_r[s] ** 2
            disc = b * b - 4 * a * cc
            t = (-b - torch.sqrt(torch.clamp(disc, min=0))) / (2 * a)
            hit = (disc > 0) & (t > 0) & (t < t_best)
            t_best = torch.where(hit, t, t_best)
            rgb = torch.where(hit[..., None], self.sph_rgb[s].expand_as(rgb), rgb)
        for axis, value, col in ((2, self.wall_z, self.plane_rgb[0]),
                                 (1, self.floor_y, self.plane_rgb[1])):
            t = (value - org[..., axis]) / dirs[..., axis]
            hit = (t > 0) & (t < t_best)
            t_best = torch.where(hit, t, t_best)
            rgb = torch.where(hit[..., None], col.expand_as(rgb), rgb)
        p = org + dirs * t_best[..., None]
        checker = ((torch.floor(p[..., 0] / 0.03) + torch.floor(p[..., 1] / 0.03)
                    + torch.floor(p[..., 2] / 0.03)) % 2)
        shade = torch.where(torch.isfinite(t_best), 0.7 + 0.3 * checker, 0.0)
        color = rgb * shade[..., None] + 2.0 * torch.randn(rgb.shape, generator=self.gen,
                                                           device=dev, dtype=F64)
        color = torch.clamp(torch.round(color), 0, 255).to(torch.uint8)
        z = t_best  # camera z, as the directions have unit camera z
        scale = float(self.cam["depth_scale"])
        drop = torch.rand(z.shape, generator=self.gen, device=dev, dtype=F64) < 0.005
        ok = torch.isfinite(z) & (z < self.cam["max_range_m"]) & ~drop
        z16 = torch.where(ok, torch.round(torch.where(ok, z, 0.0) * scale), 0.0)
        return z16.to(torch.int32), color, T
