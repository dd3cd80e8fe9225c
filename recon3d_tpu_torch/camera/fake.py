"""Synthetic cameras (numpy copy of recon3d_tpu/camera/fake.py:
`_render_sphere_plane`, `SyntheticRGBDCamera`, `FakeStereoCamera.render`).

The scene is an analytic sphere over a textured plane, so the depth path has
a ground-truth disparity d = f * b / z and the point-cloud path known
surfaces (the plane z = 1.8, the sphere at (0, 0, 1.2), r = 0.3). Pure
numpy: the copy exists so the port builds its scenes without importing the
JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from recon3d_tpu_torch.camera.base import Camera


def _render_sphere_plane(fx, fy, cx, cy, h, w, pose):
    """Ray-traced depth + color of a sphere at (0, 0, 1.2), r = 0.3, over the
    plane z = 1.8, seen from `pose` (4x4 camera-from-world)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    dirs = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
    Rwc = pose[:3, :3].T  # world-from-camera rotation
    origin = -Rwc @ pose[:3, 3]
    d_world = dirs @ Rwc.T
    d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)

    c0 = np.array([0.0, 0.0, 1.2])
    r = 0.3
    oc = origin - c0
    b = d_world @ oc
    disc = b * b - (oc @ oc - r * r)
    hit_s = disc > 0
    t_s = np.where(hit_s, -b - np.sqrt(np.maximum(disc, 0.0)), np.inf)
    t_s = np.where(t_s > 1e-6, t_s, np.inf)

    dz = d_world[..., 2]
    t_p = np.where(np.abs(dz) > 1e-9, (1.8 - origin[2]) / dz, np.inf)
    t_p = np.where(t_p > 1e-6, t_p, np.inf)

    t = np.minimum(t_s, t_p)
    pts = origin + t[..., None] * d_world
    cam = pts @ pose[:3, :3].T + pose[:3, 3]
    depth = np.where(np.isfinite(t), cam[..., 2], 0.0)

    sphere_closer = t_s < t_p
    n = (pts - c0) / r
    shade = np.clip(0.3 + 0.7 * np.clip(n[..., 2] * -1, 0, 1), 0, 1)
    checker = ((np.floor(pts[..., 0] * 8) + np.floor(pts[..., 1] * 8)) % 2)
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    tex = (
        0.30 * np.sin(41.0 * px + 13.0 * py)
        + 0.25 * np.sin(29.0 * py - 17.0 * pz + 1.3)
        + 0.20 * np.sin(53.0 * (px + py + pz) + 0.7)
        + 0.15 * np.sin(97.0 * px - 71.0 * py + 2.1)
    )
    tex = 0.75 + 0.25 * tex
    color = np.zeros((h, w, 3))
    color[..., 0] = np.where(sphere_closer, shade, 0.2 + 0.6 * checker) * tex
    color[..., 1] = np.where(sphere_closer, 0.3 * shade, 0.2 + 0.6 * checker) * tex
    color[..., 2] = np.where(sphere_closer, 0.2, 0.4 + 0.4 * checker) * tex
    color = np.where(np.isfinite(t)[..., None], np.clip(color, 0, 1), 0.0)
    return (color * 255).astype(np.uint8), depth.astype(np.float32)


class SyntheticRGBDCamera(Camera):
    """Procedural RGBD stream with a known camera trajectory: `grab()`
    renders frame k (uint8 color, float32 metric depth) from `true_pose(k)`,
    the camera-from-world transform of a slight orbit around the scene."""

    def __init__(self, width=640, height=480, fx=525.0, fy=525.0,
                 cx: Optional[float] = None, cy: Optional[float] = None,
                 n_frames: int = 10, step: float = 0.01):
        self.w, self.h = width, height
        self.fx, self.fy = fx, fy
        self.cx = cx if cx is not None else width / 2 - 0.5
        self.cy = cy if cy is not None else height / 2 - 0.5
        self.n_frames = n_frames
        self.step = step
        self._i = 0

    def open(self) -> None:
        self._i = 0

    def true_pose(self, k: int) -> np.ndarray:
        """Camera-from-world pose of frame k: small translation + yaw."""
        ang = 0.01 * k
        c, s = np.cos(ang), np.sin(ang)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T[0, 3] = self.step * k
        T[1, 3] = 0.25 * self.step * k
        return T

    def grab(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self._i >= self.n_frames:
            return None
        pose = self.true_pose(self._i)
        self._i += 1
        return _render_sphere_plane(self.fx, self.fy, self.cx, self.cy, self.h, self.w, pose)


class FakeStereoCamera:
    """Synthetic rectified stereo pair generator: `render(k)` gives a
    (left, right) uint8 gray pair, the left-view ground-truth disparity and
    the left depth."""

    def __init__(self, width=640, height=480, focal=525.0, baseline=0.06, n_frames=4):
        self.w, self.h = width, height
        self.f = focal
        self.b = baseline
        self.n_frames = n_frames

    def render(self, k: int):
        cx, cy = self.w / 2 - 0.5, self.h / 2 - 0.5
        poseL = np.eye(4)
        poseL[0, 3] = 0.002 * k
        poseR = poseL.copy()
        poseR[0, 3] += -self.b  # right camera sits +b in world x
        colL, depL = _render_sphere_plane(self.f, self.f, cx, cy, self.h, self.w, poseL)
        colR, _ = _render_sphere_plane(self.f, self.f, cx, cy, self.h, self.w, poseR)
        grayL = colL.astype(np.float32).mean(-1).astype(np.uint8)
        grayR = colR.astype(np.float32).mean(-1).astype(np.uint8)
        disp = np.where(depL > 0, self.f * self.b / np.maximum(depL, 1e-6), 0.0)
        return grayL, grayR, disp.astype(np.float32), depL
