"""Replay and synthetic cameras (host-side copy of
recon3d_tpu/camera/fake.py: numpy and threads, no device code).

  FakeRGBDCamera      replays a directory of color_*.png / depth_*.png
                      pairs (a scan's checkpoints) through the native PNG
                      codec of utils/native.py;
  SyntheticRGBDCamera renders an analytic scene (sphere over a textured
                      plane) from a moving camera with known poses;
  FakeStereoCamera    renders rectified left / right views of the same
                      scene with a ground-truth disparity d = f * b / z.

The scene's surfaces are known (the plane z = 1.8, the sphere at
(0, 0, 1.2), r = 0.3). The cameras yield numpy frames; the pipelines move
them to the device.
"""
from __future__ import annotations

import glob
import os
import re
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from recon3d_tpu_torch.camera.base import Camera


class FakeRGBDCamera(Camera):
    """Replay color / depth PNG pairs from a directory (mini1.py:188-212).

    A color frame without its depth file is skipped. With prefetch=True (the
    default) a background thread decodes the directory ahead of the consumer
    through the native thread-pool loader, so grab() does not pay a serial
    PNG decode; the decoded frames stay cached, so a looped replay
    (loop=True) serves from memory. A decode error is raised to the caller
    of grab() / wait_prefetched().
    """

    def __init__(self, directory: str, depth_scale: float = 1000.0,
                 loop: bool = False, prefetch: bool = True):
        self.directory = directory
        self.depth_scale = depth_scale
        self.loop = loop
        self.prefetch = prefetch
        self._pairs: List[Tuple[str, str]] = []
        self._i = 0
        self._cache: Optional[List] = None
        self._cv = threading.Condition()
        self._decode_error: Optional[BaseException] = None

    def open(self) -> None:
        colors = sorted(glob.glob(os.path.join(self.directory, "color_*.png")))
        self._pairs = []
        for c in colors:
            m = re.search(r"color_(\d+)\.png$", c)
            d = os.path.join(self.directory, f"depth_{m.group(1)}.png")
            if os.path.exists(d):
                self._pairs.append((c, d))
        if not self._pairs:
            raise FileNotFoundError(f"no color/depth pairs in {self.directory}")
        self._i = 0
        if self.prefetch and self._cache is None:
            self._cache = [None] * len(self._pairs)
            threading.Thread(target=self._decode_ahead, daemon=True).start()

    def wait_prefetched(self, timeout: float = 300.0) -> bool:
        """Block until the background decoder has cached every frame; False
        after `timeout` seconds. A decode error is raised here."""
        if self._cache is None:
            return True
        deadline = time.monotonic() + timeout
        with self._cv:
            while any(f is None for f in self._cache):
                if self._decode_error is not None:
                    raise self._decode_error
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 5.0))
        return True

    def _decode_ahead(self, chunk: int = 16) -> None:
        """Fill the frame cache: frame 0 alone, then chunks through the
        native batch loader. The cache holds the sensor's types (color u8,
        depth u16 raw units); grab() converts the depth to float32 meters."""
        from recon3d_tpu_torch.utils import io, native

        try:
            c0 = io.read_color(self._pairs[0][0])
            d0 = io.read_depth_raw(self._pairs[0][1])
            with self._cv:
                self._cache[0] = (c0, d0)
                self._cv.notify_all()
            h, w = c0.shape[:2]
            n = len(self._pairs)
            for s in range(1, n, chunk):
                sub = self._pairs[s:s + chunk]
                colors, depths = native.load_rgbd_batch([p[0] for p in sub],
                                                        [p[1] for p in sub], w, h)
                with self._cv:
                    for k in range(len(sub)):
                        self._cache[s + k] = (colors[k], depths[k])
                    self._cv.notify_all()
        except BaseException as e:  # surface decode failures to grab()
            with self._cv:
                self._decode_error = e
                self._cv.notify_all()

    def __len__(self) -> int:
        return len(self._pairs)

    def grab_raw(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(color u8, depth u16 raw units): the sensor's wire format, which
        the streaming producer ships to the device (the step divides by
        depth_scale there)."""
        from recon3d_tpu_torch.utils import io

        if self._i >= len(self._pairs):
            if not self.loop:
                return None
            self._i = 0
        idx = self._i
        self._i += 1
        if self._cache is not None:
            with self._cv:
                while self._cache[idx] is None and self._decode_error is None:
                    self._cv.wait(timeout=30.0)
                if self._cache[idx] is not None:
                    return self._cache[idx]
                raise self._decode_error
        c, d = self._pairs[idx]
        return io.read_color(c), io.read_depth_raw(d)

    def grab(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        raw = self.grab_raw()
        if raw is None:
            return None
        c, d = raw
        return c, d.astype(np.float32) / self.depth_scale


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


class FakeStereoCamera(Camera):
    """Synthetic rectified stereo pair generator: `render(k)` gives a
    (left, right) uint8 gray pair, the left-view ground-truth disparity and
    the left depth; `grab()` yields render(k)'s pair for k < n_frames, then
    None."""

    def __init__(self, width=640, height=480, focal=525.0, baseline=0.06, n_frames=4):
        self.w, self.h = width, height
        self.f = focal
        self.b = baseline
        self.n_frames = n_frames
        self._i = 0

    def open(self) -> None:
        self._i = 0

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

    def grab(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if self._i >= self.n_frames:
            return None
        gl, gr, _, _ = self.render(self._i)
        self._i += 1
        return gl, gr
