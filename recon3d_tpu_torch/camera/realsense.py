"""Intel RealSense RGB-D driver, gated on pyrealsense2 (host-side copy of
recon3d_tpu/camera/realsense.py: numpy, no device code).

Rebuilds the reference's RealSense surface (realsense_pipeline.py:6-56,
test/check90.py:73-110, test/colorReco.py:56-102): stream config, aligned
frame grab in metric depth, post-processing filter chain
(decimation / spatial / temporal / hole-filling), and hardware reset
recovery. pyrealsense2 is imported in open(), so the package runs without
the camera's library.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from recon3d_tpu_torch.camera.base import Camera
from recon3d_tpu_torch.config import StreamConfig


class RealSenseCamera(Camera):
    def __init__(self, config: StreamConfig = StreamConfig(), use_filters: bool = True):
        self.config = config
        self.use_filters = use_filters
        self._pipeline = None
        self._align = None
        self._filters = []
        self.depth_scale = 1.0 / config.depth_scale
        self.intrinsics: Optional[dict] = None

    def open(self) -> None:
        import pyrealsense2 as rs  # deferred: not present off-hardware

        cfg = rs.config()
        c = self.config
        cfg.enable_stream(rs.stream.depth, c.width, c.height, rs.format.z16, c.fps)
        cfg.enable_stream(rs.stream.color, c.width, c.height, rs.format.rgb8, c.fps)
        self._pipeline = rs.pipeline()
        try:
            profile = self._pipeline.start(cfg)
        except RuntimeError:
            # hardware reset on failed start (reference: realsense_pipeline.py:25-31)
            ctx = rs.context()
            for dev in ctx.query_devices():
                dev.hardware_reset()
            time.sleep(2.0)
            profile = self._pipeline.start(cfg)
        sensor = profile.get_device().first_depth_sensor()
        self.depth_scale = sensor.get_depth_scale()
        vsp = profile.get_stream(rs.stream.color).as_video_stream_profile()
        i = vsp.get_intrinsics()
        self.intrinsics = dict(fx=i.fx, fy=i.fy, ppx=i.ppx, ppy=i.ppy,
                               width=i.width, height=i.height)
        self._align = rs.align(rs.stream.color) if c.align_depth_to_color else None
        if self.use_filters:
            # reference filter chain: check90.py:99-103, colorReco.py:94-102
            self._filters = [rs.decimation_filter(), rs.spatial_filter(),
                             rs.temporal_filter(), rs.hole_filling_filter()]

    def grab(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(color uint8 (H, W, 3) RGB, depth float32 (H, W) meters), or None
        when the frameset lacks either frame."""
        frames = self._pipeline.wait_for_frames(timeout_ms=1000)
        if self._align is not None:
            frames = self._align.process(frames)
        depth = frames.get_depth_frame()
        color = frames.get_color_frame()
        if not depth or not color:
            return None
        for f in self._filters:
            depth = f.process(depth)
        color_np = np.asanyarray(color.get_data())
        depth_np = np.asanyarray(depth.get_data()).astype(np.float32) * self.depth_scale
        return color_np, depth_np

    def close(self) -> None:
        if self._pipeline is not None:
            try:
                self._pipeline.stop()
            except Exception:  # a device already gone cannot be stopped; closing goes on
                pass
            self._pipeline = None
