"""PointCloudCapture: frame grab -> downsampled colored cloud (twin of
recon3d_tpu/pointcloud_capture.py; reference pointcloud_capture.py:5-56:
backprojection + color attach + voxel downsample at 0.01). The host grabs
frames; backprojection and downsampling run on `device`, the card unless
the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from recon3d_tpu_torch.camera.base import Camera, ThreadedCamera
from recon3d_tpu_torch.pointcloud.backproject import pointcloud_from_rgbd
from recon3d_tpu_torch.pointcloud.voxel import voxel_downsample
from recon3d_tpu_torch.utils.types import CameraIntrinsics, PointCloud


class PointCloudCapture:
    """capture_point_cloud(camera) -> masked PointCloud
    (reference: pointcloud_capture.py:17-56, voxel 0.01 at :50)."""

    def __init__(self, intrinsics: CameraIntrinsics, voxel_size: float = 0.01,
                 depth_trunc: float = 3.0, flip: bool = False, device="cuda"):
        self.intrinsics = intrinsics
        self.voxel_size = voxel_size
        self.depth_trunc = depth_trunc
        self.flip = flip
        self.device = torch.device(device)

    def capture_point_cloud(self, camera) -> Optional[PointCloud]:
        """Accepts a Camera, a ThreadedCamera, or a (color, depth) tuple."""
        if isinstance(camera, ThreadedCamera):
            ok, frame = camera.read()
            if not ok:
                return None
        elif isinstance(camera, Camera):
            frame = camera.grab()
        else:
            frame = camera
        if frame is None:
            return None
        color, depth = frame
        pc = pointcloud_from_rgbd(torch.as_tensor(color, device=self.device),
                                  torch.as_tensor(depth, device=self.device), self.intrinsics,
                                  depth_trunc=self.depth_trunc, flip=self.flip)
        return voxel_downsample(pc, self.voxel_size)
