"""Depth / disparity -> point cloud backprojection (twin of
recon3d_tpu/pointcloud/backproject.py: `backproject_depth`,
`backproject_disparity`, `pointcloud_from_rgbd`).

All produce a fixed-capacity masked PointCloud, one point slot per pixel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from recon3d_tpu_torch.depth.matcher import reproject_image_to_3d
from recon3d_tpu_torch.utils.types import CameraIntrinsics, PointCloud, transform

# Open3D's RGBD pipeline flips to this camera convention before visualizing
# (test/mini1.py:170 flip transform [[1,0,0,0],[0,-1,0,0],[0,0,-1,0],[0,0,0,1]])
FLIP_TRANSFORM = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
], np.float32)


def _colors(color: Optional[torch.Tensor], stride: int = 1) -> Optional[torch.Tensor]:
    if color is None:
        return None
    c = color
    if c.dtype == torch.uint8:
        c = c.to(torch.float32) / 255.0
    return c[::stride, ::stride].reshape(-1, 3)


def backproject_depth(depth: torch.Tensor, intr: CameraIntrinsics,
                      color: Optional[torch.Tensor] = None, depth_trunc: float = 3.0,
                      depth_min: float = 1e-3, stride: int = 1) -> PointCloud:
    """Pinhole backprojection: (H, W) metric depth -> PointCloud of H*W
    points; color (H, W, 3) float [0, 1] or uint8; stride subsamples."""
    d = depth.to(torch.float32)[::stride, ::stride]
    H, W = d.shape
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=d.device) * stride,
                          torch.arange(W, dtype=torch.float32, device=d.device) * stride,
                          indexing="ij")
    x = (u - intr.cx) / intr.fx * d
    y = (v - intr.cy) / intr.fy * d
    pts = torch.stack([x, y, d], -1).reshape(-1, 3)
    valid = ((d > depth_min) & (d < depth_trunc) & torch.isfinite(d)).reshape(-1)
    return PointCloud(points=pts, valid=valid, colors=_colors(color, stride))


def backproject_disparity(disparity: torch.Tensor, Q: torch.Tensor,
                          color: Optional[torch.Tensor] = None, z_min: float = 1e-3,
                          z_max: float = 20.0, assume_standard_q: bool = False) -> PointCloud:
    """Q-matrix backprojection (cv2.reprojectImageTo3D) -> masked PointCloud.

    assume_standard_q: the caller guarantees stereoRectify's sparse Q
    (nonzeros only at [0,0] = [1,1] = 1, [0,3], [1,3], [2,3], [3,2], [3,3]),
    so six elementwise ops replace the per-pixel 4x4 transform.
    """
    Q = Q.to(torch.float32)
    d = disparity.to(torch.float32)
    if assume_standard_q:
        H, W = d.shape
        y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=d.device),
                              torch.arange(W, dtype=torch.float32, device=d.device),
                              indexing="ij")
        w = Q[3, 2] * d + Q[3, 3]
        w = torch.where(w.abs() < 1e-12, 1e-12, w)
        inv = 1.0 / w
        pts = torch.stack([(x + Q[0, 3]) * inv, (y + Q[1, 3]) * inv, Q[2, 3] * inv],
                          -1).reshape(-1, 3)
    else:
        pts = reproject_image_to_3d(d, Q).reshape(-1, 3)
    z = pts[:, 2]
    valid = (d.reshape(-1) > 0) & (z > z_min) & (z < z_max)
    valid = valid & torch.isfinite(pts).all(dim=1)
    return PointCloud(points=pts, valid=valid, colors=_colors(color))


def pointcloud_from_rgbd(color: torch.Tensor, depth: torch.Tensor, intr: CameraIntrinsics,
                         depth_trunc: float = 3.0, flip: bool = True) -> PointCloud:
    """RGBD frame -> colored cloud with Open3D's flip convention
    (mini1.py:165-171); runs on the tensors' device."""
    pc = backproject_depth(depth, intr, color=color, depth_trunc=depth_trunc)
    return transform(pc, FLIP_TRANSFORM) if flip else pc
