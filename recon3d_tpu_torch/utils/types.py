"""Geometry containers (twin of recon3d_tpu/utils/types.py, the subset that
backprojection uses).

Like the JAX package, a cloud is a fixed-capacity buffer plus a validity
mask: one point slot per pixel, no dynamic sizing on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Fixed-capacity point cloud with a validity mask.

    points: (N, 3) float32; colors: (N, 3) float32 in [0, 1] or None;
    normals: (N, 3) float32 or None; valid: (N,) bool.
    """

    points: torch.Tensor
    valid: torch.Tensor
    colors: Optional[torch.Tensor] = None
    normals: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics (fx, fy, cx, cy) as Python floats."""

    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def from_matrix(K) -> "CameraIntrinsics":
        K = torch.as_tensor(K, dtype=torch.float32).cpu()
        return CameraIntrinsics(fx=float(K[0, 0]), fy=float(K[1, 1]),
                                cx=float(K[0, 2]), cy=float(K[1, 2]))
