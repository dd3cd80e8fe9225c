"""PointCloudAlignment: pairwise ICP alignment (twin of
recon3d_tpu/pointcloud_alignment.py).

Mirrors the reference's pointcloud_alignment.py:5-46: voxel downsample both
clouds, estimate target normals (point-to-plane), ICP (threshold 0.02, at
most 100 iterations, relative fitness / rmse 1e-6) from the identity, then
apply the transform to the full source.
"""
from __future__ import annotations

from typing import Tuple

import torch

from recon3d_tpu_torch.config import RegistrationConfig
from recon3d_tpu_torch.pointcloud.normals import estimate_normals
from recon3d_tpu_torch.pointcloud.voxel import voxel_downsample
from recon3d_tpu_torch.registration.icp import RegistrationResult, registration_icp
from recon3d_tpu_torch.utils.types import PointCloud, transform


class PointCloudAlignment:
    """align_point_clouds(source, target) -> (aligned_source, result)."""

    def __init__(self, config: RegistrationConfig = RegistrationConfig()):
        self.config = config

    def align_point_clouds(self, source: PointCloud,
                           target: PointCloud) -> Tuple[PointCloud, RegistrationResult]:
        c = self.config
        src = voxel_downsample(source, c.voxel_size)
        tgt = voxel_downsample(target, c.voxel_size)
        method = c.method if c.method in ("point_to_point", "point_to_plane") else "point_to_point"
        if method == "point_to_plane":
            tgt = estimate_normals(tgt, radius=2.0 * c.voxel_size, max_nn=30)
        init = torch.eye(4, dtype=torch.float32, device=source.points.device)  # ref line 31
        result = registration_icp(src, tgt, threshold=c.icp_threshold, init=init, method=method,
                                  max_iterations=c.icp_max_iterations,
                                  relative_fitness=c.icp_rel_fitness,
                                  relative_rmse=c.icp_rel_rmse)
        return transform(source, result.transformation), result
