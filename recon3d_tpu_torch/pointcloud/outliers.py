"""Statistical and radius outlier removal (twin of
recon3d_tpu/pointcloud/outliers.py: `remove_statistical_outliers`,
`remove_radius_outliers`).

Masked reductions over the blocked k-NN / range search of ops/knn.py:
shapes stay fixed and "removal" clears mask bits (`compact` repacks).
"""
from __future__ import annotations

import dataclasses

import torch

from recon3d_tpu_torch.ops import knn as _knn
from recon3d_tpu_torch.utils.types import PointCloud


def remove_statistical_outliers(pc: PointCloud, nb_neighbors: int = 30,
                                std_ratio: float = 1.2) -> PointCloud:
    """Open3D remove_statistical_outlier(nb_neighbors, std_ratio)
    (pointcloud_processing.py:36): drop points whose mean k-NN distance
    exceeds mean + std_ratio * std of that statistic over the cloud."""
    _, d2 = _knn.knn(pc.points, pc.valid, k=nb_neighbors)
    mean_d = torch.sqrt(torch.clamp(d2, min=0.0)).mean(dim=1)  # (N,)
    v = pc.valid
    n = torch.clamp(v.sum(), min=1).to(torch.float32)
    mu = torch.where(v, mean_d, 0.0).sum() / n
    var = torch.where(v, (mean_d - mu) ** 2, 0.0).sum() / torch.clamp(n - 1, min=1)
    thresh = mu + torch.tensor(std_ratio, dtype=torch.float32) * torch.sqrt(var)
    return dataclasses.replace(pc, valid=v & (mean_d <= thresh))


def remove_radius_outliers(pc: PointCloud, nb_points: int = 16,
                           radius: float = 0.01) -> PointCloud:
    """Open3D remove_radius_outlier(nb_points, radius)
    (pointcloud_processing.py:40): keep points with at least nb_points
    neighbors inside radius."""
    counts = _knn.radius_count(pc.points, pc.valid, radius)
    return dataclasses.replace(pc, valid=pc.valid & (counts >= nb_points))
