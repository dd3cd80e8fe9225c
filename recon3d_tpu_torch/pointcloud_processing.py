"""PointCloudProcessing: downsample and remove outliers (twin of
recon3d_tpu/pointcloud_processing.py; reference pointcloud_processing.py:4-45:
voxel downsample at 0.0025, statistical outlier removal nb=30 / std=1.2,
radius removal 16 / 0.01), over a masked buffer on the cloud's device.
"""
from __future__ import annotations

from typing import Union

from recon3d_tpu_torch.config import ProcessingConfig
from recon3d_tpu_torch.pointcloud.outliers import (
    remove_radius_outliers,
    remove_statistical_outliers,
)
from recon3d_tpu_torch.pointcloud.voxel import voxel_downsample
from recon3d_tpu_torch.utils.io import read_point_cloud
from recon3d_tpu_torch.utils.types import PointCloud, compact


class PointCloudProcessing:
    """process_point_cloud(cloud or PLY path) -> cleaned PointCloud
    (reference: pointcloud_processing.py:15-45). Runs where the cloud's
    tensors lie."""

    def __init__(self, config: ProcessingConfig = ProcessingConfig()):
        self.config = config

    def process_point_cloud(self, source: Union[str, PointCloud], device="cuda") -> PointCloud:
        """Process a cloud, or the PLY file at path `source` read onto
        `device` (reference: pointcloud_processing.py:24)."""
        c = self.config
        if isinstance(source, str):
            source = read_point_cloud(source, device=device)
        pc = voxel_downsample(source, c.voxel_size)
        pc = compact(pc, min(pc.capacity, c.capacity))
        pc = remove_statistical_outliers(pc, nb_neighbors=c.outlier_nb_neighbors,
                                         std_ratio=c.outlier_std_ratio)
        return remove_radius_outliers(pc, nb_points=c.radius_nb_points, radius=c.radius)


# reference class name alias (pointcloud_processing.py:4)
PointCloudProcessingWithTPU = PointCloudProcessing
