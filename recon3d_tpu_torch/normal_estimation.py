"""NormalEstimation: PCA normals with consistent orientation (twin of
recon3d_tpu/normal_estimation.py; reference normal_estimation.py:3-23:
estimate_normals max_nn=50 radius=0.05, then
orient_normals_consistent_tangent_plane(100)). Runs where the cloud's
tensors lie.
"""
from __future__ import annotations

from recon3d_tpu_torch.config import ProcessingConfig
from recon3d_tpu_torch.pointcloud import normals as _n
from recon3d_tpu_torch.utils.types import PointCloud


class NormalEstimation:
    def __init__(self, config: ProcessingConfig = ProcessingConfig(),
                 consistent_k: int = 10, consistent_iterations: int = 100):
        self.config = config
        self.consistent_k = consistent_k
        self.consistent_iterations = consistent_iterations

    def estimate_normals(self, pc: PointCloud) -> PointCloud:
        c = self.config
        pc = _n.estimate_normals(pc, radius=c.normal_radius, max_nn=c.normal_max_nn)
        return _n.orient_normals_consistent(pc, k=self.consistent_k,
                                            iterations=self.consistent_iterations)


def estimate_normals(pc: PointCloud, radius: float = 0.05, max_nn: int = 50) -> PointCloud:
    """Functional form (reference: normal_estimation.py:12-23 defaults)."""
    pc = _n.estimate_normals(pc, radius=radius, max_nn=max_nn)
    return _n.orient_normals_consistent(pc, k=10, iterations=100)
