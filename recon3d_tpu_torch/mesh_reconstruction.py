"""MeshReconstruction: Poisson + smoothing + cleanup (twin of
recon3d_tpu/mesh_reconstruction.py).

Mirrors the reference's mesh_reconstruction.py:5-70: Poisson reconstruction
at `depth` (default 6), Laplacian smoothing x 5, duplicate / degenerate
triangle and unreferenced vertex removal, vertex normals. Runs where the
cloud's tensors lie.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from recon3d_tpu_torch.config import MeshConfig
from recon3d_tpu_torch.mesh import ops as mops
from recon3d_tpu_torch.mesh.poisson import create_from_point_cloud_poisson
from recon3d_tpu_torch.utils.types import PointCloud, TriangleMesh


class MeshReconstruction:
    def __init__(self, config: MeshConfig = MeshConfig()):
        self.config = config

    def reconstruct_mesh(self, pc: PointCloud,
                         depth: Optional[int] = None) -> Tuple[TriangleMesh, torch.Tensor]:
        """(mesh, per-vertex densities), reference signature
        mesh_reconstruction.py:13-39."""
        depth = depth or self.config.poisson_depth
        mesh, densities = create_from_point_cloud_poisson(pc, depth=depth)
        mesh = mops.filter_smooth_laplacian(mesh, iterations=self.config.smoothing_iterations)
        mesh = mops.cleanup(mesh)
        mesh = mops.compute_vertex_normals(mesh)
        return mesh, densities


def reconstruct_mesh(pc: PointCloud, depth: int = 6):
    return MeshReconstruction().reconstruct_mesh(pc, depth=depth)
