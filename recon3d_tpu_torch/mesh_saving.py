"""MeshSaving: PLY export with density coloring (twin of
recon3d_tpu/mesh_saving.py; reference mesh_saving.py:5-21).
"""
from __future__ import annotations

from recon3d_tpu_torch.mesh.saving import color_by_density, plasma_colormap, save_mesh  # noqa: F401


class MeshSaving:
    def __init__(self, filename: str = "reconstructed_mesh.ply"):
        self.filename = filename

    def save_mesh(self, mesh, densities=None, filename: str = None):
        return save_mesh(mesh, densities=densities, filename=filename or self.filename)
