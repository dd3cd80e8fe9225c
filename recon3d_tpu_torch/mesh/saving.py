"""Mesh persistence with density-based vertex coloring (twin of
recon3d_tpu/mesh/saving.py).

Replaces the reference's MeshSaving class (mesh_saving.py:5-21): writes the
mesh PLY, then a second PLY with the vertices colored by normalized Poisson
density through the plasma colormap (matplotlib's 'plasma' where matplotlib
is installed, else the JAX package's polynomial fit of it). Host-side: the
mesh and densities are read from their device once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.utils import io
from recon3d_tpu_torch.utils.types import TriangleMesh


def plasma_colormap(x: np.ndarray) -> np.ndarray:
    """x in [0, 1] -> RGB in [0, 1] (matplotlib 'plasma', with a fallback)."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    try:
        import matplotlib.cm as cm

        return np.asarray(cm.plasma(x))[..., :3]
    except ImportError:  # compact polynomial fit of plasma
        r = 0.05 + 2.2 * x - 1.3 * x ** 2
        g = -0.05 + 0.2 * x + 0.8 * x ** 2
        b = 0.53 + 1.3 * x - 2.0 * x ** 2 + 0.7 * x ** 3
        return np.clip(np.stack([r, g, b], -1), 0, 1)


def color_by_density(mesh: TriangleMesh, densities) -> TriangleMesh:
    """Normalized density -> plasma vertex colors (mesh_saving.py:16-19),
    on the mesh's device."""
    if torch.is_tensor(densities):
        densities = densities.cpu().numpy()
    d = np.asarray(densities, np.float64)
    lo, hi = d.min(), d.max()
    norm = (d - lo) / max(hi - lo, 1e-12)
    cols = plasma_colormap(norm).astype(np.float32)
    return dataclasses.replace(mesh, vertex_colors=torch.as_tensor(
        cols, device=mesh.vertices.device))


def save_mesh(
    mesh: TriangleMesh,
    densities=None,
    filename: str = "reconstructed_mesh.ply",
    colored_filename: Optional[str] = None,
) -> Tuple[str, Optional[str]]:
    """Write the mesh PLY and, given densities, its density-colored variant
    (MeshSaving.save_mesh, mesh_saving.py:6-21). Returns the paths written
    (the second None without densities)."""
    io.write_triangle_mesh(filename, mesh)
    colored = None
    if densities is not None:
        colored = colored_filename or filename.replace(".ply", "_colored.ply")
        io.write_triangle_mesh(colored, color_by_density(mesh, densities))
    return filename, colored
