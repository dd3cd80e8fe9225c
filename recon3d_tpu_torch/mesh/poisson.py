"""Poisson surface reconstruction on a dense grid, solved spectrally (twin
of recon3d_tpu/mesh/poisson.py).

Replaces o3d create_from_point_cloud_poisson (mesh_reconstruction.py:22,
depth 6; mini1.py uses depth 8). Kazhdan's Poisson problem
  min_chi ||grad(chi) - V||^2  =>  lap(chi) = div(V)
is solved on a dense 2^depth grid instead of an octree:

  1. splat the oriented normals into a vector field V (trilinear weights),
  2. Gaussian-smooth V (the octree formulation's B-spline kernel),
  3. solve in Fourier space, chi_hat = div_hat / -|k|^2 (one 3-D FFT each
     way, `torch.fft` in complex64 as the JAX package's `jnp.fft`),
  4. take the iso level as the density-weighted mean of chi at the samples,
  5. extract the zero crossing with the marching-tetrahedra machinery
     (fusion/marching.py); per-vertex densities (the splat's mass) mirror
     Open3D's, for coloring and low-density culling.

The splat sums each cell's contributions in a fixed order, corner by corner
and within a corner in point order (XLA's CPU scatter-add order): the
contributions are sorted by cell and summed a segment at a time, so the
card gives the same sums on every run and the host's.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from recon3d_tpu_torch.fusion.marching import (_orient_by_gradient, extract_triangle_soup,
                                               weld_mesh)
from recon3d_tpu_torch.fusion.tsdf import TSDFVolume
from recon3d_tpu_torch.utils.types import PointCloud, TriangleMesh


def _splat_trilinear(grid: torch.Tensor, pts_grid: torch.Tensor, values: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """grid (R, R, R[, C]) plus values (N[, C]) splatted at the fractional
    grid coordinates pts_grid (N, 3) with trilinear weights; rows where
    `valid` is False add zeros."""
    R = grid.shape[0]
    g0 = torch.floor(pts_grid).to(torch.int32)
    f = pts_grid - g0
    w_ = valid.to(torch.float32)
    vals = values if values.ndim == 2 else values[:, None]
    cells, parts = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2])) * w_
                off = torch.tensor([dx, dy, dz], dtype=torch.int32, device=g0.device)
                idx = torch.clamp(g0 + off, 0, R - 1).long()
                cells.append((idx[:, 0] * R + idx[:, 1]) * R + idx[:, 2])
                parts.append(vals * w[:, None])
    cell = torch.cat(cells)
    # each cell's contributions in (corner, point) order, summed in that order
    order = torch.sort(cell, stable=True).indices
    lengths = torch.bincount(cell, minlength=R ** 3)
    sums = torch.segment_reduce(torch.cat(parts)[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)
    return grid + sums.reshape(grid.shape)


def _gaussian3d(grid: torch.Tensor, sigma) -> torch.Tensor:
    """Separable Gaussian blur of a (R, R, R[, C]) grid through the FFT."""
    R = grid.shape[0]
    k = torch.fft.fftfreq(R, device=grid.device) * R  # integer frequencies
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=grid.device)
    g1 = torch.exp(-2.0 * (math.pi * sigma * k / R) ** 2)
    G = g1[:, None, None] * g1[None, :, None] * g1[None, None, :]

    def blur(a):
        return torch.fft.ifftn(torch.fft.fftn(a) * G).real

    if grid.ndim == 4:
        return torch.stack([blur(grid[..., c]) for c in range(grid.shape[-1])], -1)
    return blur(grid)


def _poisson_indicator(points: torch.Tensor, normals: torch.Tensor, valid: torch.Tensor,
                       resolution: int, origin: torch.Tensor, scale: torch.Tensor,
                       smooth_sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve lap(chi) = div(V) spectrally on a resolution^3 grid; returns
    (chi less its iso level, the smoothed density grid)."""
    R = resolution
    dev = points.device
    pts_grid = (points - origin) / scale  # in [0, R)
    inb = valid & torch.all((pts_grid >= 1.0) & (pts_grid <= R - 2.0), dim=1)

    V = _splat_trilinear(torch.zeros((R, R, R, 3), device=dev), pts_grid, normals, inb)
    dens = _splat_trilinear(torch.zeros((R, R, R), device=dev), pts_grid,
                            torch.ones((points.shape[0],), device=dev), inb)
    V = _gaussian3d(V, smooth_sigma)
    dens_s = _gaussian3d(dens, smooth_sigma)

    # the spectral derivative i 2 pi k a frequency (cycles per sample)
    b = torch.fft.fftfreq(R, device=dev) * torch.tensor(2.0 * math.pi, dtype=torch.float32,
                                                         device=dev)
    bx, by, bz = b[:, None, None], b[None, :, None], b[None, None, :]
    Fx, Fy, Fz = (torch.fft.fftn(V[..., i]) for i in range(3))
    # div_hat = i (bx Fx + by Fy + bz Fz); -|k|^2 = -(bx^2 + by^2 + bz^2)
    div_re = -((bx * Fx.imag + by * Fy.imag) + bz * Fz.imag)
    div_im = (bx * Fx.real + by * Fy.real) + bz * Fz.real
    k2 = (-(bx * bx) + -(by * by)) + -(bz * bz)
    k2 = torch.where(torch.abs(k2) < 1e-12, 1.0, k2)
    chi_hat = torch.complex(div_re / k2, div_im / k2)
    chi_hat[0, 0, 0] = 0.0
    chi = torch.fft.ifftn(chi_hat).real

    # iso level: the density-weighted mean of chi at the sample locations
    g0 = torch.clamp(torch.round(pts_grid).to(torch.int32), 0, R - 1).long()
    chi_at = chi[g0[:, 0], g0[:, 1], g0[:, 2]]
    w = inb.to(torch.float32)
    iso = torch.sum(chi_at * w) / torch.clamp(torch.sum(w), min=1.0)
    return chi - iso, dens_s


def grid_placement(pts: np.ndarray, resolution: int, margin: float = 0.1, device="cuda"):
    """(origin (3,), cell size ()) float32 tensors on `device` of the cube
    grid that holds the points `pts` (N, 3) with `margin` of the span on
    each side."""
    lo = pts.min(0)
    hi = pts.max(0)
    span = float((hi - lo).max()) * (1.0 + 2.0 * margin)
    return (torch.as_tensor(np.asarray(lo - margin * span, np.float32), device=device),
            torch.tensor(np.float32(span / resolution), device=device))


def create_from_point_cloud_poisson(
    pc: PointCloud,
    depth: int = 6,
    smooth_sigma: float = 1.5,
    max_triangles: int = 1 << 19,
    margin: float = 0.1,
) -> Tuple[TriangleMesh, torch.Tensor]:
    """Poisson reconstruction, (cloud with normals, depth) -> (mesh,
    per-vertex densities) (mesh_reconstruction.py:22's signature), on the
    cloud's device. The densities feed the plasma coloring of mesh saving
    and low-density culling."""
    if pc.normals is None:
        raise ValueError("Poisson reconstruction requires normals "
                         "(run normal estimation first)")
    R = 1 << depth
    pts, _, _ = pc.to_numpy()
    if len(pts) == 0:
        raise ValueError(
            "Poisson reconstruction got an empty point cloud — every "
            "point was invalid or culled upstream (check outlier/"
            "downsample settings vs the scan size)")
    dev = pc.points.device
    origin, scale = grid_placement(pts, R, margin, dev)
    chi, dens = _poisson_indicator(pc.points, pc.normals, pc.valid, R, origin, scale,
                                   smooth_sigma)
    # mesh the indicator's zero crossing, only where the samples reach
    vol = TSDFVolume(tsdf=chi, weight=(dens > 1e-4).to(torch.float32), origin=origin,
                     voxel_size=scale, sdf_trunc=torch.ones((), device=dev), color=None)
    soup, valid, _ = extract_triangle_soup(vol, max_triangles=max_triangles)
    soup = _orient_by_gradient(vol, soup)
    mesh = weld_mesh(soup, valid, float(scale))
    g = torch.clamp((mesh.vertices - origin) / scale, 0, R - 1)
    gi = torch.round(g).to(torch.int32).long()
    return mesh, dens[gi[:, 0], gi[:, 1], gi[:, 2]]
