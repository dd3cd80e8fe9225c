"""Mesh filters and cleanup (twin of recon3d_tpu/mesh/ops.py).

The reference's Open3D post-processing chain: filter_smooth_laplacian x 5
(mesh_reconstruction.py:26, 41-50), the degenerate / duplicated /
unreferenced cleanup (mesh_reconstruction.py:29-37, mini1.py:361-367), the
NaN-vertex scrub (mini1.py:370-378) and the low-density vertex cull /
highlight (visualizer.py:41-57). Cleanup flips validity masks; capacities
never change.

Float sums over a vertex's edges or faces run as segmented sums over the
updates stably sorted by vertex, so each vertex adds its updates in the
order XLA's CPU scatter-add does, and the card's result does not depend on
the order of atomics. Products that XLA contracts are fused multiply-adds
(`ops/image.py:fma`), so the CPU port matches the jitted JAX functions and
the card matches the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from recon3d_tpu_torch.fusion.marching import _cross
from recon3d_tpu_torch.ops.image import fma
from recon3d_tpu_torch.utils.types import TriangleMesh


def _segment_sum(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) sums of `values` rows by `index`, each in row order."""
    order = torch.sort(index, stable=True).indices
    lengths = torch.bincount(index, minlength=n)
    return torch.segment_reduce(values[order], "sum", lengths=lengths, axis=0, unsafe=True)


def _norm3(a: torch.Tensor) -> torch.Tensor:
    """Row norms of (N, 3) float32 as XLA computes them: the squares summed
    as a fused multiply-add chain, then a correctly rounded square root
    (taken in float64, which PyTorch's CPU float32 sqrt is not always)."""
    s = fma(a[:, 2], a[:, 2], fma(a[:, 1], a[:, 1], a[:, 0] * a[:, 0]))
    return torch.sqrt(s.double()).to(torch.float32)


def filter_smooth_laplacian(mesh: TriangleMesh, iterations: int = 5,
                            lam: float = 0.5) -> TriangleMesh:
    """o3d filter_smooth_laplacian: v <- v + lam * (neighbor mean - v) over
    the valid triangles' edges, `iterations` times."""
    V = mesh.vertices.shape[0]
    t = mesh.triangles.long()
    # undirected edge list (each edge twice, both directions)
    e_src = torch.cat([t[:, 0], t[:, 1], t[:, 2], t[:, 1], t[:, 2], t[:, 0]])
    e_dst = torch.cat([t[:, 1], t[:, 2], t[:, 0], t[:, 0], t[:, 1], t[:, 2]])
    w = mesh.triangle_valid.repeat(6).to(torch.float32)
    order = torch.sort(e_src, stable=True).indices
    lengths = torch.bincount(e_src, minlength=V)
    src_w, src_dst = w[order], e_dst[order]
    deg = torch.segment_reduce(src_w, "sum", lengths=lengths, unsafe=True)
    den = torch.clamp(deg, min=1.0)[:, None]
    lam_t = torch.tensor(lam, dtype=torch.float32, device=mesh.vertices.device)
    verts = mesh.vertices
    for _ in range(iterations):
        nbr = torch.segment_reduce(verts[src_dst] * src_w[:, None], "sum", lengths=lengths,
                                   axis=0, unsafe=True)
        mean = nbr / den
        # verts + lam * (mean - verts), contracted by XLA
        step = fma(lam_t.expand_as(verts), mean - verts, verts)
        verts = torch.where((deg > 0)[:, None], step, verts)
    return dataclasses.replace(mesh, vertices=verts)


def remove_degenerate_triangles(mesh: TriangleMesh, area_eps: float = 0.0) -> TriangleMesh:
    """Drop triangles with repeated vertices or, with area_eps > 0, an area
    of at most area_eps (mesh_reconstruction.py:33, mini1.py:363)."""
    t = mesh.triangles
    distinct = (t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2]) & (t[:, 0] != t[:, 2])
    keep = mesh.triangle_valid & distinct
    if area_eps > 0:
        v = mesh.vertices
        tl = t.long()
        n = _cross(v[tl[:, 1]] - v[tl[:, 0]], v[tl[:, 2]] - v[tl[:, 0]])
        keep = keep & (0.5 * _norm3(n) > area_eps)
    return dataclasses.replace(mesh, triangle_valid=keep)


def remove_unreferenced_vertices(mesh: TriangleMesh) -> TriangleMesh:
    """Invalidate vertices no valid triangle uses (mesh_reconstruction.py:36)."""
    used = torch.zeros_like(mesh.vertex_valid)
    used[mesh.triangles[mesh.triangle_valid].reshape(-1).long()] = True
    return dataclasses.replace(mesh, vertex_valid=mesh.vertex_valid & used)


def remove_nan_vertices(mesh: TriangleMesh) -> TriangleMesh:
    """NaN / Inf vertex scrub and the triangles touching them (mini1.py:370-378)."""
    vv = mesh.vertex_valid & torch.isfinite(mesh.vertices).all(1)
    tv = mesh.triangle_valid
    t = mesh.triangles.long()
    for k in range(3):
        tv = tv & vv[t[:, k]]
    return dataclasses.replace(mesh, vertex_valid=vv, triangle_valid=tv)


def remove_duplicated_vertices(mesh: TriangleMesh, tol: float = 1e-6) -> TriangleMesh:
    """Weld coincident vertices (on the host: quantize + unique, as the JAX
    package) and remap the triangles (mini1.py:364)."""
    dev = mesh.vertices.device
    verts = mesh.vertices.cpu().numpy()
    vv = mesh.vertex_valid.cpu().numpy()
    q = np.round(verts / tol).astype(np.int64)
    q[~vv] = np.iinfo(np.int64).min  # invalid vertices never merge
    _, first_idx, inv = np.unique(q, axis=0, return_index=True, return_inverse=True)
    remap = first_idx[inv.reshape(-1)]  # every vertex -> its first occurrence
    tris = remap[mesh.triangles.cpu().numpy()].astype(np.int32)
    return dataclasses.replace(
        mesh, triangles=torch.as_tensor(tris, device=dev),
        vertex_valid=torch.as_tensor(vv & (remap == np.arange(len(verts))), device=dev))


def remove_duplicated_triangles(mesh: TriangleMesh) -> TriangleMesh:
    """Drop repeated faces whatever their winding (mini1.py:365; on the host)."""
    tris = np.sort(mesh.triangles.cpu().numpy(), axis=1)
    tv = mesh.triangle_valid.cpu().numpy()
    _, first_idx = np.unique(tris, axis=0, return_index=True)
    keep = np.zeros(len(tris), bool)
    keep[first_idx] = True
    return dataclasses.replace(mesh, triangle_valid=torch.as_tensor(
        tv & keep, device=mesh.triangle_valid.device))


def cleanup(mesh: TriangleMesh) -> TriangleMesh:
    """The reference's full cleanup chain (mini1.py:361-378)."""
    mesh = remove_nan_vertices(mesh)
    mesh = remove_duplicated_vertices(mesh)
    mesh = remove_duplicated_triangles(mesh)
    mesh = remove_degenerate_triangles(mesh)
    return remove_unreferenced_vertices(mesh)


def compute_vertex_normals(mesh: TriangleMesh) -> TriangleMesh:
    """Area-weighted vertex normals (o3d compute_vertex_normals): each
    vertex sums the face normals of its valid triangles, corner 0's faces
    first, then corner 1's and corner 2's, each in triangle order."""
    v = mesh.vertices
    t = mesh.triangles.long()
    fn = _cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    fn = fn * mesh.triangle_valid[:, None]
    acc = _segment_sum(fn.repeat(3, 1), t.T.reshape(-1), v.shape[0])
    n = acc / torch.clamp(_norm3(acc), min=1e-12)[:, None]
    return dataclasses.replace(mesh, vertex_normals=n)


def density_mask(densities, quantile: float = 0.01) -> torch.Tensor:
    """Vertices whose density lies below the `quantile` quantile (linear
    interpolation, as jnp.quantile), the visualizer.py:41-57 threshold."""
    d = torch.as_tensor(densities, dtype=torch.float32)
    s = torch.sort(d).values
    if bool(torch.isnan(d).any()):
        return torch.zeros_like(d, dtype=torch.bool)  # the threshold is NaN
    n = torch.tensor(float(d.numel()), dtype=torch.float32, device=d.device)
    q = torch.tensor(quantile, dtype=torch.float32, device=d.device) * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1 - hw
    lo = s[torch.clamp(low, 0, n - 1).long()]
    hi = s[torch.clamp(high, 0, n - 1).long()]
    return d < lo * lw + hi * hw


def highlight_sparse_regions(mesh: TriangleMesh, densities, quantile: float = 0.01,
                             color=(1.0, 0.0, 0.0)) -> TriangleMesh:
    """Paint low-density vertices `color` (visualizer.py:41-57)."""
    mask = density_mask(densities, quantile)
    base = mesh.vertex_colors
    if base is None:
        base = torch.full_like(mesh.vertices, 0.7)
    cols = torch.where(mask[:, None], torch.tensor(color, dtype=torch.float32,
                                                   device=base.device), base)
    return dataclasses.replace(mesh, vertex_colors=cols)
