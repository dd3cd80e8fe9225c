"""Kernel path of the voxel-grid moments and normals (twin of
recon3d_tpu/ops/grid_knn_pallas.py).

- K7 (`pack_cells`, csrc/grid_pack.cu; `bin_points_packed_cuda` around
  it) places the cell-sorted points into the packed (G^3 * C, 4) table of
  ops/grid_knn.py, one thread a slot. The sort, the cell starts and the
  ranks stay in torch, as they stay in XLA in the JAX package. The TPU
  placed points with a DMA'd window and a one-hot matmul, and lost points
  when a block's run outgrew the window; a direct placement has no window,
  so the only overflow is the capacity overflow of `_sort_cells`, and the
  table is bitwise the plain version's.
- K8 (`core_call`, csrc/grid_moments.cu; `moments_core` / `normals_core`)
  accumulates, for every query slot, the 10 radius-ball moments over the
  occupied slots of the 27 neighboring cells and, with `fuse_eig`,
  normalizes them and solves the smallest eigenvector in the same thread,
  writing [nx, ny, nz, cnt]. A block owns a cube of cells (`k8_tile`),
  writes the empty slots' rows at once and stages the cube's halo only
  when it holds an occupied slot. It adds in the plain version's order
  with one rounding an operation (no contraction into fused multiply-adds),
  so it agrees with `grid_knn.core_plain` bitwise.
- `packed_chan_readback` gathers each point's row by its slot, in torch.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors; `.launches` counts the kernel launches.
"""
from __future__ import annotations

import torch

from recon3d_tpu_torch import kernels
from recon3d_tpu_torch.ops import grid_knn as gk


def pack_cells(sp: torch.Tensor, start: torch.Tensor, C: int) -> torch.Tensor:
    """K7: the (cells * C, 4) packed table of the cell-sorted points `sp`
    (N, 3) f32 with cell starts `start` (cells + 1,) int32, as
    grid_knn.pack_plain places it."""
    if sp.dtype != torch.float32 or sp.ndim != 2 or sp.shape[1] != 3 or \
            start.dtype != torch.int32 or start.ndim != 1:
        raise ValueError("pack_cells takes (N, 3) float32 points and (cells + 1,) int32 starts")
    sp, start = sp.contiguous(), start.contiguous()
    if not kernels.use_kernel(sp, start):
        return gk.pack_plain(sp, start, C)
    pk = torch.empty(((start.shape[0] - 1) * C, 4), dtype=torch.float32, device=sp.device)
    kernels.launch("r3d_grid_pack", sp.device, kernels.ptr(sp), kernels.ptr(start),
                   kernels.ptr(pk), start.shape[0] - 1, C)
    pack_cells.launches += 1
    return pk


pack_cells.launches = 0


def bin_points_packed_cuda(p: torch.Tensor, valid: torch.Tensor, radius, grid_size: int,
                           cell_capacity: int):
    """(pk (G^3 * C, 4), point_slot (N,) int32, overflow), the contract of
    grid_knn._bin_points_packed, with the placement on K7."""
    C = cell_capacity
    p = p.to(torch.float32)
    sc, sp, order, start, ok, rank, overflow = gk._sort_cells(p, valid, radius, grid_size, C)
    return (pack_cells(sp, start, C), gk._point_slot_from_sorted(sc, order, ok, rank, C),
            overflow)


# K8's shared memory a block may take (csrc/grid_moments.cu: kK8MaxSmem), the
# most it should take so that three blocks share an SM, and its hit lists (256
# threads x kHits 16-bit entries)
K8_MAX_SMEM, K8_SMEM_TARGET, K8_HIT_LISTS = 226 * 1024, 75 * 1024, 256 * 64 * 2


def k8_smem_bytes(tile, C: int) -> int:
    """Shared memory of a K8 block on tiles of `tile` = (tx, ty, tz) cells
    (csrc/grid_moments.cu:k8_smem_bytes): the staged halo, the halo counts,
    the query list and the hit lists."""
    tx, ty, tz = tile
    hc, tq = (tx + 2) * (ty + 2) * (tz + 2), tx * ty * tz * C
    S = C + 1 if C % 2 == 0 else C
    return hc * S * 16 + hc * 4 + tq * 4 + K8_HIT_LISTS


def k8_tile(G: int, C: int):
    """The cube of cells a K8 block owns: edge 4 (at C = 8 a row of 4 z-cells
    is 32 slots), smaller while a block would take more than
    K8_SMEM_TARGET, and edge 1 up to K8_MAX_SMEM; raises when not even one
    cell fits."""
    for t in (4, 3, 2, 1):
        tile = (min(t, G),) * 3
        if k8_smem_bytes(tile, C) <= (K8_SMEM_TARGET if t > 1 else K8_MAX_SMEM):
            return tile
    raise ValueError(f"K8 stages a cell's 27 neighbors in shared memory: C = {C} is too large")


def core_call(pk: torch.Tensor, r2: float, G: int, C: int, fuse_eig: bool) -> torch.Tensor:
    """K8 on the packed table: (G^3 * C, 10) moments, or with `fuse_eig`
    (G^3 * C, 4) [nx, ny, nz, cnt]; r2 is the squared radius (a runtime
    scalar, as the TPU kernel reads it from SMEM)."""
    if pk.shape != (G * G * G * C, 4) or pk.dtype != torch.float32:
        raise ValueError(f"packed table must be ({G ** 3 * C}, 4) float32, got "
                         f"{tuple(pk.shape)} {pk.dtype}")
    pk = pk.contiguous()
    if not kernels.use_kernel(pk):
        return gk.core_plain(pk, r2, G, C, fuse_eig)
    out = torch.empty((pk.shape[0], 4 if fuse_eig else 10), dtype=torch.float32,
                      device=pk.device)
    kernels.launch("r3d_grid_moments", pk.device, kernels.ptr(pk), kernels.ptr(out), G, C,
                   float(r2), int(fuse_eig), *k8_tile(G, C))
    core_call.launches += 1
    return out


core_call.launches = 0


def moments_core(pk: torch.Tensor, r2: float, G: int, C: int) -> torch.Tensor:
    """(G^3 * C, 10) slot rows [cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz]."""
    return core_call(pk, r2, G, C, fuse_eig=False)


def normals_core(pk: torch.Tensor, r2: float, G: int, C: int) -> torch.Tensor:
    """Fused moments + eigen-solve: (G^3 * C, 4) slot rows [nx, ny, nz, cnt]."""
    return core_call(pk, r2, G, C, fuse_eig=True)


def packed_chan_readback(out: torch.Tensor, point_slot: torch.Tensor):
    """Per-point rows of a kernel's slot-major output: returns chan(j) ->
    (N,) values of channel j for each point, and the has-slot mask."""
    has = point_slot >= 0
    rows = out[torch.clamp(point_slot, min=0).long()]

    def chan(j):
        return rows[:, j]

    return chan, has


def grid_pca_moments_cuda(points: torch.Tensor, valid: torch.Tensor, radius,
                          grid_size: int = 64, cell_capacity: int = 8):
    """Twin of grid_knn.grid_pca_moments on K7 + K8: (count (N,), mean
    (N, 3), cov6 (N, 6) [xx, yy, zz, xy, xz, yz]) in channel form."""
    G, C = grid_size, cell_capacity
    pk, point_slot, _ = bin_points_packed_cuda(points, valid, radius, G, C)
    r = torch.tensor(radius, dtype=torch.float32)
    out = moments_core(pk, float(r * r), G, C)
    chan, has = packed_chan_readback(out, point_slot)
    n = torch.where(has, chan(0), 0.0)
    nn = torch.clamp(n, min=1.0)
    mx, my, mz = (chan(1 + j) / nn for j in range(3))
    m2 = [chan(4 + j) / nn for j in range(6)]
    cov6 = torch.stack([m2[0] - mx * mx, m2[1] - my * my, m2[2] - mz * mz,
                        m2[3] - mx * my, m2[4] - mx * mz, m2[5] - my * mz], -1)
    return n, torch.stack([mx, my, mz], -1), cov6
