"""Voxel-grid binning for large-N neighborhoods: the plain versions (twin of
recon3d_tpu/ops/grid_knn.py: `_sort_cells`, `_point_slot_from_sorted`,
`_bin_points_packed`, `grid_pca_moments`, `grid_knn`,
`grid_nearest_neighbor`).

Points are binned into a dense (G^3, C) cell table with cell edge = radius,
so a radius ball around any point lies inside its 27 neighboring cells.
Results are exact for every neighbor within `radius` unless a point
overflowed its cell's capacity C; `overflow` reports the share dropped.

Layout. A cell (x, y, z) has id (x * G + y) * G + z and slots
id * C + c, c = 0..C-1; the packed table `pk` is slot-major (G^3 * C, 4)
float32 rows [x, y, z, occupancy], so one slot is one 16-byte load. The
JAX package strides z by a TPU lane width gz >= G (ids with z >= G never
occupied); with gz = G the sort order, ranks and overflow are the same.
Its (G, 4C, G * gz) layout maps onto this one by
`pk_jax.reshape(G, 4, C, G, gz)[..., :G].permute(0, 3, 4, 2, 1)`.

The neighbor searches (`grid_knn`, `grid_nearest_neighbor`) read the
table through the sorted points: slot (cell, c) is sorted position
start[cell] + c while that lies inside the cell's run, so no table is
scattered and no scatter ever meets duplicate indices. Each kept query
gathers the C slots of its 27 neighboring cells in `_neighbor_offsets`
order; a neighbor cell off the grid is masked with BIG, as the JAX
package's rolled table masks the cells that wrapped around. The first
minimum over (offset, slot) is the candidate the JAX package's strict
running minimum over the offsets keeps.

The hand-written kernels that replace `_bin_points_packed`'s placement
(K7) and the moments / normals core (K8) live in ops/grid_knn_cuda.py.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from recon3d_tpu_torch.ops.image import fma
from recon3d_tpu_torch.ops.knn import smallest_k

BIG = 1e30


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class GridKNNResult(NamedTuple):
    indices: torch.Tensor  # (N, k) int32 into the original point order
    sq_dists: torch.Tensor  # (N, k) float32, BIG where no neighbor
    overflow_fraction: torch.Tensor  # 0-d float32: points dropped from cells


def _sort_cells(p: torch.Tensor, valid: torch.Tensor, radius, G: int, C: int, lo=None):
    """Points sorted by cell id (stable: within a cell, original order),
    the per-cell start offsets and the per-sorted-point rank.

    Returns (sc, sp, order, start, ok, rank, overflow): sorted cell ids
    (G^3 = out of grid or invalid), sorted points, the sorting permutation,
    start[c] = first sorted position with cell id >= c (G^3 + 1 entries),
    ok = the point got a slot (rank < C, in grid), rank within the cell and
    the share of in-grid points that got no slot. `lo` (3,): the grid's
    origin, by default the valid points' min corner less half a cell."""
    N = p.shape[0]
    dev = p.device
    n_cells = G * G * G
    r = _f32(radius, dev)
    if lo is None:
        lo = torch.where(valid[:, None], p, BIG).min(dim=0).values - 0.5 * r
    cell = torch.floor((p - lo) / r).to(torch.int32)  # a true divide, as the JAX package
    inb = ((cell >= 0) & (cell < G)).all(dim=1) & valid
    cell = torch.clamp(cell, 0, G - 1)
    cid = (cell[:, 0] * G + cell[:, 1]) * G + cell[:, 2]
    cid = torch.where(inb, cid, n_cells)  # out-of-grid / invalid -> trash cell

    sc, order = torch.sort(cid, stable=True)  # lax.sort is stable
    sp = p[order]
    start = torch.searchsorted(sc, torch.arange(n_cells + 1, dtype=torch.int32, device=dev),
                               out_int32=True)
    iota = torch.arange(N, dtype=torch.int32, device=dev)
    rank = iota - start[sc]
    ok = (rank < C) & (sc < n_cells)
    n_valid = torch.clamp(inb.sum().to(torch.float32), min=1.0)
    overflow = 1.0 - ok.sum().to(torch.float32) / n_valid
    return sc, sp, order, start, ok, rank, overflow


def _point_slot_from_sorted(sc, order, ok, rank, C: int) -> torch.Tensor:
    """Per-original-point slot id (or -1 if dropped): the sorted slots put
    back through the inverse permutation."""
    slot_of_sorted = torch.where(ok, sc * C + rank, -1).to(torch.int32)
    point_slot = torch.empty_like(slot_of_sorted)
    point_slot[order] = slot_of_sorted
    return point_slot


def pack_plain(sp: torch.Tensor, start: torch.Tensor, C: int) -> torch.Tensor:
    """Plain version of K7's placement: slot (cell, c) holds the sorted point
    at start[cell] + c while that position is inside the cell's run, else
    zeros; returns the (cells * C, 4) packed table."""
    N = sp.shape[0]
    n_cells = start.shape[0] - 1
    slot = torch.arange(n_cells * C, dtype=torch.int32, device=sp.device)
    cell, c = slot // C, slot % C
    pos = start[cell] + c
    occ = pos < start[cell + 1]
    pos = torch.clamp(pos, max=max(N - 1, 0))
    rows = torch.where(occ[:, None], sp[pos], 0.0)
    return torch.cat([rows, occ.to(torch.float32)[:, None]], 1)


def _bin_points_packed(p: torch.Tensor, valid: torch.Tensor, radius, grid_size: int,
                       cell_capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K7: (pk (G^3 * C, 4), point_slot (N,) int32,
    overflow) with the layout of the module docstring."""
    C = cell_capacity
    p = p.to(torch.float32)
    sc, sp, order, start, ok, rank, overflow = _sort_cells(p, valid, radius, grid_size, C)
    pk = pack_plain(sp, start, C)
    return pk, _point_slot_from_sorted(sc, order, ok, rank, C), overflow


def _neighbor_offsets():
    return [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


MOMENT_CHANNELS = ("cnt", "sx", "sy", "sz", "sxx", "syy", "szz", "sxy", "sxz", "syz")


def moments_plain(pk: torch.Tensor, r2, G: int, C: int) -> torch.Tensor:
    """Plain version of K8's moments: for every slot, the 10 moments
    [cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz] of the occupied slots
    within sqrt(r2) in the 27 neighboring cells (self included), 0 for an
    unoccupied slot. (G^3 * C, 10) float32.

    The sums run over the offsets (dx, dy, dz) in `_neighbor_offsets` order
    and, within each, over the candidate slots c' = 0..C-1, one rounding an
    operation: the order K8 adds them in."""
    P = pk.reshape(G, G, G, C, 4)
    Pp = torch.nn.functional.pad(P, (0, 0, 0, 0, 1, 1, 1, 1, 1, 1))  # empty cells off the grid
    qx, qy, qz, qo = P.unbind(-1)  # (G, G, G, C)
    r2 = _f32(r2, pk.device)
    acc = [torch.zeros_like(qx) for _ in MOMENT_CHANNELS]
    for dx, dy, dz in _neighbor_offsets():
        cand = Pp[1 + dx:1 + dx + G, 1 + dy:1 + dy + G, 1 + dz:1 + dz + G]
        for c in range(C):
            cx, cy, cz, co = (cand[..., c, j][..., None] for j in range(4))
            d0, d1, d2 = qx - cx, qy - cy, qz - cz
            dd = d0 * d0 + d1 * d1 + d2 * d2
            w = torch.where(dd <= r2, co * qo, 0.0)
            wx, wy, wz = w * cx, w * cy, w * cz
            for i, f in enumerate((w, wx, wy, wz, wx * cx, wy * cy, wz * cz,
                                   wx * cy, wx * cz, wy * cz)):
                acc[i] = acc[i] + f
    return torch.stack(acc, -1).reshape(G * G * G * C, len(MOMENT_CHANNELS))


def normals_from_moments(m: torch.Tensor) -> torch.Tensor:
    """K8's fused finish on (..., 10) moments: normalize by max(cnt, 1), the
    raw-moment covariance E[x x^T] - E[x] E[x]^T, its smallest eigenvector
    (pointcloud/normals.py:_eig6_channels); returns (..., 4) [nx, ny, nz, cnt]."""
    from recon3d_tpu_torch.pointcloud.normals import _eig6_channels

    n = m[..., 0]
    nn = torch.clamp(n, min=1.0)
    mx, my, mz = m[..., 1] / nn, m[..., 2] / nn, m[..., 3] / nn
    xx = m[..., 4] / nn - mx * mx
    yy = m[..., 5] / nn - my * my
    zz = m[..., 6] / nn - mz * mz
    xy = m[..., 7] / nn - mx * my
    xz = m[..., 8] / nn - mx * mz
    yz = m[..., 9] / nn - my * mz
    vx, vy, vz = _eig6_channels(xx, yy, zz, xy, xz, yz)
    return torch.stack([vx, vy, vz, n], -1)


def core_plain(pk: torch.Tensor, r2, G: int, C: int, fuse_eig: bool) -> torch.Tensor:
    """Plain version of K8: the moments, or with `fuse_eig` the normals."""
    m = moments_plain(pk, r2, G, C)
    return normals_from_moments(m) if fuse_eig else m


def grid_pca_moments(points: torch.Tensor, valid: torch.Tensor, radius,
                     grid_size: int = 64, cell_capacity: int = 8):
    """Per-point neighborhood moments within `radius`: (count (N,), mean
    (N, 3), covariance (N, 3, 3)), self included; the plain route."""
    G, C = grid_size, cell_capacity
    pk, point_slot, _ = _bin_points_packed(points, valid, radius, G, C)
    r = _f32(radius, pk.device)
    m = moments_plain(pk, r * r, G, C)
    has = point_slot >= 0
    rows = m[torch.clamp(point_slot, min=0).long()]
    n = torch.where(has, rows[:, 0], 0.0)
    nn = torch.clamp(n, min=1.0)[:, None]
    mean = rows[:, 1:4] / nn
    m2 = rows[:, 4:10] / nn
    mx, my, mz = mean.unbind(1)
    cov = torch.stack([
        torch.stack([m2[:, 0] - mx * mx, m2[:, 3] - mx * my, m2[:, 4] - mx * mz], -1),
        torch.stack([m2[:, 3] - mx * my, m2[:, 1] - my * my, m2[:, 5] - my * mz], -1),
        torch.stack([m2[:, 4] - mx * mz, m2[:, 5] - my * mz, m2[:, 2] - mz * mz], -1),
    ], -2)
    return n, mean, cov


def _offsets(device) -> torch.Tensor:
    return torch.tensor(_neighbor_offsets(), dtype=torch.int32, device=device)


def _neighbor_candidates(cell: torch.Tensor, q: torch.Tensor, sp: torch.Tensor,
                         order: torch.Tensor, start: torch.Tensor, G: int, C: int):
    """For queries in cells `cell` (n, 3) at points q (n, 3): the C slots of
    each of the 27 neighboring cells of the binned set (sp, order, start),
    flattened (offset, slot) to 27 * C columns. Returns (d2 (n, 27C) with
    BIG where the slot is empty or its cell is off the grid, the candidates'
    original indices (n, 27C), the (0, 0, 0) offset's column block start)."""
    nb = cell[:, None, :] + _offsets(cell.device)[None]  # (n, 27, 3)
    off_grid = ((nb < 0) | (nb >= G)).any(dim=-1)
    nb = nb.clamp(0, G - 1)
    nid = ((nb[..., 0] * G + nb[..., 1]) * G + nb[..., 2]).long()
    pos = start[nid][..., None] + torch.arange(C, dtype=start.dtype, device=start.device)
    empty = (pos >= start[nid + 1][..., None]) | off_grid[..., None]  # (n, 27, C)
    pos = pos.clamp(max=max(sp.shape[0] - 1, 0)).long()
    d = q[:, None, None, :] - sp[pos]
    # the sum of squares as XLA's fused reduction of three rounds it
    d2 = fma(d[..., 2], d[..., 2], fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))
    d2 = torch.where(empty, BIG, d2)
    n = cell.shape[0]
    return d2.reshape(n, 27 * C), order[pos].reshape(n, 27 * C), 13 * C


def _cells_of_sorted(sc: torch.Tensor, G: int) -> torch.Tensor:
    """(x, y, z) of cell ids (in-grid ids only are meaningful)."""
    return torch.stack([sc // (G * G), (sc // G) % G, sc % G], -1)


def grid_knn(points: torch.Tensor, valid: torch.Tensor, radius, k: int = 30,
             grid_size: int = 64, cell_capacity: int = 8) -> GridKNNResult:
    """Approximate k-NN (excluding self) among neighbors within ~radius.

    Exact for every neighbor pair closer than `radius` when neither point
    overflows its cell; farther pairs (up to 2 sqrt(3) radius) may be found
    but are not guaranteed. ops/knn.py's contract otherwise: (indices
    (N, k), sq_dists (N, k)), ascending, ties to the earlier candidate in
    (offset, slot) order, BIG and index 0 where fewer than k were found."""
    p = points.to(torch.float32)
    G, C = grid_size, cell_capacity
    dev = p.device
    sc, sp, order, start, ok, rank, overflow = _sort_cells(p, valid, radius, G, C)
    rows = ok.nonzero()[:, 0]  # the sorted points that hold a slot
    d2, idx, self_block = _neighbor_candidates(_cells_of_sorted(sc[rows], G), sp[rows], sp,
                                               order, start, G, C)
    n = rows.shape[0]
    ar = torch.arange(n, device=dev)
    d2[ar, self_block + rank[rows].long()] = BIG  # the query's own slot
    # k placeholders (BIG, index 0) ahead of the candidates: lax.top_k's
    # running merge keeps them before any masked candidate
    d2 = torch.cat([torch.full((n, k), BIG, dtype=torch.float32, device=dev), d2], 1)
    idx = torch.cat([torch.zeros((n, k), dtype=idx.dtype, device=dev), idx], 1)
    vals, cols = smallest_k(d2, k)
    out_d = torch.full((p.shape[0], k), BIG, dtype=torch.float32, device=dev)
    out_i = torch.zeros((p.shape[0], k), dtype=torch.int32, device=dev)
    orig = order[rows].long()
    out_d[orig] = vals
    out_i[orig] = torch.gather(idx, 1, cols).to(torch.int32)
    out_d = torch.where(out_d >= BIG, BIG, torch.clamp(out_d, min=0.0))
    return GridKNNResult(out_i, out_d, overflow)


def grid_nearest_neighbor(query: torch.Tensor, query_valid: torch.Tensor, db: torch.Tensor,
                          db_valid: torch.Tensor, radius, grid_size: int = 64,
                          cell_capacity: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-set 1-NN among db points within ~radius: ICP's large-cloud
    correspondence search. Returns (indices (Nq,) int32, sq_dists (Nq,));
    a query with no candidate, or that is invalid or lost its own cell slot,
    gets sq_dist BIG and index 0 (ICP's threshold rejects it, as on the
    brute-force path). Queries and db are binned on one shared origin so
    their cells align. One host sync: the count of kept queries."""
    qp = query.to(torch.float32)
    dp = db.to(torch.float32)
    G, C = grid_size, cell_capacity
    dev = qp.device
    r = _f32(radius, dev)
    both = torch.cat([torch.where(query_valid[:, None], qp, BIG),
                      torch.where(db_valid[:, None], dp, BIG)])
    lo = both.min(dim=0).values - 0.5 * r
    q_sc, q_sp, q_order, _, q_ok, _, _ = _sort_cells(qp, query_valid, radius, G, C, lo=lo)
    _, d_sp, d_order, d_start, _, _, _ = _sort_cells(dp, db_valid, radius, G, C, lo=lo)
    rows = q_ok.nonzero()[:, 0]
    d2, idx, _ = _neighbor_candidates(_cells_of_sorted(q_sc[rows], G), q_sp[rows], d_sp,
                                      d_order, d_start, G, C)
    md, mi = torch.min(d2, dim=1)  # the first minimum in (offset, slot) order
    best_i = torch.where(md < BIG, torch.gather(idx, 1, mi[:, None])[:, 0], 0)
    out_d = torch.full((qp.shape[0],), BIG, dtype=torch.float32, device=dev)
    out_i = torch.zeros((qp.shape[0],), dtype=torch.int32, device=dev)
    orig = q_order[rows].long()
    out_d[orig] = md
    out_i[orig] = best_i.to(torch.int32)
    return out_i, torch.where(query_valid, out_d, BIG)
