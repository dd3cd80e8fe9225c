"""Exact nearest-neighbor search over masked point sets by blocked brute
force (twin of recon3d_tpu/ops/knn.py: `knn`, `radius_count`,
`nearest_neighbor`, `hybrid_knn`).

Queries go in tiles of `tile` rows; each tile's (tile, N) squared distances
come from the expansion |q|^2 + |p|^2 - 2 q.p, the product a plain float32
matrix product (one addmm a tile). TF32 stays off (`torch.backends.cuda.matmul.allow_tf32`
is False by default and nothing here turns it on): with ~10 mantissa bits
the distances of a 1.8 m cloud at mm spacing would lose their order.

The sums of squares are the fused multiply-add chain XLA forms from the
JAX package's `jnp.sum(p * p, axis=1)`, so on the CPU the distances and
the selections agree with the JAX package's bit for bit. Selection follows
`lax.top_k`: the k smallest distances, ties to the lower index.

All functions take (N, 3) points + validity mask; invalid points neither
match nor query (their results are masked).
"""
from __future__ import annotations

from typing import Tuple

import torch

from recon3d_tpu_torch.ops.image import fma

BIG = 1e30


def _sq_norms(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 per row as the chain fma(z, z, fma(y, y, x * x)), over every
    column for rows wider than 3 (feature vectors)."""
    acc = p[:, 0] * p[:, 0]
    for j in range(1, p.shape[1]):
        acc = fma(p[:, j], p[:, j], acc)
    return acc


def _masked_sq_norms(p: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """|p|^2, BIG for invalid rows: BIG + |q|^2 - 2 q.p rounds to BIG, which
    is what the JAX package's added mask (+ BIG) gives those columns."""
    return torch.where(valid, _sq_norms(p), BIG)


def _tile_d2(q: torch.Tensor, p: torch.Tensor, qn: torch.Tensor, sq: torch.Tensor,
             self_offset: int | None) -> torch.Tensor:
    """(T, N) squared distances (|q|^2 + |p|^2) - 2 q.p, with query row i's
    own column (self_offset + i) set to BIG when given."""
    # one float32 product (addmm, alpha = -2: 2 q.p is exact), TF32 off
    d2 = (qn[:, None] + sq[None, :]).addmm_(q, p.T, alpha=-2.0)
    if self_offset is not None:
        rows = torch.arange(q.shape[0], device=q.device)
        d2[rows, rows + self_offset] = BIG
    return d2


def smallest_k(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of d2 in ascending order, ties to
    the lower column index (lax.top_k's order on -d2): (values, indices)."""
    T, N = d2.shape
    kk = min(k + 1, N)
    vals, idx = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
    kth = vals[:, k - 1:k]
    # rows whose k-th value also lies beyond k: topk may have taken any of
    # the tied columns; keep those below the k-th value and the lowest-index
    # columns equal to it
    tied = (vals[:, k] == kth[:, 0]) if kk > k else torch.zeros(T, dtype=torch.bool,
                                                                device=d2.device)
    vals, idx = vals[:, :k], idx[:, :k]
    if bool(tied.any()):
        rows = tied.nonzero()[:, 0]
        sub = d2[rows]
        below = sub < kth[rows]
        eq = sub == kth[rows]
        need = k - below.sum(1, keepdim=True)
        take = below | (eq & (torch.cumsum(eq.to(torch.int32), 1) <= need))
        cols = take.nonzero()[:, 1].reshape(-1, k)  # ascending column order
        vals[rows] = torch.gather(sub, 1, cols)
        idx[rows] = cols
    # order each row by (value, index): sort by index, then stably by value
    idx, perm = torch.sort(idx, dim=1)
    vals = torch.gather(vals, 1, perm)
    vals, perm = torch.sort(vals, dim=1, stable=True)
    return vals, torch.gather(idx, 1, perm)


def knn(points: torch.Tensor, valid: torch.Tensor, k: int = 30,
        tile: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN (excluding self): (indices (N, k) int32, sq_dists (N, k)).

    Invalid neighbors are excluded; invalid queries get dist BIG."""
    p = points.to(torch.float32)
    N = p.shape[0]
    qn, sq = _sq_norms(p), _masked_sq_norms(p, valid)
    idxs, d2s = [], []
    for i in range(0, N, tile):
        d2 = _tile_d2(p[i:i + tile], p, qn[i:i + tile], sq, i)
        v, ix = smallest_k(d2, k)
        d2s.append(v)
        idxs.append(ix)
    d2s = torch.clamp(torch.cat(d2s), min=0.0)
    return torch.cat(idxs).to(torch.int32), torch.where(valid[:, None], d2s, BIG)


def radius_count(points: torch.Tensor, valid: torch.Tensor, radius: float,
                 tile: int = 1024) -> torch.Tensor:
    """Number of (valid) neighbors within `radius` of each point, excl. self."""
    p = points.to(torch.float32)
    N = p.shape[0]
    qn, sq = _sq_norms(p), _masked_sq_norms(p, valid)
    r = torch.tensor(radius, dtype=torch.float32, device=p.device)
    r2 = r * r  # in float32, as the JAX package squares its traced radius
    counts = torch.cat([(_tile_d2(p[i:i + tile], p, qn[i:i + tile], sq, i) <= r2).sum(1)
                        for i in range(0, N, tile)])
    return torch.where(valid, counts, 0).to(torch.int32)


def nearest_neighbor(query: torch.Tensor, query_valid: torch.Tensor, db: torch.Tensor,
                     db_valid: torch.Tensor, tile: int = 1024) -> Tuple[torch.Tensor,
                                                                        torch.Tensor]:
    """Cross-set 1-NN: for each query point, its nearest valid db point;
    (indices (Nq,) int32, sq_dists (Nq,)), ties to the lower index."""
    q = query.to(torch.float32)
    p = db.to(torch.float32)
    sq = _masked_sq_norms(p, db_valid)
    qn = _sq_norms(q)
    idxs, d2s = [], []
    for i in range(0, q.shape[0], tile):
        d2 = _tile_d2(q[i:i + tile], p, qn[i:i + tile], sq, None)
        ix = torch.argmin(d2, dim=1)  # the first minimum, as jnp.argmin
        idxs.append(ix)
        d2s.append(torch.gather(d2, 1, ix[:, None])[:, 0])
    d2s = torch.clamp(torch.cat(d2s), min=0.0)
    return torch.cat(idxs).to(torch.int32), torch.where(query_valid, d2s, BIG)


def hybrid_knn(points: torch.Tensor, valid: torch.Tensor, radius: float, max_nn: int = 30,
               k: int | None = None, tile: int = 1024):
    """Open3D KDTreeSearchParamHybrid: up to max_nn nearest neighbors within
    `radius`: (indices (N, max_nn), sq_dists, neighbor_valid mask)."""
    idx, d2 = knn(points, valid, k=max_nn, tile=tile)
    r = torch.tensor(radius, dtype=torch.float32, device=d2.device)
    return idx, d2, d2 <= r * r
