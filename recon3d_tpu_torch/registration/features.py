"""FPFH features and feature-space matching (twin of
recon3d_tpu/registration/features.py).

Replaces o3d.pipelines.registration.compute_fpfh_feature (test/mini1.py:244-251)
and the feature-matching front end of RANSAC / FGR registration. The classic
33-bin FPFH: per-point SPFH from Darboux-frame angles (alpha, phi, theta)
binned 11 ways each, then neighbor-distance-weighted aggregation. Bins are
truncated toward zero (`.to(torch.int32)`, as the JAX package's
`.astype(int32)`), so a value on a bin edge falls the same way. Needs
normals (estimate first).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from recon3d_tpu_torch.ops import knn as _knn
from recon3d_tpu_torch.utils.types import PointCloud

N_BINS = 11


def _spfh(points, normals, idx, ok):
    """Per-point SPFH histograms (N, 33) from neighbor lists (N, K), and the
    neighbor distances (N, K)."""
    p = points[:, None, :]  # (N, 1, 3)
    q = points[idx]  # (N, K, 3)
    nq = normals[idx]
    npt = normals[:, None, :]
    d = q - p
    dist = torch.linalg.vector_norm(d, dim=-1)
    dn = d / torch.clamp(dist[..., None], min=1e-12)

    u = npt.expand(d.shape)
    v = torch.linalg.cross(dn, u, dim=-1)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
    w = torch.linalg.cross(u, v, dim=-1)

    alpha = torch.sum(v * nq, -1)  # [-1, 1]
    phi = torch.sum(u * dn, -1)  # [-1, 1]
    theta = torch.atan2(torch.sum(w * nq, -1), torch.sum(u * nq, -1))  # [-pi, pi]
    bins = torch.arange(N_BINS, device=points.device)

    def hist(vals, lo, hi):
        b = torch.clamp(((vals - lo) / (hi - lo) * N_BINS).to(torch.int32), 0, N_BINS - 1)
        onehot = b[..., None] == bins  # (N, K, 11)
        return torch.sum(onehot & ok[..., None], dim=1).to(torch.float32)

    h = torch.cat([hist(alpha, -1.0, 1.0), hist(phi, -1.0, 1.0),
                   hist(theta, -math.pi, math.pi)], dim=-1)  # (N, 33)
    cnt = torch.clamp(torch.sum(ok, dim=1, keepdim=True).to(torch.float32), min=1.0)
    return h * (100.0 / cnt), dist


def compute_fpfh(pc: PointCloud, radius: float = 0.05, max_nn: int = 100) -> torch.Tensor:
    """FPFH (N, 33): compute_fpfh_feature(radius, max_nn) over the hybrid
    neighbor search (mini1.py:244-251 uses radius = 5 * voxel, max_nn = 100)."""
    idx, _, ok = _knn.hybrid_knn(pc.points, pc.valid, radius, max_nn=max_nn)
    idx = idx.long()
    okf = ok & pc.valid[:, None] & pc.valid[idx]
    spfh, dist = _spfh(pc.points, pc.normals, idx, okf)
    # FPFH(p) = SPFH(p) + 1/k sum_q SPFH(q) / ||p - q||
    wgt = torch.where(okf, 1.0 / torch.clamp(dist, min=1e-6), 0.0)  # (N, K)
    k = torch.clamp(torch.sum(okf, dim=1, keepdim=True).to(torch.float32), min=1.0)
    nbr_sum = torch.einsum("nk,nkf->nf", wgt, spfh[idx])
    fpfh = spfh + nbr_sum / k
    return torch.where(pc.valid[:, None], fpfh, 0.0)


def match_features(feat_src: torch.Tensor, src_valid: torch.Tensor, feat_tgt: torch.Tensor,
                   tgt_valid: torch.Tensor, mutual: bool = True,
                   tile: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest neighbors in feature space: (target index per source point
    (N,) int32, match_ok (N,) mask). mutual=True keeps only cross-checked
    pairs (the FGR front end; Open3D's mutual_filter for RANSAC)."""
    s2t, _ = _knn.nearest_neighbor(feat_src, src_valid, feat_tgt, tgt_valid, tile=tile)
    ok = src_valid
    if mutual:
        t2s, _ = _knn.nearest_neighbor(feat_tgt, tgt_valid, feat_src, src_valid, tile=tile)
        back = t2s[s2t.long()]
        ok = ok & (back == torch.arange(feat_src.shape[0], device=back.device))
    return s2t, ok
