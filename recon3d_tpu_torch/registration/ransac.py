"""Global registration: RANSAC over FPFH correspondences, and FGR (twin of
recon3d_tpu/registration/ransac.py).

Replaces o3d registration_ransac_based_on_feature_matching
(test/mini1.py:271-291: distance threshold 1.5 * voxel, edge-length and
distance checkers) and registration_fgr_based_on_feature_matching
(test/check8.py:244-258).

RANSAC runs a fixed batch of trials: each samples 3 correspondences, solves
Kabsch in closed form, applies the edge-length checker and counts inliers
on a fixed scoring subset; the first best trial wins. The draws come from a
`torch.Generator` on the CPU seeded by `seed` (the JAX package's
counter-based PRNG cannot be reproduced), so a seed gives the same trials
on every device; `_ransac_trials` scores given draws. FGR is graduated
non-convexity IRLS on mutual matches (scaled Geman-McClure, mu halved every
4 sweeps), each sweep a closed 6x6 solve.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from recon3d_tpu_torch.registration import se3
from recon3d_tpu_torch.registration.features import match_features
from recon3d_tpu_torch.registration.icp import (RegistrationResult, evaluate_registration,
                                                registration_icp)
from recon3d_tpu_torch.utils.types import PointCloud

TRIAL_BATCH = 4096  # trials scored at once (the JAX package's lax.map batch)


def _kabsch3(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Rigid transforms from small correspondence sets (..., n, 3) ->
    (..., 4, 4)."""
    mu_s = torch.mean(src, -2)
    mu_d = torch.mean(dst, -2)
    S = (dst - mu_d[..., None, :]).transpose(-1, -2) @ (src - mu_s[..., None, :])
    U, _, Vt = torch.linalg.svd(S)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ D @ Vt
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return se3._homogeneous(R, t)


def draw_trials(corr_ok: torch.Tensor, num_trials: int, ransac_n: int, score_subset: int,
                seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trials' picks (num_trials, ransac_n) and the scoring subset
    (score_subset,): indices drawn with replacement, uniformly among the
    usable pairs (uniformly among all when none is), from a CPU generator
    seeded by `seed`; moved to corr_ok's device (one host read of corr_ok)."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    w = corr_ok.detach().to("cpu", torch.float64)
    if not bool(w.any()):
        w = torch.ones_like(w)
    picks = torch.multinomial(w, num_trials * ransac_n, replacement=True, generator=g)
    score_idx = torch.multinomial(w, score_subset, replacement=True, generator=g)
    dev = corr_ok.device
    return picks.reshape(num_trials, ransac_n).to(dev), score_idx.to(dev)


def _ransac_trials(src_pts: torch.Tensor, tgt_pts: torch.Tensor, picks: torch.Tensor,
                   score_idx: torch.Tensor, distance_threshold: float,
                   edge_length_similarity: float = 0.9) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score given trials: (scores (T,), transforms (T, 4, 4)). A trial's
    score is its inlier count on the scoring subset, -1 where its
    edge-length check fails (Open3D's CorrespondenceCheckerBasedOnEdgeLength).
    Scored TRIAL_BATCH trials at a time: all 65,536 at once would hold
    65536 x 2048 x 3 floats."""
    s_sub = src_pts[score_idx.long()]
    t_sub = tgt_pts[score_idx.long()]
    n = picks.shape[1]
    iu = torch.triu_indices(n, n, 1, device=picks.device)
    scores, Ts = [], []
    for i in range(0, picks.shape[0], TRIAL_BATCH):
        pk = picks[i:i + TRIAL_BATCH].long()
        s = src_pts[pk]  # (B, n, 3)
        t = tgt_pts[pk]
        ds = torch.linalg.vector_norm(s[:, :, None, :] - s[:, None, :, :], dim=-1)
        dt = torch.linalg.vector_norm(t[:, :, None, :] - t[:, None, :, :], dim=-1)
        ratio = torch.minimum(ds, dt) / torch.clamp(torch.maximum(ds, dt), min=1e-12)
        edges_ok = torch.all(ratio[:, iu[0], iu[1]] > edge_length_similarity, dim=1)
        T = _kabsch3(s, t)
        moved = s_sub @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]  # (B, S, 3)
        err = torch.linalg.vector_norm(moved - t_sub, dim=-1)
        inliers = torch.sum((err < distance_threshold).to(torch.float32), dim=1)
        scores.append(torch.where(edges_ok, inliers, -1.0))
        Ts.append(T)
    return torch.cat(scores), torch.cat(Ts)


def ransac_from_correspondences(
    src_pts: torch.Tensor,
    tgt_pts: torch.Tensor,
    corr_ok: torch.Tensor,
    distance_threshold: float,
    num_trials: int = 65536,
    ransac_n: int = 3,
    edge_length_similarity: float = 0.9,
    score_subset: int = 2048,
    seed: int = 0,
) -> torch.Tensor:
    """Batched RANSAC. src_pts / tgt_pts: (N, 3) corresponding pairs
    (already matched by features); corr_ok: (N,) usable-pair mask. Returns
    the first best trial's (4, 4) transform."""
    picks, score_idx = draw_trials(corr_ok, num_trials, ransac_n, score_subset, seed)
    scores, Ts = _ransac_trials(src_pts, tgt_pts, picks, score_idx, distance_threshold,
                                edge_length_similarity)
    return Ts[torch.argmax(scores)]  # argmax: the first maximum


def registration_ransac_fpfh(
    source: PointCloud,
    target: PointCloud,
    feat_src: torch.Tensor,
    feat_tgt: torch.Tensor,
    distance_threshold: float,
    num_trials: int = 65536,
    mutual: bool = True,
    refine_icp: bool = True,
    seed: int = 0,
) -> RegistrationResult:
    """Feature matching + RANSAC + (optional) ICP refine: the mini1.py
    RANSAC-FPFH -> point-to-plane ICP chain (mini1.py:271-305)."""
    s2t, ok = match_features(feat_src, source.valid, feat_tgt, target.valid, mutual=mutual)
    T = ransac_from_correspondences(source.points, target.points[s2t.long()], ok,
                                    distance_threshold, num_trials=num_trials, seed=seed)
    if refine_icp:
        method = "point_to_plane" if target.normals is not None else "point_to_point"
        return registration_icp(source, target, distance_threshold, init=T, method=method,
                                max_iterations=30)
    return evaluate_registration(source, target, distance_threshold, T)


def fgr_core(src_pts: torch.Tensor, tgt_pts: torch.Tensor, corr_ok: torch.Tensor,
             max_corr_distance: float, iterations: int = 64) -> torch.Tensor:
    """Fast Global Registration: GNC / IRLS with scaled Geman-McClure.

    src / tgt (N, 3) matched pairs; returns (4, 4). mu starts at the square
    of 16 correspondence distances and halves every 4 sweeps down to the
    correspondence distance squared (Zhou, Park, Koltun's schedule)."""
    dev = src_pts.device
    w_valid = corr_ok.to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    mu = f32((max_corr_distance * 16.0) ** 2)
    mu_min = f32(max_corr_distance ** 2)
    T = torch.eye(4, dtype=torch.float32, device=dev)
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(src_pts.shape[0], 3, 3)
    for it in range(iterations):
        p = se3.apply(T, src_pts)
        r = p - tgt_pts  # (N, 3)
        r2 = torch.sum(r * r, -1)
        w = w_valid * (mu / (mu + r2)) ** 2  # GM weights
        # linearized point-to-point solve: J_i = [I | -hat(p_i)]
        J = torch.cat([eye, -se3.hat(p)], 2)  # (N, 3, 6)
        A = (torch.einsum("nij,nik,n->jk", J, J, w)
             + 1e-8 * torch.eye(6, dtype=torch.float32, device=dev))
        b = torch.einsum("nij,ni,n->j", J, r, w)
        xi = -torch.linalg.solve_ex(A, b).result
        T = se3.se3_exp(xi) @ T
        if (it + 1) % 4 == 0:
            mu = torch.maximum(mu * 0.5, mu_min)
    return T


def registration_fgr_fpfh(source: PointCloud, target: PointCloud, feat_src: torch.Tensor,
                          feat_tgt: torch.Tensor, max_corr_distance: float) -> RegistrationResult:
    """o3d registration_fgr_based_on_feature_matching (check8.py:244-258)."""
    s2t, ok = match_features(feat_src, source.valid, feat_tgt, target.valid, mutual=True)
    T = fgr_core(source.points, target.points[s2t.long()], ok, max_corr_distance)
    return evaluate_registration(source, target, max_corr_distance, T)


def multiscale_icp(source: PointCloud, target: PointCloud, voxel_sizes, iterations,
                   init: Optional[torch.Tensor] = None,
                   method: str = "point_to_plane") -> RegistrationResult:
    """Coarse-to-fine ICP (check8.py:255-274: scales 15x / 5x / 1.5x voxel
    with 30 / 20 / 10 iterations)."""
    from recon3d_tpu_torch.pointcloud.normals import estimate_normals
    from recon3d_tpu_torch.pointcloud.voxel import voxel_downsample

    dev = source.points.device
    T = (torch.eye(4, dtype=torch.float32, device=dev) if init is None
         else torch.as_tensor(init, dtype=torch.float32, device=dev))
    result = None
    for vs, iters in zip(voxel_sizes, iterations):
        src = voxel_downsample(source, vs)
        tgt = voxel_downsample(target, vs)
        if method == "point_to_plane":
            tgt = estimate_normals(tgt, radius=vs * 2.0, max_nn=30)
        result = registration_icp(src, tgt, threshold=vs * 1.5, init=T, method=method,
                                  max_iterations=iters)
        T = result.transformation
    return result
