"""ICP registration: point-to-point, point-to-plane and Generalized ICP
(twin of recon3d_tpu/registration/icp.py).

Replaces o3d.pipelines.registration.registration_icp
(pointcloud_alignment.py:35-40: threshold 0.02, max 100 iterations,
relative fitness / rmse 1e-6) and registration_generalized_icp
(test/GICP1.py:99-103). Correspondences come from the blocked brute-force
1-NN (ops/knn.py) or, for clouds with N * M > 2^26, the voxel-grid 1-NN
(ops/grid_knn.py), the switch the JAX package makes. Each iteration solves
a closed-form alignment (weighted SVD / Umeyama for point-to-point; 6x6
Gauss-Newton normal equations for point-to-plane and GICP).

The JAX package runs the iterations in one lax.while_loop; here the loop
runs on the host and reads its `done` flag back once an iteration (one
device sync; the grid 1-NN adds one a call, two an iteration).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from recon3d_tpu_torch.ops import knn as _knn
from recon3d_tpu_torch.ops.grid_knn import grid_nearest_neighbor
from recon3d_tpu_torch.registration import se3
from recon3d_tpu_torch.utils.types import PointCloud

GRID_SWITCH = 1 << 26  # N * M above this: the voxel-grid 1-NN


class RegistrationResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4) source -> target
    fitness: torch.Tensor  # inlier fraction of valid source points
    inlier_rmse: torch.Tensor
    iterations: torch.Tensor

    def is_good(self, fitness_min: float = 0.3, rmse_max: float = 0.02) -> torch.Tensor:
        """Registration quality gate (test/check6.py:65-76)."""
        return (self.fitness >= fitness_min) & (self.inlier_rmse <= rmse_max)


def uses_grid(n_source: int, n_target: int) -> bool:
    """Whether a registration of these capacities takes the grid 1-NN."""
    return n_source * n_target > GRID_SWITCH


def _correspondences(src_pts, src_valid, tgt: PointCloud, threshold):
    """(target index, d^2, inlier mask) per source point. `threshold` is a
    float32 0-d tensor inside registration_icp (its square taken in float32,
    as the jitted JAX function squares its traced argument) or a Python
    float (squared in double, then compared in float32)."""
    if uses_grid(src_pts.shape[0], tgt.points.shape[0]):
        # exact for matches within `threshold` (cell edge = threshold, so
        # the 27 cells cover the ball); farther matches are rejected below
        idx, d2 = grid_nearest_neighbor(src_pts, src_valid, tgt.points, tgt.valid, threshold)
    else:
        idx, d2 = _knn.nearest_neighbor(src_pts, src_valid, tgt.points, tgt.valid)
    ok = src_valid & (d2 <= threshold * threshold)
    return idx.long(), d2, ok


def _umeyama(src, dst, w):
    """Weighted rigid alignment (Kabsch / Umeyama closed form), w (N,)."""
    ws = torch.clamp(torch.sum(w), min=1e-12)
    mu_s = torch.sum(src * w[:, None], 0) / ws
    mu_d = torch.sum(dst * w[:, None], 0) / ws
    S = ((dst - mu_d) * w[:, None]).T @ (src - mu_s) / ws
    U, _, Vt = torch.linalg.svd(S)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = U @ D @ Vt
    t = mu_d - R @ mu_s
    return se3._homogeneous(R, t)


def _p2p_step(src_pts, src_valid, tgt, threshold):
    idx, d2, ok = _correspondences(src_pts, src_valid, tgt, threshold)
    w = ok.to(torch.float32)
    return _umeyama(src_pts, tgt.points[idx], w), w, d2


def _p2plane_step(src_pts, src_valid, tgt, threshold):
    """One Gauss-Newton step on sum w ((R p + t - q) . n)^2, linearized."""
    idx, d2, ok = _correspondences(src_pts, src_valid, tgt, threshold)
    q = tgt.points[idx]
    n = tgt.normals[idx]
    w = ok.to(torch.float32)
    r = torch.sum((src_pts - q) * n, dim=1)  # residuals
    J = torch.cat([n, torch.linalg.cross(src_pts, n, dim=1)], 1)  # (N, 6) [t, omega]
    Jw = J * w[:, None]
    A = Jw.T @ J + 1e-9 * torch.eye(6, dtype=src_pts.dtype, device=src_pts.device)
    b = Jw.T @ r
    xi = -torch.linalg.solve_ex(A, b).result
    return se3.se3_exp(xi), w, d2


def _gicp_step(src_pts, src_valid, src_cov, tgt, tgt_cov, threshold, R=None):
    """Generalized-ICP step: Mahalanobis plane-to-plane (GICP1.py:99-103).

    R: the current total rotation (3, 3). The combined covariance is
    C_tgt + R C_src R^T: the source covariances were computed in the
    source frame, so they ride the running rotation (Segal et al. eq. 2)."""
    idx, d2, ok = _correspondences(src_pts, src_valid, tgt, threshold)
    q = tgt.points[idx]
    Cb = tgt_cov[idx]
    w = ok.to(torch.float32)
    if R is not None:
        src_cov = torch.einsum("ij,njk,lk->nil", R, src_cov, R)
    eye3 = torch.eye(3, dtype=src_pts.dtype, device=src_pts.device)
    Minv = torch.linalg.inv_ex(Cb + src_cov + 1e-9 * eye3).inverse
    r = src_pts - q  # (N, 3)
    # J_i = [I | -hat(p)] (3, 6)
    J = torch.cat([eye3.expand(src_pts.shape[0], 3, 3), -se3.hat(src_pts)], 2)
    WJ = Minv @ J  # (N, 3, 6)
    A = (torch.einsum("nij,nik,n->jk", J, WJ, w)
         + 1e-9 * torch.eye(6, dtype=src_pts.dtype, device=src_pts.device))
    b = torch.einsum("nij,ni,n->j", WJ, r, w)
    xi = -torch.linalg.solve_ex(A, b).result
    return se3.se3_exp(xi), w, d2


def covariances_for_gicp(pc: PointCloud, k: int = 20, epsilon: float = 1e-3) -> torch.Tensor:
    """GICP surface covariances: PCA frames with eigenvalues (epsilon, 1, 1).

    They equal I - (1 - epsilon) v v^T for the smallest eigenvector v, so
    the eigenvectors' signs (which torch.linalg.eigh and the JAX package's
    eigh choose otherwise) do not reach the result."""
    idx, d2 = _knn.knn(pc.points, pc.valid, k=k)
    nbrs = pc.points[idx.long()]
    ok = (d2 < 1e29).to(torch.float32)[..., None]
    cnt = torch.clamp(torch.sum(ok, 1), min=1.0)
    mean = torch.sum(nbrs * ok, 1) / cnt
    d = (nbrs - mean[:, None, :]) * ok
    C = torch.einsum("nki,nkj->nij", d, d) / cnt[..., None]
    w_eig, V = torch.linalg.eigh(C)
    lam = torch.stack([torch.full_like(w_eig[:, 0], epsilon), torch.ones_like(w_eig[:, 0]),
                       torch.ones_like(w_eig[:, 0])], -1)
    return torch.einsum("nij,nj,nkj->nik", V, lam, V)


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded (taken in float64)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _fitness_rmse(w, d2, n_src):
    fitness = torch.sum(w) / n_src
    rmse = _sqrt32(torch.sum(d2 * w) / torch.clamp(torch.sum(w), min=1.0))
    return fitness, rmse


def _as_transform(T, device) -> torch.Tensor:
    if T is None:
        return torch.eye(4, dtype=torch.float32, device=device)
    return torch.as_tensor(T, dtype=torch.float32, device=device)


def registration_icp(
    source: PointCloud,
    target: PointCloud,
    threshold: float = 0.02,
    init: Optional[torch.Tensor] = None,
    method: str = "point_to_point",
    max_iterations: int = 100,
    relative_fitness: float = 1e-6,
    relative_rmse: float = 1e-6,
    source_cov: Optional[torch.Tensor] = None,
    target_cov: Optional[torch.Tensor] = None,
) -> RegistrationResult:
    """Open3D-compatible ICP. init: (4, 4) initial source -> target transform.

    method: 'point_to_point' | 'point_to_plane' (target needs normals) |
    'gicp' (pass source_cov / target_cov from covariances_for_gicp). Stops
    after max_iterations, or once fitness and rmse both changed by less than
    their relative tolerances in one iteration (Open3D's rule)."""
    if method not in ("point_to_point", "point_to_plane", "gicp"):
        raise ValueError(f"unknown ICP method {method}")
    dev = source.points.device
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    T = _as_transform(init, dev)
    n_src = torch.clamp(torch.sum(source.valid.to(torch.float32)), min=1.0)

    def metrics(T):
        pts = se3.apply(T, source.points)
        _, d2, ok = _correspondences(pts, source.valid, target, thr)
        return _fitness_rmse(ok.to(torch.float32), d2, n_src)

    def step_fn(pts, T):
        if method == "point_to_point":
            return _p2p_step(pts, source.valid, target, thr)
        if method == "point_to_plane":
            return _p2plane_step(pts, source.valid, target, thr)
        return _gicp_step(pts, source.valid, source_cov, target, target_cov, thr, R=T[:3, :3])

    fit, rmse = metrics(T)
    it = 0
    while it < max_iterations:
        dT, _, _ = step_fn(se3.apply(T, source.points), T)
        T = dT @ T
        fit_new, rmse_new = metrics(T)
        rel_fit = torch.abs(fit_new - fit) / torch.clamp(fit, min=1e-12)
        rel_rmse = torch.abs(rmse_new - rmse) / torch.clamp(rmse, min=1e-12)
        fit, rmse = fit_new, rmse_new
        it += 1
        if bool((rel_fit < relative_fitness) & (rel_rmse < relative_rmse)):
            break
    return RegistrationResult(transformation=T, fitness=fit, inlier_rmse=rmse,
                              iterations=torch.tensor(it, device=dev))


def evaluate_registration(source: PointCloud, target: PointCloud, threshold: float,
                          transformation: Optional[torch.Tensor] = None) -> RegistrationResult:
    """o3d evaluate_registration: fitness / rmse at a fixed transform."""
    dev = source.points.device
    T = _as_transform(transformation, dev)
    pts = se3.apply(T, source.points)
    _, d2, ok = _correspondences(pts, source.valid, target, threshold)
    n_src = torch.clamp(torch.sum(source.valid.to(torch.float32)), min=1.0)
    fitness, rmse = _fitness_rmse(ok.to(torch.float32), d2, n_src)
    return RegistrationResult(T, fitness, rmse, torch.tensor(0, device=dev))


def information_matrix(source: PointCloud, target: PointCloud, threshold: float,
                       transformation: torch.Tensor) -> torch.Tensor:
    """o3d get_information_matrix_from_point_clouds (mini1.py:307-313): the
    6x6 Gauss-Newton information of the point-to-point objective at T, with
    J_i = [I | -hat(q_i)] on the target points (Open3D's convention)."""
    pts = se3.apply(_as_transform(transformation, source.points.device), source.points)
    idx, _, ok = _correspondences(pts, source.valid, target, threshold)
    w = ok.to(torch.float32)
    q = target.points[idx]
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device).expand(pts.shape[0], 3, 3)
    J = torch.cat([eye, -se3.hat(q)], 2)
    return torch.einsum("nij,nik,n->jk", J, J, w)
