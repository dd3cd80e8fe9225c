"""Single-camera calibration: Zhang initialization + LM bundle adjustment
(twin of recon3d_tpu/calib/mono.py).

cv2.calibrateCamera for planar targets:
1. per-view planar homographies by normalized DLT (batched over views),
2. closed-form intrinsics from Zhang's absolute-conic constraints,
3. per-view extrinsics from H and K,
4. joint Levenberg-Marquardt over [fx, fy, cx, cy, dist, (rvec, tvec)_i],
   differentiating through calib.model.project_points.

Run in float64 (the JAX package runs under jax.enable_x64()). Everything
runs on the device of the points (the card for numpy, or `device`); no step
depends on the signs of
singular vectors (H / H[2, 2], ratios of Zhang's b, U @ Vt with the
determinant's sign), so LAPACK and cuSOLVER give the same answer.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from recon3d_tpu_torch.calib import lm as _lm
from recon3d_tpu_torch.calib import model as _m


def _mat3(rows) -> torch.Tensor:
    """A (..., 3, 3) matrix from 3 rows of 3 same-shaped tensors."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def find_homography_dlt(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Planar homography by normalized DLT (cv2.findHomography, method=0).

    src: (..., N, 2) source points, dst: (..., N, 2) destination points.
    Returns (..., 3, 3) with H[2, 2] = 1.
    """
    src, dst = torch.as_tensor(src), torch.as_tensor(dst)

    def normalize(p):
        mean = torch.mean(p, -2, keepdim=True)
        d = torch.mean(torch.linalg.norm(p - mean, dim=-1), -1)
        s = torch.sqrt(torch.tensor(2.0, dtype=p.dtype)) / torch.clamp(d, min=1e-12)
        zero, one = torch.zeros_like(s), torch.ones_like(s)
        T = _mat3([[s, zero, -s * mean[..., 0, 0]], [zero, s, -s * mean[..., 0, 1]],
                   [zero, zero, one]])
        return (p - mean) * s[..., None, None], T

    sp, Ts = normalize(src)
    dp, Td = normalize(dst)
    x, y = sp[..., 0], sp[..., 1]
    u, v = dp[..., 0], dp[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    A = torch.cat([r1, r2], -2)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    H = Vt[..., -1, :].reshape(*Vt.shape[:-2], 3, 3)
    H = torch.linalg.solve_ex(Td, H @ Ts)[0]
    return H / H[..., 2:3, 2:3]


def _zhang_intrinsics(Hs: torch.Tensor) -> torch.Tensor:
    """Closed-form K from >= 3 homographies (Zhang 2000). Hs: (V, 3, 3)."""

    def vij(i, j):
        H = Hs
        return torch.stack([
            H[:, 0, i] * H[:, 0, j],
            H[:, 0, i] * H[:, 1, j] + H[:, 1, i] * H[:, 0, j],
            H[:, 1, i] * H[:, 1, j],
            H[:, 2, i] * H[:, 0, j] + H[:, 0, i] * H[:, 2, j],
            H[:, 2, i] * H[:, 1, j] + H[:, 1, i] * H[:, 2, j],
            H[:, 2, i] * H[:, 2, j],
        ], -1)

    # rows view by view: v01, then v00 - v11
    A = torch.stack([vij(0, 1), vij(0, 0) - vij(1, 1)], 1).reshape(-1, 6)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    B11, B12, B22, B13, B23, B33 = Vt[-1]
    cy = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + cy * (B12 * B13 - B11 * B23)) / B11
    fx = torch.sqrt(torch.abs(lam / B11))
    fy = torch.sqrt(torch.abs(lam * B11 / (B11 * B22 - B12 * B12)))
    skew = -B12 * fx * fx * fy / lam
    cx = skew * cy / fy - B13 * fx * fx / lam
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return _mat3([[fx, zero, cx], [zero, fy, cy], [zero, zero, one]])


def _extrinsics_from_homography(H: torch.Tensor, K: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial (rvec, tvec) of planar views from their homographies
    H (..., 3, 3)."""
    Kinv = torch.linalg.inv_ex(K)[0]
    KH = Kinv @ H  # columns K^-1 h1, K^-1 h2, K^-1 h3
    lam = 1.0 / torch.clamp(torch.linalg.norm(KH[..., :, 0], dim=-1, keepdim=True), min=1e-12)
    r1 = lam * KH[..., :, 0]
    r2 = lam * KH[..., :, 1]
    t = lam * KH[..., :, 2]
    # keep the target in front of the camera
    sign = torch.where(t[..., 2:3] < 0, -torch.ones_like(lam), torch.ones_like(lam))
    r1, r2, t = r1 * sign, r2 * sign, t * sign
    r3 = torch.linalg.cross(r1, r2)
    R = torch.stack([r1, r2, r3], -1)
    # nearest rotation via SVD
    U, _, Vt = torch.linalg.svd(R)
    R = U @ Vt
    R = R * torch.sign(torch.linalg.det(R))[..., None, None]
    return _m.inv_rodrigues(R), t


class CalibrationResult(NamedTuple):
    rms: torch.Tensor
    K: torch.Tensor
    dist: torch.Tensor  # (n_dist,)
    rvecs: torch.Tensor  # (V, 3)
    tvecs: torch.Tensor  # (V, 3)
    per_view_errors: torch.Tensor  # (V,) mean L2 px


def _pack(K, dist, rvecs, tvecs):
    return torch.cat([torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).to(dist.dtype),
                      dist, rvecs.reshape(-1), tvecs.reshape(-1)])


def _unpack(x, n_dist, n_views):
    fx, fy, cx, cy = x[0], x[1], x[2], x[3]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    K = _mat3([[fx, zero, cx], [zero, fy, cy], [zero, zero, one]])
    dist = x[4:4 + n_dist]
    r0 = 4 + n_dist
    rvecs = x[r0:r0 + 3 * n_views].reshape(n_views, 3)
    tvecs = x[r0 + 3 * n_views:].reshape(n_views, 3)
    return K, dist, rvecs, tvecs


def calibrate_camera(
    obj_points: torch.Tensor,
    img_points: torch.Tensor,
    image_size: Tuple[int, int],
    n_dist: int = 5,
    fix_principal_point: bool = False,
    fix_aspect_ratio: bool = False,
    zero_tangent_dist: bool = False,
    max_iterations: int = 60,
    K0: Optional[torch.Tensor] = None,
    dist0: Optional[torch.Tensor] = None,
    device=None,
) -> CalibrationResult:
    """cv2.calibrateCamera equivalent for planar targets.

    obj_points: (V, N, 3) with z == 0 (chessboard frame)
    img_points: (V, N, 2) detected corners, in the dtype the computation
    takes; it runs on `device` (default: the points' device, the card for
    numpy)
    image_size: (width, height): used only for the principal-point guess.
    """
    dev = _m._device_of(img_points, obj_points, device=device)
    img_points = torch.as_tensor(img_points).to(dev)
    obj_points = torch.as_tensor(obj_points).to(dev)
    dtype = img_points.dtype
    V = img_points.shape[0]

    Hs = find_homography_dlt(obj_points[..., :2], img_points)
    if K0 is None:
        K = _zhang_intrinsics(Hs)
        # fall back to a centered guess if Zhang is degenerate (few views)
        w, h = image_size
        bad = ~torch.isfinite(K).all() | (K[0, 0] <= 0)
        full = lambda v: torch.full((), v, dtype=dtype, device=dev)  # noqa: E731
        K_guess = _mat3([[full(0.9 * w), full(0.0), full((w - 1) / 2.0)],
                         [full(0.0), full(0.9 * w), full((h - 1) / 2.0)],
                         [full(0.0), full(0.0), full(1.0)]])
        K = torch.where(bad, K_guess, K)
    else:
        K = torch.as_tensor(K0).to(dtype=dtype, device=dev)

    rvecs, tvecs = _extrinsics_from_homography(Hs, K)
    dist = (torch.zeros((n_dist,), dtype=dtype, device=dev) if dist0 is None
            else torch.as_tensor(dist0).to(dtype=dtype, device=dev).reshape(-1)[:n_dist])

    x0 = _pack(K, dist, rvecs, tvecs)

    def residual(x):
        K_, d_, rv_, tv_ = _unpack(x, n_dist, V)
        return (_m.project_points(obj_points, rv_, tv_, K_, d_) - img_points).reshape(-1)

    mask = torch.ones(x0.shape[0], dtype=torch.bool, device=dev)
    if fix_principal_point:
        mask[2:4] = False
    if fix_aspect_ratio:
        mask[1] = False  # fy stays at its initial value, as in the JAX package
    if zero_tangent_dist and n_dist >= 4:
        mask[4 + 2] = False
        mask[4 + 3] = False

    res = _lm.levenberg_marquardt(residual, x0, max_iterations=max_iterations,
                                  mask=mask)
    K_f, dist_f, rv_f, tv_f = _unpack(res.x, n_dist, V)

    proj = _m.project_points(obj_points, rv_f, tv_f, K_f, dist_f)
    err = torch.linalg.norm(proj - img_points, dim=-1)  # (V, N)
    per_view = torch.mean(err, 1)
    rms = torch.sqrt(torch.mean(torch.sum((proj - img_points) ** 2, -1)))
    return CalibrationResult(rms=rms, K=K_f, dist=dist_f, rvecs=rv_f, tvecs=tv_f,
                             per_view_errors=per_view)


def solve_pnp(
    obj_points: torch.Tensor,
    img_points: torch.Tensor,
    K,
    dist=None,
    iterations: int = 20,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2.solvePnP (ITERATIVE) for planar or near-planar targets.

    Initializes from the undistorted-homography decomposition, refines with
    LM on the reprojection error. Returns (rvec, tvec) on `device` (default:
    the points' device, the card for numpy).
    """
    dev = _m._device_of(img_points, obj_points, device=device)
    img_points = torch.as_tensor(img_points).to(dev)
    obj_points = torch.as_tensor(obj_points).to(dev)
    K = _m._like(K, obj_points)
    if dist is not None:
        dist = _m._like(dist, obj_points)
    norm_img = _m.undistort_points(img_points, K, dist if dist is not None else torch.zeros(
        5, dtype=img_points.dtype, device=img_points.device))
    H = find_homography_dlt(obj_points[..., :2], norm_img)
    rvec, tvec = _extrinsics_from_homography(
        H, torch.eye(3, dtype=obj_points.dtype, device=obj_points.device))

    def residual(x):
        return (_m.project_points(obj_points, x[:3], x[3:], K, dist) - img_points).reshape(-1)

    x = _lm.levenberg_marquardt(residual, torch.cat([rvec, tvec]), max_iterations=iterations).x
    return x[:3], x[3:]
