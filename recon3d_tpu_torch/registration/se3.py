"""SE(3) Lie group utilities: exp / log maps, composition, twists (twin of
recon3d_tpu/registration/se3.py).

The registration and pose-graph solvers optimize over 6-vector twists
xi = [rho, phi] with T = exp(xi^). Every sqrt / arctan at the origin is
guarded with the "safe input + where" pattern, so forward-mode Jacobians
(torch.func.jacfwd) through exp / log at the identity, exactly where
Gauss-Newton linearizes, are finite. Nothing writes into a tensor in place,
so the functions run under torch.func transforms.
"""
from __future__ import annotations

import torch

from recon3d_tpu_torch.ops.image import matmul3

_EPS2 = 1e-12


def _safe_sqrt(x2: torch.Tensor):
    """sqrt with a finite tangent at 0: returns (sqrt, is_small)."""
    small = x2 < _EPS2
    return torch.where(small, 0.0, torch.sqrt(torch.where(small, 1.0, x2))), small


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(phi[..., 0])
    return torch.stack([
        torch.stack([zeros, -phi[..., 2], phi[..., 1]], -1),
        torch.stack([phi[..., 2], zeros, -phi[..., 0]], -1),
        torch.stack([-phi[..., 1], phi[..., 0], zeros], -1),
    ], -2)


def _exp_coeffs(phi: torch.Tensor):
    """(theta2, A, B, C) for exp: A = sin/t, B = (1 - cos)/t^2, C = (t - sin)/t^3,
    their Taylor series below theta^2 = 1e-12."""
    t2 = torch.sum(phi * phi, dim=-1)
    theta, small = _safe_sqrt(t2)
    ts = torch.where(small, 1.0, theta)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / ts)
    B = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, 1.0, t2))
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta)) / torch.where(small, 1.0, t2 * ts))
    return t2, A, B, C


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues exp: (..., 3) -> (..., 3, 3), Taylor-safe near zero."""
    _, A, B, _ = _exp_coeffs(phi)
    K = hat(phi)
    K2 = K @ K
    return _eye3(K) + A[..., None, None] * K + B[..., None, None] * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map: (..., 3, 3) -> (..., 3). Differentiable at identity; near
    pi (2 cos(theta) < -1.9999) the axis comes from the diagonal of
    (R + I) / 2 with the signs of the skew part."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)  # = 2 sin(theta) * axis
    v2 = torch.sum(v * v, dim=-1)
    sin2t, small = _safe_sqrt(v2)  # 2 sin(theta)
    cos2t = tr - 1.0  # 2 cos(theta)
    theta = torch.atan2(sin2t, cos2t)  # [0, pi), finite grads
    # scale = theta / (2 sin theta); Taylor 0.5 + theta^2 / 12 near 0
    generic = theta / torch.where(small, 1.0, sin2t)
    scale = torch.where(small, 0.5 + theta * theta / 12.0, generic)
    out = v * scale[..., None]
    near_pi = cos2t < -1.9999
    B = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], -1)
    axis = torch.sqrt(torch.clamp(diag, min=1e-12))
    axis = axis * torch.where(v >= 0, 1.0, -1.0)
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-12)
    out_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], out_pi, out)


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4) [[R, t], [0, 0, 0, 1]]."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(*R.shape[:-2], 1, 4)
    return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [rho, phi] -> homogeneous transform (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    _, A, B, C = _exp_coeffs(phi)
    K = hat(phi)
    K2 = K @ K
    eye = _eye3(K)
    R = eye + A[..., None, None] * K + B[..., None, None] * K2
    V = eye + B[..., None, None] * K + C[..., None, None] * K2
    t = (V @ rho[..., None])[..., 0]
    return _homogeneous(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Transform (..., 4, 4) -> twist (..., 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    t2 = torch.sum(phi * phi, dim=-1)
    theta, small = _safe_sqrt(t2)
    K = hat(phi)
    K2 = K @ K
    # V^{-1} = I - K / 2 + coef K^2, coef = 1 / t^2 - (1 + cos) / (2 t sin)
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    denom = torch.where(small, 1.0, 2.0 * theta * sin_t)
    coef = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                       1.0 / torch.where(small, 1.0, t2) - (1.0 + cos_t) / denom)
    Vinv = _eye3(K) - 0.5 * K + coef[..., None, None] * K2
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    return Ta @ Tb


def inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return _homogeneous(Rt, -(Rt @ t[..., None])[..., 0])


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (4, 4) to (..., 3), the rotation as the JAX package's product
    rounds it (ops/image.py:matmul3)."""
    return matmul3(pts, T[:3, :3]) + T[:3, 3]
