"""Generic Levenberg-Marquardt solver (twin of recon3d_tpu/calib/lm.py).

Solves min_x ||r(x)||^2 with damped normal equations
    (J^T J + lam * diag(J^T J)) dx = -J^T r
accepting steps that reduce the cost (lam /= down) and rejecting otherwise
(lam *= up). Jacobians come from `torch.func.jacfwd`, so the same solver
drives mono calibration, stereo calibration and PnP. The JAX package's
`lax.while_loop`s are Python loops here that read their stop tests on the
host: one read of the cost a damping try (its comparisons in float64).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LMResult(NamedTuple):
    x: torch.Tensor
    cost: torch.Tensor  # final 0.5*||r||^2
    rms: torch.Tensor  # sqrt(mean residual^2)
    iterations: int
    lam: torch.Tensor


def levenberg_marquardt(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iterations: int = 50,
    lam0: float = 1e-3,
    lam_up: float = 10.0,
    lam_down: float = 10.0,
    lam_max: float = 1e10,
    rtol: float = 1e-12,
    mask=None,
) -> LMResult:
    """Minimize ||residual_fn(x)||^2 from x0.

    mask: optional boolean (len(x),): False entries are frozen at x0
    (OpenCV's CALIB_FIX_* flags, generically). lam is a 0-d host tensor of
    x's dtype, so its products and quotients round as the JAX package's.
    """
    x = torch.as_tensor(x0)
    n = x.shape[0]
    free = (torch.ones(n, dtype=torch.bool, device=x.device) if mask is None
            else torch.as_tensor(mask, device=x.device))
    freef = free.to(x.dtype)
    frozen_eye = torch.diag((~free).to(x.dtype))
    jac = torch.func.jacfwd(residual_fn)

    def cost_of(x):
        r = residual_fn(x)
        return 0.5 * torch.sum(r * r)

    cost = cost_of(x)
    cost_h = float(cost)
    lam = torch.tensor(lam0, dtype=x.dtype)
    it = 0
    while it < max_iterations:
        r = residual_fn(x)
        J = jac(x) * freef[None, :]
        JtJ = J.T @ J
        g = J.T @ r
        diag = torch.diagonal(JtJ)
        # keep the system invertible for frozen params
        diag = torch.where(diag <= 0, torch.ones_like(diag), diag)

        def try_lam(lam_i):
            A = JtJ + lam_i * torch.diag(diag) + frozen_eye
            dx = -torch.linalg.solve_ex(A, g)[0] * freef
            new_cost = cost_of(x + dx)
            return dx, new_cost, float(new_cost)

        # inner damping search: up to 8 lambda increases in one sweep
        lam1 = lam
        dx, new_cost, new_h = try_lam(lam1)
        tries = 0
        while new_h >= cost_h and tries < 8 and float(lam1) < lam_max:
            lam1 = lam1 * lam_up
            dx, new_cost, new_h = try_lam(lam1)
            tries += 1

        it += 1
        if new_h < cost_h:
            rel = abs(cost_h - new_h) / max(cost_h, 1e-30)
            x, cost, cost_h = x + dx, new_cost, new_h
            lam = torch.clamp(lam1 / lam_down, min=1e-12)
            if rel < rtol:
                break
        else:
            lam = lam1
            if float(lam1) >= lam_max:
                break
    r = residual_fn(x)
    rms = torch.sqrt(torch.mean(r * r))
    return LMResult(x=x, cost=cost, rms=rms, iterations=it, lam=lam)


def gauss_newton(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    iterations: int = 10,
    damping: float = 1e-9,
) -> torch.Tensor:
    """Plain Gauss-Newton with a fixed iteration count (no host read)."""
    x = torch.as_tensor(x0)
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    jac = torch.func.jacfwd(residual_fn)
    for _ in range(iterations):
        r = residual_fn(x)
        J = jac(x)
        JtJ = J.T @ J + damping * eye
        x = x - torch.linalg.solve_ex(JtJ, J.T @ r)[0]
    return x
