"""Confidence-weighted Fast Global Smoother (WLS) refine, plain PyTorch oracle
(twin of recon3d_tpu/depth/wls.py).

T sweeps of alternating horizontal / vertical 1-D weighted-least-squares
solves with guide-edge weights w = exp(-|dI| / sigma_color) and per-sweep
lambda_t = 1.5 * lam * 4^(T-t-1) / (4^T - 1). Each 1-D solve is a
tridiagonal (Thomas) system with data confidence c on the diagonal, so
zero-confidence holes in-fill by diffusion.
"""
from __future__ import annotations

import numpy as np
import torch

# Minimum interior edge weight: keeps every pixel weakly coupled so that a
# zero-confidence pixel behind strong edges cannot make a system singular.
WEIGHT_FLOOR = 1e-6


def _edge_weights(guide: torch.Tensor, axis: int, sigma_color: float) -> torch.Tensor:
    """w[i] = weight of the edge between pixel i-1 and i along axis (w[0] = 0)."""
    g = guide.to(torch.float32)
    d = torch.diff(g, dim=axis).abs()
    if g.ndim == 3:  # color guide: L1 over channels
        d = d.sum(-1)
    w = torch.clamp(torch.exp(-d / float(np.float32(sigma_color))), min=WEIGHT_FLOOR)
    pad = [0, 0, 0, 0]
    pad[2 * (1 - axis) + 0] = 1  # F.pad order: last dim first, (before, after)
    return torch.nn.functional.pad(w, pad)


def _tridiag_solve_lastaxis(wl: torch.Tensor, wr: torch.Tensor, diag: torch.Tensor,
                            rhs: torch.Tensor) -> torch.Tensor:
    """Thomas algorithm along the last axis, batched over leading axes.

    System per row: -wl[i] u[i-1] + diag[i] u[i] - wr[i] u[i+1] = rhs[i],
    with wl[0] = wr[-1] = 0.
    """
    a, c = -wl, -wr
    T = rhs.shape[-1]
    cps = torch.empty_like(rhs)
    dps = torch.empty_like(rhs)
    cp_prev = torch.zeros_like(rhs[..., 0])
    dp_prev = torch.zeros_like(rhs[..., 0])
    for i in range(T):
        denom = diag[..., i] - a[..., i] * cp_prev
        denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
        cp_prev = c[..., i] / denom
        dp_prev = (rhs[..., i] - a[..., i] * dp_prev) / denom
        cps[..., i] = cp_prev
        dps[..., i] = dp_prev
    us = torch.empty_like(rhs)
    u = torch.zeros_like(rhs[..., 0])
    for i in range(T - 1, -1, -1):
        u = dps[..., i] - cps[..., i] * u
        us[..., i] = u
    return us


def lambda_schedule(lam: float, iterations: int):
    """Per-sweep lambda_t as f32 values, the JAX package's f32(lam) * w_t."""
    denom4 = float(4 ** iterations - 1)
    return [float(np.float32(lam) * np.float32(1.5 * float(4 ** (iterations - t - 1)) / denom4))
            for t in range(iterations)]


def fast_global_smoother(data: torch.Tensor, guide: torch.Tensor, confidence: torch.Tensor,
                         lam: float = 8000.0, sigma_color: float = 1.5,
                         iterations: int = 3) -> torch.Tensor:
    """Edge-aware WLS smoothing of `data` guided by `guide` ((H, W) or
    (H, W, 3), 0..255 units), confidence (H, W) in [0, 1]."""
    u = data.to(torch.float32)
    conf = confidence.to(torch.float32)
    wx = _edge_weights(guide, 1, sigma_color)
    wy = _edge_weights(guide, 0, sigma_color)
    zcol = torch.zeros_like(wx[:, :1])
    zrow = torch.zeros_like(wy[:1, :])
    for lt in lambda_schedule(lam, iterations):
        wl = wx * lt
        wr = torch.cat([wx[:, 1:], zcol], 1) * lt
        u = _tridiag_solve_lastaxis(wl, wr, conf + wl + wr, conf * u)
        wlv = (wy * lt).T
        wrv = torch.cat([wy[1:, :], zrow], 0).T * lt
        u = _tridiag_solve_lastaxis(wlv, wrv, conf.T + wlv + wrv, (conf * u).T).T
    return u


def wls_refine(disparity: torch.Tensor, valid: torch.Tensor, guide_gray: torch.Tensor,
               lam: float = 8000.0, sigma_color: float = 1.5, iterations: int = 3,
               lrc_conf: torch.Tensor | None = None) -> torch.Tensor:
    """Disparity post-filter: confidence from the validity mask (times an
    optional LR-consistency confidence), smoothed by the FGS. Returns a
    dense, hole-filled disparity."""
    conf = valid.to(torch.float32)
    if lrc_conf is not None:
        conf = conf * lrc_conf.to(torch.float32)
    d = torch.where(valid, disparity, 0.0)
    return fast_global_smoother(d, guide_gray, conf, lam, sigma_color, iterations)
