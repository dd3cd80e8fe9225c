"""Kernel path of the Fast Global Smoother (twin of recon3d_tpu/depth/wls_pallas.py).

Same algorithm and lambda schedule as depth/wls.py; each 1-D Thomas solve
is one launch of kernel K6 (csrc/wls_tridiag.cu) through `tridiag_solve`,
which runs its plain PyTorch version for CPU tensors. The TPU transposed the
planes for the horizontal solves; here the kernel solves along either axis
in place: one warp solves 32 lines (rows for axis=1, columns for axis=0),
one a lane, from tiles that seven more warps stage through shared memory.
Kernel and plain version agree bitwise.
"""
from __future__ import annotations

import torch

from recon3d_tpu_torch import kernels
from recon3d_tpu_torch.depth.wls import _edge_weights, lambda_schedule


def tridiag_solve_plain(wl, wr, diag, rhs, axis: int = 0) -> torch.Tensor:
    """Plain version of K6 on any device: the Thomas solve along `axis` of
    (n, m) planes with the kernel's arithmetic (inv = 1 / denom,
    cp = -wr * inv, dp = (rhs + wl * dp) * inv)."""
    n = rhs.shape[axis]
    cp = torch.empty_like(rhs)
    dp = torch.empty_like(rhs)
    out = torch.empty_like(rhs)
    cp_prev = torch.zeros_like(rhs.select(axis, 0))
    dp_prev = torch.zeros_like(cp_prev)
    for i in range(n):
        wl_i = wl.select(axis, i)
        denom = diag.select(axis, i) + wl_i * cp_prev
        denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
        inv = 1.0 / denom
        cp_prev = -wr.select(axis, i) * inv
        dp_prev = (rhs.select(axis, i) + wl_i * dp_prev) * inv
        cp.select(axis, i).copy_(cp_prev)
        dp.select(axis, i).copy_(dp_prev)
    u = torch.zeros_like(cp_prev)
    for i in range(n - 1, -1, -1):
        u = dp.select(axis, i) - cp.select(axis, i) * u
        out.select(axis, i).copy_(u)
    return out


def tridiag_solve(wl: torch.Tensor, wr: torch.Tensor, diag: torch.Tensor, rhs: torch.Tensor,
                  axis: int = 0) -> torch.Tensor:
    """K6: solve -wl[i] u[i-1] + diag[i] u[i] - wr[i] u[i+1] = rhs[i] along
    `axis` of (n, m) f32 planes (wl = 0 at the first, wr = 0 at the last
    index of each system)."""
    if axis not in (0, 1) or rhs.ndim != 2 or any(t.shape != rhs.shape for t in (wl, wr, diag)):
        raise ValueError("tridiag_solve takes four (n, m) planes of one shape and axis 0 or 1")
    planes = [t.to(torch.float32).contiguous() for t in (wl, wr, diag, rhs)]
    if not kernels.use_kernel(*planes):
        return tridiag_solve_plain(*planes, axis)
    n, m = rhs.shape
    out, cp, dp = (torch.empty_like(planes[3]) for _ in range(3))
    kernels.launch("r3d_tridiag", rhs.device, *map(kernels.ptr, planes), kernels.ptr(out),
                   kernels.ptr(cp), kernels.ptr(dp), n, m, axis)
    tridiag_solve.launches += 1
    return out


tridiag_solve.launches = 0


def solve_planes(w_edge: torch.Tensor, conf: torch.Tensor, u: torch.Tensor, lt: float,
                 axis: int):
    """(wl, wr, diag, rhs) of one WLS solve along `axis`; w_edge[i] is the
    guide weight of the edge between index i-1 and i (0 at i = 0)."""
    wl = w_edge * lt
    wr = torch.cat([w_edge.narrow(axis, 1, w_edge.shape[axis] - 1),
                    torch.zeros_like(w_edge.narrow(axis, 0, 1))], axis) * lt
    return wl, wr, conf + wl + wr, conf * u


def _solve(w_edge: torch.Tensor, conf: torch.Tensor, u: torch.Tensor, lt: float,
           axis: int) -> torch.Tensor:
    return tridiag_solve(*solve_planes(w_edge, conf, u, lt, axis), axis)


def fast_global_smoother_cuda(data: torch.Tensor, guide: torch.Tensor,
                              confidence: torch.Tensor, lam: float = 8000.0,
                              sigma_color: float = 1.5, iterations: int = 3) -> torch.Tensor:
    """Twin of wls.fast_global_smoother on kernel K6 (same lambda schedule):
    per sweep a horizontal then a vertical solve."""
    u = data.to(torch.float32)
    conf = confidence.to(torch.float32)
    wx = _edge_weights(guide, 1, sigma_color)
    wy = _edge_weights(guide, 0, sigma_color)
    for lt in lambda_schedule(lam, iterations):
        u = _solve(wx, conf, u, lt, axis=1)
        u = _solve(wy, conf, u, lt, axis=0)
    return u


def wls_refine_cuda(disparity: torch.Tensor, valid: torch.Tensor, guide_gray: torch.Tensor,
                    lam: float = 8000.0, sigma_color: float = 1.5, iterations: int = 3,
                    lrc_conf: torch.Tensor | None = None) -> torch.Tensor:
    """Twin of wls.wls_refine on kernel K6."""
    conf = valid.to(torch.float32)
    if lrc_conf is not None:
        conf = conf * lrc_conf.to(torch.float32)
    d = torch.where(valid, disparity, 0.0)
    return fast_global_smoother_cuda(d, guide_gray, conf, lam, sigma_color, iterations)
