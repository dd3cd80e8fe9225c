"""Two-pass rectification warp (twin of recon3d_tpu/ops/warp.py).

cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) as two 1-D resampling passes
over a plan built on the host: a vertical pass samples the source at
plan.vy, a horizontal pass samples that result at plan.hx, and plan.valid
zeroes the pixels whose sample leaves the source. Each pass shifts every
line by a per-line integer (`coarse`) and then interpolates the residual,
exactly as the JAX package's passes do (with the fused multiply-add XLA
forms for the interpolation), so both warps agree bitwise.

`remap_two_pass` is the plain version: the JAX package's roll ladder and
plane sweep in PyTorch. `remap_two_pass_cuda` is the kernel path: K1
(csrc/warp_resample.cu) runs both passes in one launch for CUDA tensors;
CPU tensors take the plain version. `resample_pass` is one pass alone, on
its own kernel in the same source.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from recon3d_tpu_torch import kernels
from recon3d_tpu_torch.ops.image import fma


@dataclasses.dataclass(frozen=True)
class RemapPlan:
    """Precomputed two-pass warp for one (map_x, map_y) pair.

    vy (H, W) f32 vertical sample row of each intermediate pixel, hx (H, W)
    f32 horizontal sample column of each output pixel, valid (H, W) bool;
    v_coarse (W,) / h_coarse (H,) int32 per-line coarse shifts; the bounds
    of the residual shifts and the bit counts of the coarse ones.
    """

    vy: torch.Tensor
    hx: torch.Tensor
    valid: torch.Tensor
    v_coarse: torch.Tensor
    h_coarse: torch.Tensor
    v_resid_bound: int
    h_resid_bound: int
    v_coarse_bits: int
    h_coarse_bits: int


def build_remap_plan(map_x: np.ndarray, map_y: np.ndarray, device="cuda") -> RemapPlan:
    """Host-side plan construction from cv2-style float maps (H, W), with
    the plan's tensors on `device`.

    Requires map_x to be strictly increasing along each row (true for
    undistort+rectify maps). Out-of-source samples are marked invalid.
    """
    map_x = np.asarray(map_x, np.float64)
    map_y = np.asarray(map_y, np.float64)
    H, W = map_x.shape
    xs = np.arange(W, dtype=np.float64)

    # intermediate vertical map: myv(x, y') = my(mx^-1(x; y'), y')
    myv = np.empty((H, W), np.float64)
    inv_ok = np.empty((H, W), bool)
    for y in range(H):
        mx_row = map_x[y]
        if not np.all(np.diff(mx_row) > 0):
            raise ValueError(
                "map_x must be strictly increasing along rows for the "
                "two-pass decomposition; use ops.image.remap instead")
        myv[y] = np.interp(xs, mx_row, map_y[y])
        inv_ok[y] = (xs >= mx_row[0]) & (xs <= mx_row[-1])

    ys = np.arange(H, dtype=np.float64)[:, None]
    v_shift = myv - ys  # vertical displacement at intermediate pixels
    v_coarse = np.round(np.median(v_shift, axis=0)).astype(np.int64)  # (W,)
    v_resid = v_shift - v_coarse[None, :]
    h_shift = map_x - xs[None, :]
    h_coarse = np.round(np.median(h_shift, axis=1)).astype(np.int64)  # (H,)
    h_resid = h_shift - h_coarse[:, None]

    def bits_for(c):
        m = int(np.max(np.abs(c))) if c.size else 0
        return max(m, 1).bit_length()

    valid = (inv_ok
             & (myv >= 0) & (myv <= H - 1)
             & (map_x >= 0) & (map_x <= W - 1)
             & (map_y >= 0) & (map_y <= H - 1))
    return RemapPlan(
        vy=torch.as_tensor(myv.astype(np.float32), device=device),
        hx=torch.as_tensor(map_x.astype(np.float32), device=device),
        valid=torch.as_tensor(valid, device=device),
        v_coarse=torch.as_tensor(v_coarse.astype(np.int32), device=device),
        h_coarse=torch.as_tensor(h_coarse.astype(np.int32), device=device),
        v_resid_bound=int(np.ceil(np.max(np.abs(v_resid)))) + 1,
        h_resid_bound=int(np.ceil(np.max(np.abs(h_resid)))) + 1,
        v_coarse_bits=bits_for(v_coarse),
        h_coarse_bits=bits_for(h_coarse),
    )


def _coarse_shift(img: torch.Tensor, amount: torch.Tensor, axis: int, bits: int) -> torch.Tensor:
    """img shifted along `axis` by per-line integer `amount` (constant along
    the shift axis): out[i] = img[i + amount], wrapping. Log-composed masked
    rolls, exact because every element on a roll line moves by the same total."""
    amt2d = (amount[None, :] if axis == 0 else amount[:, None]).expand(img.shape)
    mag = amt2d.abs()
    pos = amt2d > 0
    out = img
    for b in (1 << k for k in range(bits)):
        fwd = torch.roll(out, -b, axis)
        bwd = torch.roll(out, b, axis)
        out = torch.where((mag & b) != 0, torch.where(pos, fwd, bwd), out)
    return out


def _resample_axis(img: torch.Tensor, coord: torch.Tensor, coarse: torch.Tensor, bits: int,
                   resid_bound: int, axis: int) -> torch.Tensor:
    """Sample img along `axis` at float positions `coord` (img's shape):
    out[p] = linear_interp(img, coord[p]) along axis, after the per-line
    integer preshift `coarse`."""
    n = img.shape[axis]
    idx = torch.arange(n, dtype=torch.float32, device=img.device)
    idx = idx[:, None] if axis == 0 else idx[None, :]
    coarse_f = (coarse[None, :] if axis == 0 else coarse[:, None]).to(torch.float32)
    base = _coarse_shift(img, coarse, axis, bits)
    resid = coord - idx - coarse_f
    rf = torch.floor(resid)
    frac = resid - rf
    rfi = rf.to(torch.int32)
    acc0 = torch.zeros_like(img)
    acc1 = torch.zeros_like(img)
    for s in range(-resid_bound, resid_bound + 2):
        plane = torch.roll(base, -s, axis)
        acc0 = torch.where(rfi == s, plane, acc0)
        acc1 = torch.where(rfi == s - 1, plane, acc1)
    # (1 - frac) * acc0 + frac * acc1, with the first product fused into
    # the sum as XLA contracts it
    return fma(1.0 - frac, acc0, frac * acc1)


def resample_pass_plain(src: torch.Tensor, coord: torch.Tensor, coarse: torch.Tensor, bits: int,
                        resid_bound: int, axis: int,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K1: one pass, masked by `valid` if given."""
    out = _resample_axis(src, coord, coarse, bits, resid_bound, axis)
    return out if valid is None else torch.where(valid, out, 0.0)


def remap_two_pass(src: torch.Tensor, plan: RemapPlan) -> torch.Tensor:
    """Plain version: cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) via the
    two-pass plan. src (H, W); returns (H, W) float32, zero where the map
    leaves the source image."""
    t = resample_pass_plain(src.to(torch.float32), plan.vy, plan.v_coarse, plan.v_coarse_bits,
                            plan.v_resid_bound, 0)
    return resample_pass_plain(t, plan.hx, plan.h_coarse, plan.h_coarse_bits,
                               plan.h_resid_bound, 1, plan.valid)


def remap_two_pass_batch(srcs: torch.Tensor, plan: RemapPlan) -> torch.Tensor:
    """(B, H, W) through one plan, one image at a time (the JAX package's
    vmap of remap_two_pass)."""
    return torch.stack([remap_two_pass(s, plan) for s in srcs])


def resample_pass(src: torch.Tensor, coord: torch.Tensor, coarse: torch.Tensor, bits: int,
                  resid_bound: int, axis: int, valid: torch.Tensor | None = None) -> torch.Tensor:
    """K1's one-pass form: one 1-D resampling pass along `axis` (0:
    per-column shifts coarse (W,), 1: per-row shifts (H,)), zero where
    `valid` is False. src and coord (H, W) f32; any (H, W), no alignment
    needed. `bits` only sizes the plain version's roll ladder."""
    if src.ndim != 2 or coord.shape != src.shape or axis not in (0, 1):
        raise ValueError(f"resample_pass takes (H, W) src and coord and axis 0 or 1, got "
                         f"{tuple(src.shape)}, {tuple(coord.shape)}, {axis}")
    if coarse.shape != (src.shape[1 - axis],) or (valid is not None and (
            valid.shape != src.shape or valid.dtype != torch.bool)):
        raise ValueError("coarse must hold one shift a line, valid be a bool mask like src")
    tensors = (src, coord, coarse) + (() if valid is None else (valid,))
    if not kernels.use_kernel(*tensors):
        return resample_pass_plain(src, coord, coarse, bits, resid_bound, axis, valid)
    g = src.to(torch.float32).contiguous()
    coord = coord.to(torch.float32).contiguous()
    coarse = coarse.to(torch.int32).contiguous()
    mask = None if valid is None else valid.contiguous().view(torch.uint8)
    out = torch.empty_like(g)
    H, W = g.shape
    kernels.launch("r3d_resample", g.device, kernels.ptr(g), kernels.ptr(coord),
                   kernels.ptr(coarse), None if mask is None else kernels.ptr(mask),
                   kernels.ptr(out), H, W, axis, resid_bound)
    resample_pass.launches += 1
    return out


resample_pass.launches = 0


def remap_two_pass_cuda(src: torch.Tensor, plan: RemapPlan) -> torch.Tensor:
    """The kernel path of remap_two_pass: K1's fused kernel, both passes and
    plan.valid in one launch for CUDA tensors (the intermediate never
    reaches device memory); the plain version for CPU tensors. The plan's
    tensors are used as build_remap_plan made them (typed, contiguous)."""
    if src.shape != plan.vy.shape:
        raise ValueError(f"remap_two_pass takes an (H, W) image of the plan's shape "
                         f"{tuple(plan.vy.shape)}, got {tuple(src.shape)}")
    if not kernels.use_kernel(src, plan.vy):
        return remap_two_pass(src, plan)
    typed = ((plan.vy, torch.float32), (plan.hx, torch.float32), (plan.valid, torch.bool),
             (plan.v_coarse, torch.int32), (plan.h_coarse, torch.int32))
    if any(a.device != src.device or a.dtype != t or not a.is_contiguous() for a, t in typed):
        raise ValueError("the plan's tensors must be contiguous, on the image's device and "
                         "typed as build_remap_plan makes them")
    if src.dtype != torch.float32 or not src.is_contiguous():
        src = src.to(torch.float32).contiguous()
    out = torch.empty(src.shape, dtype=torch.float32, device=src.device)
    H, W = src.shape
    kernels.launch("r3d_remap_two_pass", src.device, src.data_ptr(), plan.vy.data_ptr(),
                   plan.hx.data_ptr(), plan.v_coarse.data_ptr(), plan.h_coarse.data_ptr(),
                   plan.valid.data_ptr(), out.data_ptr(), H, W, plan.v_resid_bound,
                   plan.h_resid_bound)
    remap_two_pass_cuda.launches += 1
    return out


remap_two_pass_cuda.launches = 0
