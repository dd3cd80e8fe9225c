"""Kernel path of semi-global matching (twin of recon3d_tpu/depth/sgm_pallas.py).

Three kernel wrappers carry the frame, each with its plain PyTorch version
beside it and a launch counter:

  cost_fwd_down     K2  csrc/sgm_cost.cu       cost volume + L_fwd (+ L_down)
  bwd_accumulate    K3  csrc/sgm_bwd.cu        v3 = v1 + L_bwd, in place
  vfinalize         K4  csrc/sgm_vfinalize.cu  S = v3 + L_up, WTA, LR check

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors. The padding conventions are sgm_pallas.py's
(sgm_pallas.py:1166-1245): H padded to a multiple of 64, W and D to 128;
INVALID_COST on out-of-range windows and padded disparity lanes; zero cost
on padded rows and columns, so the reverse scans enter the image with the
zero carry an unpadded scan starts from.

All arithmetic is integer-valued f32: costs are x2-scaled Birchfield-Tomasi
sums of 8-bit gray levels, and path sums stay below 2^24, so kernel and
plain version agree bitwise on cost, v1 and v3. The 16-bit cost volume is
held in torch.int16 (all values are at most 12800).
"""
from __future__ import annotations

from typing import Tuple

import torch

from recon3d_tpu_torch import kernels
from recon3d_tpu_torch.depth import cost as _cost
from recon3d_tpu_torch.depth import sgm as _sgm

# Cost of a box window touching an out-of-range sample, in x2 units: above
# any real cost (<= 2 * 126 * 25 = 6300), small enough that 4-direction
# path sums stay below 65536.
INVALID_COST = 12800.0
_PATH_EDGE = 65535.0  # sgm_pallas._BIG


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def padded_shape(h: int, w: int, num_disparities: int) -> Tuple[int, int, int]:
    """(HP, WP, DP) of the padded volumes for an (h, w) image."""
    return _ceil_to(h, 64), _ceil_to(w, 128), _ceil_to(num_disparities, 128)


def _path_step(carry: torch.Tensor, c: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """One SGM recurrence step on (M, D) planes (sgm_pallas._path_step)."""
    m = carry.min(dim=-1, keepdim=True).values
    edge = torch.full_like(carry[:, :1], _PATH_EDGE)
    dm = torch.cat([edge, carry[:, :-1]], 1)
    dp = torch.cat([carry[:, 1:], edge], 1)
    cand = torch.minimum(torch.minimum(carry, m + p2), torch.minimum(dm, dp) + p1)
    return c + cand - m


def _scan_plain(cost: torch.Tensor, acc: torch.Tensor | None, out: torch.Tensor,
                axis: int, reverse: bool, p1: float, p2: float) -> torch.Tensor:
    """One path over (HP, WP, DP) along axis 1 (horizontal) or 0 (vertical):
    out = L, or out = L + acc (out may be acc: in place)."""
    n = cost.shape[axis]
    carry = torch.zeros_like(cost.select(axis, 0), dtype=torch.float32)
    for s in (range(n - 1, -1, -1) if reverse else range(n)):
        carry = _path_step(carry, cost.select(axis, s).to(torch.float32), p1, p2)
        o = out.select(axis, s)
        o.copy_(carry if acc is None else carry + acc.select(axis, s))
    return out


def prefilter_planes(left_gray: torch.Tensor, right_gray: torch.Tensor, pre_filter_cap: int):
    """The six (H, W) planes the cost kernel reads: x-Sobel prefiltered
    values and BT lo/hi bounds of both views."""
    lpre = _cost.xsobel_prefilter(left_gray, pre_filter_cap)
    rpre = _cost.xsobel_prefilter(right_gray, pre_filter_cap)
    lo_l, hi_l = _cost._bt_bounds(lpre)
    lo_r, hi_r = _cost._bt_bounds(rpre)
    return lpre, lo_l, hi_l, rpre, lo_r, hi_r


def _cost_plain(planes, hp: int, wp: int, dp: int, num_disparities: int,
                min_disparity: int, block_size: int) -> torch.Tensor:
    """Plain version of the cost stage: padded (hp, wp, dp) int16 cost."""
    lv, llo, lhi, rv, rlo, rhi = (2.0 * p for p in planes)
    H, W = lv.shape
    x = torch.arange(W, device=lv.device)
    raw = torch.empty((H, W, num_disparities), dtype=torch.float32, device=lv.device)
    for d in range(num_disparities):
        shift = min_disparity + d
        R, Rlo, Rhi = (torch.roll(a, shift, 1) for a in (rv, rlo, rhi))
        c_ltr = torch.clamp(torch.maximum(lv - Rhi, Rlo - lv), min=0.0)
        c_rtl = torch.clamp(torch.maximum(R - lhi, llo - R), min=0.0)
        raw[:, :, d] = torch.where(x >= shift, torch.minimum(c_ltr, c_rtl), 0.0)
    box = _cost.box_aggregate(raw, block_size)
    d_idx = torch.arange(num_disparities, device=lv.device)
    invalid = x[None, :, None] < min_disparity + d_idx[None, None, :] + block_size // 2
    cost = torch.zeros((hp, wp, dp), dtype=torch.float32, device=lv.device)
    cost[:H, :W] = INVALID_COST
    cost[:H, :W, :num_disparities] = torch.where(invalid, INVALID_COST, box)
    return cost.to(torch.int16)


def cost_volume_u16(left_gray: torch.Tensor, right_gray: torch.Tensor, num_disparities: int,
                    min_disparity: int = 0, block_size: int = 5,
                    pre_filter_cap: int = 63) -> torch.Tensor:
    """x2-scaled, box-aggregated BT cost volume (H, W, D), unpadded, with
    INVALID_COST on windows that touch an out-of-range sample (int16)."""
    H, W = left_gray.shape
    planes = prefilter_planes(left_gray, right_gray, pre_filter_cap)
    return _cost_plain(planes, H, W, num_disparities, num_disparities, min_disparity,
                       block_size)


def cost_fwd_down_plain(planes, hp: int, wp: int, dp: int, num_disparities: int,
                        min_disparity: int, block_size: int, p1: float, p2: float,
                        with_down: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 on any device: (cost int16, v1 f32), padded."""
    p1x, p2x = float(p1) * 2.0, float(p2) * 2.0
    cost = _cost_plain(planes, hp, wp, dp, num_disparities, min_disparity, block_size)
    v1 = torch.empty((hp, wp, dp), dtype=torch.float32, device=cost.device)
    _scan_plain(cost, None, v1, 1, False, p1x, p2x)
    if with_down:
        _scan_plain(cost, v1, v1, 0, False, p1x, p2x)
    return cost, v1


def cost_fwd_down(left_gray: torch.Tensor, right_gray: torch.Tensor, num_disparities: int,
                  min_disparity: int, block_size: int, pre_filter_cap: int, p1: float,
                  p2: float, hp: int, wp: int, dp: int, with_down: bool = True,
                  planes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: padded cost volume (hp, wp, dp) int16 and v1 = L_fwd [+ L_down]
    (hp, wp, dp) f32. p1 / p2 are in cv2 units (scaled x2 here). planes
    (from prefilter_planes) overrides the internal prefilter."""
    if planes is None:
        planes = prefilter_planes(left_gray, right_gray, pre_filter_cap)
    planes = tuple(p.to(torch.float32).contiguous() for p in planes)
    H, W = planes[0].shape
    if hp % 64 or wp % 128 or dp not in (128, 256) or hp < H or wp < W or dp < num_disparities:
        raise ValueError(f"bad padded shape {(hp, wp, dp)} for {(H, W, num_disparities)}")
    if not kernels.use_kernel(*planes):
        return cost_fwd_down_plain(planes, hp, wp, dp, num_disparities, min_disparity,
                                   block_size, p1, p2, with_down)
    p1x, p2x = float(p1) * 2.0, float(p2) * 2.0
    dev = planes[0].device
    cost = torch.empty((hp, wp, dp), dtype=torch.int16, device=dev)
    v1 = torch.empty((hp, wp, dp), dtype=torch.float32, device=dev)
    kernels.launch("r3d_cost_fwd_down", dev, *map(kernels.ptr, planes), kernels.ptr(cost),
                   kernels.ptr(v1), H, W, hp, wp, dp, num_disparities, block_size,
                   min_disparity, p1x, p2x, int(with_down))
    cost_fwd_down.launches += 1
    return cost, v1


cost_fwd_down.launches = 0


def _check_volumes(cost_u16: torch.Tensor, v: torch.Tensor) -> None:
    """The padded volumes the scan kernels take: int16 cost and f32 path
    volume of one (HP, WP, DP) shape, HP % 64 == WP % 128 == 0, DP 128 or
    256 (num_disparities <= 256)."""
    if cost_u16.dtype != torch.int16 or v.dtype != torch.float32:
        raise ValueError(f"cost must be int16 and v float32, got {cost_u16.dtype}, {v.dtype}")
    if cost_u16.ndim != 3 or v.shape != cost_u16.shape:
        raise ValueError(f"bad volume shapes {tuple(cost_u16.shape)}, {tuple(v.shape)}")
    HP, WP, DP = cost_u16.shape
    if HP % 64 or WP % 128 or DP not in (128, 256):
        raise ValueError(f"volume shape {(HP, WP, DP)} is not padded to (64, 128, 128)")


def bwd_accumulate_plain(cost_u16: torch.Tensor, v1: torch.Tensor, p1: float,
                         p2: float) -> torch.Tensor:
    """Plain version of K3 on any device (in place on v1, like the kernel)."""
    return _scan_plain(cost_u16, v1, v1, 1, True, float(p1) * 2.0, float(p2) * 2.0)


def bwd_accumulate(cost_u16: torch.Tensor, v1: torch.Tensor, p1: float,
                   p2: float) -> torch.Tensor:
    """K3: v3 = v1 + L_bwd (right-to-left path), written over v1 and
    returned. p1 / p2 in cv2 units."""
    _check_volumes(cost_u16, v1)
    if not kernels.use_kernel(cost_u16, v1):
        return bwd_accumulate_plain(cost_u16, v1, p1, p2)
    p1x, p2x = float(p1) * 2.0, float(p2) * 2.0
    HP, WP, DP = cost_u16.shape
    kernels.launch("r3d_bwd_accumulate", cost_u16.device, kernels.ptr(cost_u16),
                   kernels.ptr(v1), HP, WP, DP, p1x, p2x)
    bwd_accumulate.launches += 1
    return v1


bwd_accumulate.launches = 0


def _finalize_plain(S: torch.Tensor, d_real: int, w_real: int, uniqueness_ratio: int,
                    disp12_max_diff: int, do_subpixel: bool):
    """WTA + subpixel + uniqueness + right-view WTA + LR check on a whole
    (HP, WP, DP) aggregate S, with sgm_pallas._finalize_body's arithmetic:
    cost * PK + lane packs the minimum and its smallest argmin into one f32
    (exact: every packed value stays below 2^24)."""
    HP, WP, DP = S.shape
    dev = S.device
    PK = float(1 << max(DP - 1, 1).bit_length())
    BIGP = 2.0 ** 24
    lane = torch.arange(DP, device=dev)
    lanef = lane.to(torch.float32)
    xcol = torch.arange(WP, device=dev)[None, :]

    S = torch.clamp(S, max=BIGP / PK - 1.0)
    P = S * PK + lanef
    mp = P.min(dim=-1).values
    d0f = mp - torch.floor(mp / PK) * PK
    best = (mp - d0f) * (1.0 / PK)
    d0 = d0f.to(torch.int64)

    if do_subpixel:
        d0c = torch.clamp(d0, 1, d_real - 2)
        cm = torch.gather(S, -1, (d0c - 1)[..., None])[..., 0]
        cp = torch.gather(S, -1, (d0c + 1)[..., None])[..., 0]
        denom = torch.clamp(cm + cp - 2.0 * best, min=1e-6)
        delta = torch.clamp((cm - cp) / (2.0 * denom), -0.5, 0.5)
        refined = d0c.to(torch.float32) + delta
        disp = torch.where((d0 >= 1) & (d0 <= d_real - 2), refined, d0f)
    else:
        disp = d0f

    valid = xcol >= d0
    if uniqueness_ratio > 0:
        adjacent = (lane - d0[..., None]).abs() <= 1
        ms = torch.where(adjacent, BIGP, P).min(dim=-1).values
        second = torch.floor(ms * (1.0 / PK))
        valid = valid & (second * 100.0 > best * (100.0 + uniqueness_ratio))

    if disp12_max_diff >= 0:
        # right-view WTA: T(x, d) = P(x + d, d) for x + d < w_real
        T = torch.full_like(P, BIGP)
        for d in range(DP):
            n = max(min(w_real - d, WP), 0)
            T[:, :n, d] = P[:, d:d + n, d]
        mr = T.min(dim=-1).values
        dR = mr - torch.floor(mr / PK) * PK
        G = torch.gather(dR, 1, torch.clamp(xcol - d0, min=0))
        valid = valid & ((d0f - G).abs() <= disp12_max_diff)
    return disp, valid


def vfinalize_plain(cost_u16: torch.Tensor, v3: torch.Tensor, p1: float, p2: float,
                    num_disparities: int, uniqueness_ratio: int = 10, disp12_max_diff: int = 1,
                    do_subpixel: bool = True, w_real: int | None = None,
                    final_dir: str = "up") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4 on any device (S written over v3, like the kernel)."""
    WP = cost_u16.shape[1]
    S = _scan_plain(cost_u16, v3, v3, 0, final_dir == "up", float(p1) * 2.0, float(p2) * 2.0)
    return _finalize_plain(S, num_disparities, WP if w_real is None else w_real,
                           uniqueness_ratio, disp12_max_diff, do_subpixel)


def vfinalize(cost_u16: torch.Tensor, v3: torch.Tensor, p1: float, p2: float,
              num_disparities: int, uniqueness_ratio: int = 10, disp12_max_diff: int = 1,
              do_subpixel: bool = True, w_real: int | None = None,
              final_dir: str = "up") -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: S = v3 + the last vertical path (written over v3), then the WTA
    finalize. Returns (disp_raw f32 in d-index units, valid bool), both
    (HP, WP). disp12_max_diff < 0 skips the LR check."""
    if final_dir not in ("up", "down"):
        raise ValueError(final_dir)
    _check_volumes(cost_u16, v3)
    if not kernels.use_kernel(cost_u16, v3):
        return vfinalize_plain(cost_u16, v3, p1, p2, num_disparities, uniqueness_ratio,
                               disp12_max_diff, do_subpixel, w_real, final_dir)
    HP, WP, DP = cost_u16.shape
    w_real = WP if w_real is None else w_real
    p1x, p2x = float(p1) * 2.0, float(p2) * 2.0
    reverse = final_dir == "up"
    dev = cost_u16.device
    disp = torch.empty((HP, WP), dtype=torch.float32, device=dev)
    valid, d0, valid0, dR = (torch.empty((HP, WP), dtype=torch.int32, device=dev)
                             for _ in range(4))
    kernels.launch("r3d_vfinalize", dev, kernels.ptr(cost_u16), kernels.ptr(v3),
                   kernels.ptr(disp), kernels.ptr(valid), kernels.ptr(d0), kernels.ptr(valid0),
                   kernels.ptr(dR), HP, WP, DP, num_disparities, w_real, p1x, p2x,
                   int(reverse), uniqueness_ratio, disp12_max_diff, int(do_subpixel))
    vfinalize.launches += 1
    return disp, valid > 0


vfinalize.launches = 0


def aggregate_and_finalize(cost_u16: torch.Tensor, p1: float, p2: float, num_disparities: int,
                           uniqueness_ratio: int = 10, disp12_max_diff: int = 1,
                           do_subpixel: bool = True, w_real: int | None = None,
                           v1: torch.Tensor | None = None,
                           final_dir: str = "up") -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward path (K3) + last vertical path and finalize (K4) on a
    padded cost volume; v1 from cost_fwd_down is consumed in place (it ends
    holding S). final_dir "up" completes 4-direction mode (v1 holds L_fwd +
    L_down), "down" 3-direction mode (v1 holds L_fwd)."""
    if v1 is None:
        raise ValueError("v1 from cost_fwd_down is required")
    v3 = bwd_accumulate(cost_u16, v1, p1, p2)
    return vfinalize(cost_u16, v3, p1, p2, num_disparities, uniqueness_ratio,
                     disp12_max_diff, do_subpixel, w_real, final_dir)


def sgm_disparity_cuda(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 128,
    min_disparity: int = 0,
    block_size: int = 5,
    p1: float | None = None,
    p2: float | None = None,
    num_directions: int = 4,
    uniqueness_ratio: int = 10,
    disp12_max_diff: int = 1,
    speckle_window_size: int = 50,
    speckle_range: float = 32.0,
    pre_filter_cap: int = 63,
    do_subpixel: bool = True,
    speckle_method: str = "fast",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel-path twin of sgm.sgm_disparity: gray pair -> (disparity f32
    incl. min_disparity, -1 on invalid pixels; valid bool).

    num_directions 4 (cv2 HH4 directions) or 3 (SGBM_3WAY). Eight directions
    need the diagonal kernel, which is not ported yet.
    """
    if num_directions not in (3, 4):
        raise NotImplementedError("8-direction SGM needs the diagonal-path kernel "
                                  "(sgm_pallas._mk_diag_down_kernel), not ported yet")
    if p1 is None:
        p1 = 8.0 * block_size * block_size
    if p2 is None:
        p2 = 32.0 * block_size * block_size
    H, W = left_gray.shape
    HP, WP, DP = padded_shape(H, W, num_disparities)
    cost, v1 = cost_fwd_down(left_gray, right_gray, num_disparities, min_disparity,
                             block_size, pre_filter_cap, p1, p2, HP, WP, DP,
                             num_directions >= 4)
    disp_raw, valid = aggregate_and_finalize(
        cost, p1, p2, num_disparities, uniqueness_ratio, disp12_max_diff, do_subpixel, W,
        v1=v1, final_dir="up" if num_directions >= 4 else "down")
    disp_raw = disp_raw[:H, :W]
    valid = valid[:H, :W]
    if min_disparity:
        x = torch.arange(W, device=valid.device)[None, :]
        valid = valid & (x - (min_disparity + torch.round(disp_raw).to(torch.int64)) >= 0)
    if speckle_window_size > 0:
        if speckle_method == "fast":
            valid = _sgm.speckle_filter_fast(disp_raw, valid, speckle_range,
                                             speckle_window_size,
                                             max_disparity=_ceil_to(num_disparities, 128))
        else:
            valid = _sgm.speckle_filter(disp_raw, valid, speckle_range, speckle_window_size)
    disp_out = torch.where(valid, disp_raw + float(min_disparity), -1.0)
    return disp_out, valid
