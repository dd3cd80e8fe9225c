"""Kernel path of semi-global matching (twin of recon3d_tpu/depth/sgm_pallas.py).

Kernel wrappers, each with its plain PyTorch version beside it and a launch
counter:

  cost_fwd_down     K2  csrc/sgm_cost.cu       cost volume + L_fwd (+ L_down)
  bwd_accumulate    K3  csrc/sgm_bwd.cu        v3 = v1 + L_bwd, in place
  diag_accumulate   K5  csrc/sgm_diag.cu       v3 += a diagonal pair (sgm8)
  vfinalize         K4  csrc/sgm_vfinalize.cu  S = v3 + L_up fused with the WTA and LR check
  fwd_scan          K14 csrc/sgm_scan.cu       v1 = L_fwd of a given cost
  down_accumulate   K14 csrc/sgm_scan.cu       v1 += L_down, in place
  vscan_carry       K10 csrc/sgm_carry.cu      acc += a shard's vertical path, carry in / out
  diag_carry        K11 csrc/sgm_carry.cu      acc += a shard's diagonal pair, carries in / out
  wta_finalize      K12 csrc/sgm_vfinalize.cu  WTA finalize of a given S

The row-sharded path (depth/sgm_sharded.py) relays the carries of K10 and
K11 between shards and launches K3 once a shard as K13.

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
    (from prefilter_planes) overrides the internal prefilter. On the card two
    launches: the walk down the columns (cost, and L_down into v1), then the
    forward scan onto v1. block_size is odd in [1, 11], min_disparity >= 0."""
    if planes is None:
        planes = prefilter_planes(left_gray, right_gray, pre_filter_cap)
    planes = tuple(p.to(torch.float32).contiguous() for p in planes)
    H, W = planes[0].shape
    if hp % 64 or wp % 128 or dp not in (128, 256) or hp < H or wp < W or dp < num_disparities:
        raise ValueError(f"bad padded shape {(hp, wp, dp)} for {(H, W, num_disparities)}")
    if block_size not in (1, 3, 5, 7, 9, 11) or min_disparity < 0 or num_disparities < 1:
        raise ValueError(f"K2 takes an odd block_size in [1, 11], min_disparity >= 0 and "
                         f"num_disparities >= 1, got {block_size}, {min_disparity}, "
                         f"{num_disparities}")
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


def launch_bwd_accumulate(cost_u16: torch.Tensor, v1: torch.Tensor, p1: float,
                          p2: float) -> None:
    """Launch K3's kernel on checked CUDA volumes (bwd_accumulate, and K13
    of the row-sharded path, which counts its launches apart)."""
    HP, WP, DP = cost_u16.shape
    kernels.launch("r3d_bwd_accumulate", cost_u16.device, kernels.ptr(cost_u16),
                   kernels.ptr(v1), HP, WP, DP, float(p1) * 2.0, float(p2) * 2.0)


def bwd_accumulate(cost_u16: torch.Tensor, v1: torch.Tensor, p1: float,
                   p2: float) -> torch.Tensor:
    """K3: v3 = v1 + L_bwd (right-to-left path), written over v1 and
    returned. p1 / p2 in cv2 units."""
    _check_volumes(cost_u16, v1)
    if not kernels.use_kernel(cost_u16, v1):
        return bwd_accumulate_plain(cost_u16, v1, p1, p2)
    launch_bwd_accumulate(cost_u16, v1, p1, p2)
    bwd_accumulate.launches += 1
    return v1


bwd_accumulate.launches = 0


def fwd_scan_plain(cost_u16: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Plain version of K14's forward scan on any device."""
    v1 = torch.empty(cost_u16.shape, dtype=torch.float32, device=cost_u16.device)
    return _scan_plain(cost_u16, None, v1, 1, False, float(p1) * 2.0, float(p2) * 2.0)


def fwd_scan(cost_u16: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """K14: v1 = L_fwd (left-to-right path) of a padded cost volume, as a new
    (HP, WP, DP) f32 volume. p1 / p2 in cv2 units."""
    v1 = torch.empty(cost_u16.shape, dtype=torch.float32, device=cost_u16.device)
    _check_volumes(cost_u16, v1)
    if not kernels.use_kernel(cost_u16):
        return fwd_scan_plain(cost_u16, p1, p2)
    HP, WP, DP = cost_u16.shape
    kernels.launch("r3d_fwd_scan", cost_u16.device, kernels.ptr(cost_u16), kernels.ptr(v1),
                   HP, WP, DP, float(p1) * 2.0, float(p2) * 2.0)
    fwd_scan.launches += 1
    return v1


fwd_scan.launches = 0


def down_accumulate_plain(cost_u16: torch.Tensor, v: torch.Tensor, p1: float,
                          p2: float) -> torch.Tensor:
    """Plain version of K14's downward scan on any device (in place on v)."""
    return _scan_plain(cost_u16, v, v, 0, False, float(p1) * 2.0, float(p2) * 2.0)


def down_accumulate(cost_u16: torch.Tensor, v: torch.Tensor, p1: float,
                    p2: float) -> torch.Tensor:
    """K14: v += L_down (top-to-bottom path), written over v and returned."""
    _check_volumes(cost_u16, v)
    if not kernels.use_kernel(cost_u16, v):
        return down_accumulate_plain(cost_u16, v, p1, p2)
    HP, WP, DP = cost_u16.shape
    kernels.launch("r3d_down_accumulate", cost_u16.device, kernels.ptr(cost_u16),
                   kernels.ptr(v), HP, WP, DP, float(p1) * 2.0, float(p2) * 2.0)
    down_accumulate.launches += 1
    return v


down_accumulate.launches = 0


def _shift_cols(carry: torch.Tensor, direction: int) -> torch.Tensor:
    """new[x] = old[x - direction] on a (W, D) carry, the entering column
    zeroed (sgm_pallas._shift_cols): a vertical sweep becomes a diagonal one."""
    out = torch.zeros_like(carry)
    if direction > 0:
        out[1:] = carry[:-1]
    else:
        out[:-1] = carry[1:]
    return out


def diag_accumulate_plain(cost_u16: torch.Tensor, v: torch.Tensor, p1: float, p2: float,
                          vertical: str = "down") -> torch.Tensor:
    """Plain version of K5 on any device (in place on v, like the kernel):
    row by row with the two column-shifted carries of sgm_pallas's
    _mk_diag_down_kernel, swept bottom to top for vertical="up"."""
    p1x, p2x = float(p1) * 2.0, float(p2) * 2.0
    HP = cost_u16.shape[0]
    ca = torch.zeros(cost_u16.shape[1:], dtype=torch.float32, device=v.device)
    cb = torch.zeros_like(ca)
    for y in (range(HP - 1, -1, -1) if vertical == "up" else range(HP)):
        c = cost_u16[y].to(torch.float32)
        ca = _path_step(_shift_cols(ca, +1), c, p1x, p2x)
        cb = _path_step(_shift_cols(cb, -1), c, p1x, p2x)
        v[y] = v[y] + ca + cb
    return v


def diag_accumulate(cost_u16: torch.Tensor, v: torch.Tensor, p1: float, p2: float,
                    vertical: str = "down") -> torch.Tensor:
    """K5: v += both diagonal paths of one vertical direction ("down": from
    (y-1, x-+1), "up": from (y+1, x-+1)), written over v and returned.
    p1 / p2 in cv2 units."""
    if vertical not in ("down", "up"):
        raise ValueError(vertical)
    _check_volumes(cost_u16, v)
    if not kernels.use_kernel(cost_u16, v):
        return diag_accumulate_plain(cost_u16, v, p1, p2, vertical)
    HP, WP, DP = cost_u16.shape
    kernels.launch("r3d_diag_accumulate", cost_u16.device, kernels.ptr(cost_u16),
                   kernels.ptr(v), HP, WP, DP, float(p1) * 2.0, float(p2) * 2.0,
                   int(vertical == "up"))
    diag_accumulate.launches += 1
    return v


diag_accumulate.launches = 0


def _carry_scan_plain(cost_u16: torch.Tensor, acc: torch.Tensor, carry_in: torch.Tensor,
                      p1: float, p2: float, reverse: bool, h_real: int,
                      shifts: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K10 (shifts (0,)) and K11 (shifts (+1, -1)) on any
    device, in place on acc: row by row with one carry plane a path, each
    column-shifted before its step (sgm_pallas._mk_vscan_io_kernel,
    _mk_diag_io_kernel). Down: the carries start as carry_in and the ones
    after row h_real - 1 go out. Up: they start at zero, are replaced by
    carry_in on entering row h_real - 1, and the ones after row 0 go out."""
    p1x, p2x = float(p1) * 2.0, float(p2) * 2.0
    h_last = h_real - 1
    carries = [torch.zeros_like(c) if reverse else c for c in carry_in]
    carry_out = None
    for y in (range(cost_u16.shape[0] - 1, -1, -1) if reverse else range(cost_u16.shape[0])):
        if reverse and y == h_last:
            carries = list(carry_in)
        c = cost_u16[y].to(torch.float32)
        carries = [_path_step(_shift_cols(ca, dx) if dx else ca, c, p1x, p2x)
                   for ca, dx in zip(carries, shifts)]
        acc[y] = sum(carries, acc[y])
        if not reverse and y == h_last:
            carry_out = torch.stack(carries)
    return acc, torch.stack(carries) if reverse else carry_out


def _check_carry(cost_u16: torch.Tensor, acc: torch.Tensor, carry_in: torch.Tensor,
                 planes: Tuple[int, ...], h_real: int) -> None:
    _check_volumes(cost_u16, acc)
    want = planes + tuple(cost_u16.shape[1:])
    if carry_in.dtype != torch.float32 or tuple(carry_in.shape) != want:
        raise ValueError(f"carry_in must be float32 {want}, got {carry_in.dtype} "
                         f"{tuple(carry_in.shape)}")
    if not 1 <= h_real <= cost_u16.shape[0]:
        raise ValueError(f"h_real {h_real} outside 1..{cost_u16.shape[0]}")


def _carry_scan(name: str, wrapper, cost_u16, acc, carry_in, p1, p2, reverse, h_real):
    """Launch K10 / K11 (launcher `name`) and count it on `wrapper`."""
    carry_in = carry_in.contiguous()
    carry_out = torch.empty_like(carry_in)
    HP, WP, DP = cost_u16.shape
    kernels.launch(name, cost_u16.device, kernels.ptr(cost_u16), kernels.ptr(acc),
                   kernels.ptr(carry_in), kernels.ptr(carry_out), HP, WP, DP,
                   float(p1) * 2.0, float(p2) * 2.0, int(reverse), int(h_real))
    wrapper.launches += 1
    return acc, carry_out


def vscan_carry_plain(cost_u16: torch.Tensor, acc: torch.Tensor, carry_in: torch.Tensor,
                      p1: float, p2: float, reverse: bool,
                      h_real: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K10 on any device (in place on acc, like the kernel)."""
    acc, carry_out = _carry_scan_plain(cost_u16, acc, carry_in[None], p1, p2, reverse, h_real,
                                       (0,))
    return acc, carry_out[0]


def vscan_carry(cost_u16: torch.Tensor, acc: torch.Tensor, carry_in: torch.Tensor, p1: float,
                p2: float, reverse: bool, h_real: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: one row shard's vertical path with relayed carry planes
    (sgm_pallas.vscan_carry). cost_u16 / acc: the shard's padded (HP, WP,
    DP) volumes; carry_in: the (WP, DP) f32 plane from the neighbouring
    shard; h_real: the shard's real rows. Returns (acc + L_vert, written over
    acc; carry_out (WP, DP)). reverse: the upward path. p1 / p2 in cv2 units."""
    _check_carry(cost_u16, acc, carry_in, (), h_real)
    if not kernels.use_kernel(cost_u16, acc, carry_in):
        return vscan_carry_plain(cost_u16, acc, carry_in, p1, p2, reverse, h_real)
    return _carry_scan("r3d_vscan_carry", vscan_carry, cost_u16, acc, carry_in, p1, p2,
                       reverse, h_real)


vscan_carry.launches = 0


def diag_carry_plain(cost_u16: torch.Tensor, acc: torch.Tensor, carry_in: torch.Tensor,
                     p1: float, p2: float, reverse: bool,
                     h_real: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K11 on any device (in place on acc, like the kernel)."""
    return _carry_scan_plain(cost_u16, acc, carry_in, p1, p2, reverse, h_real, (1, -1))


def diag_carry(cost_u16: torch.Tensor, acc: torch.Tensor, carry_in: torch.Tensor, p1: float,
               p2: float, reverse: bool, h_real: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11: vscan_carry for the diagonal pair of one vertical direction
    (sgm_pallas.diag_carry), with (2, WP, DP) carries: plane 0 receives from
    x - 1, plane 1 from x + 1."""
    _check_carry(cost_u16, acc, carry_in, (2,), h_real)
    if not kernels.use_kernel(cost_u16, acc, carry_in):
        return diag_carry_plain(cost_u16, acc, carry_in, p1, p2, reverse, h_real)
    return _carry_scan("r3d_diag_carry", diag_carry, cost_u16, acc, carry_in, p1, p2,
                       reverse, h_real)


diag_carry.launches = 0


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
    """Plain version of K4 on any device: S = v3 + L_vert computed out of
    place (v3 is left as it was, like the kernel), then finalized."""
    WP = cost_u16.shape[1]
    S = _scan_plain(cost_u16, v3, torch.empty_like(v3), 0, final_dir == "up", float(p1) * 2.0,
                    float(p2) * 2.0)
    return _finalize_plain(S, num_disparities, WP if w_real is None else w_real,
                           uniqueness_ratio, disp12_max_diff, do_subpixel)


def vfinalize(cost_u16: torch.Tensor, v3: torch.Tensor, p1: float, p2: float,
              num_disparities: int, uniqueness_ratio: int = 10, disp12_max_diff: int = 1,
              do_subpixel: bool = True, w_real: int | None = None,
              final_dir: str = "up") -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: the last vertical path fused with the WTA finalize of S = v3 +
    L_vert; S never reaches memory and v3 is read only. Returns (disp_raw
    f32 in d-index units, valid bool), both (HP, WP). disp12_max_diff < 0
    skips the LR check."""
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
    disp, valid, plane = _finalize_outputs(HP, WP, dev)
    kernels.launch("r3d_vfinalize", dev, kernels.ptr(cost_u16), kernels.ptr(v3),
                   kernels.ptr(disp), kernels.ptr(valid), kernels.ptr(plane), HP, WP, DP,
                   num_disparities, w_real, p1x, p2x, int(reverse), uniqueness_ratio,
                   disp12_max_diff, int(do_subpixel))
    vfinalize.launches += 1
    return disp, valid > 0


vfinalize.launches = 0


def _finalize_outputs(HP: int, WP: int, dev: torch.device):
    """disp (f32), valid (int32) and the right-view plane (int32 scratch)
    that K4 and K12 write."""
    disp = torch.empty((HP, WP), dtype=torch.float32, device=dev)
    valid, plane = (torch.empty((HP, WP), dtype=torch.int32, device=dev) for _ in range(2))
    return disp, valid, plane


def wta_finalize_plain(S: torch.Tensor, num_disparities: int, uniqueness_ratio: int = 10,
                       disp12_max_diff: int = 1, do_subpixel: bool = True,
                       w_real: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K12 on any device."""
    return _finalize_plain(S, num_disparities, S.shape[1] if w_real is None else w_real,
                           uniqueness_ratio, disp12_max_diff, do_subpixel)


def wta_finalize(S: torch.Tensor, num_disparities: int, uniqueness_ratio: int = 10,
                 disp12_max_diff: int = 1, do_subpixel: bool = True,
                 w_real: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12: the WTA finalize of a fully aggregated (HP, WP, DP) f32 volume
    S (sgm_pallas.wta_finalize), S read only. Returns (disp_raw f32 in
    d-index units, valid bool), both (HP, WP)."""
    if S.dtype != torch.float32 or S.ndim != 3:
        raise ValueError(f"S must be a float32 volume, got {S.dtype} {tuple(S.shape)}")
    HP, WP, DP = S.shape
    if WP % 128 or DP not in (128, 256) or not 3 <= num_disparities <= DP:
        raise ValueError(f"bad volume shape {(HP, WP, DP)} for D = {num_disparities}")
    if not kernels.use_kernel(S):
        return wta_finalize_plain(S, num_disparities, uniqueness_ratio, disp12_max_diff,
                                  do_subpixel, w_real)
    w_real = WP if w_real is None else w_real
    dev = S.device
    disp, valid, plane = _finalize_outputs(HP, WP, dev)
    kernels.launch("r3d_wta_finalize", dev, kernels.ptr(S), kernels.ptr(disp),
                   kernels.ptr(valid), kernels.ptr(plane), HP, WP, DP, num_disparities,
                   w_real, uniqueness_ratio, disp12_max_diff, int(do_subpixel))
    wta_finalize.launches += 1
    return disp, valid > 0


wta_finalize.launches = 0


def aggregate_and_finalize(cost_u16: torch.Tensor, p1: float, p2: float, num_disparities: int,
                           uniqueness_ratio: int = 10, disp12_max_diff: int = 1,
                           do_subpixel: bool = True, w_real: int | None = None,
                           v1: torch.Tensor | None = None, final_dir: str = "up",
                           with_diag: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Path aggregation + finalize on a padded cost volume
    (sgm_pallas.aggregate_and_finalize): backward path (K3), the diagonal
    pairs (K5, with_diag), then the last vertical path and finalize (K4).
    v1 from cost_fwd_down is consumed in place (it ends holding v3, the sum
    of every path but the last vertical one, which K4 adds inside its
    finalize); without it the forward (and, for "up", downward) paths run
    here (K14).
    final_dir "up" completes 4-direction mode (v1 holds L_fwd + L_down),
    "down" 3-direction mode (v1 holds L_fwd); with_diag (8-direction mode)
    needs "up"."""
    if final_dir not in ("up", "down"):
        raise ValueError(final_dir)
    if with_diag and final_dir != "up":
        raise ValueError("8-direction mode ends with the upward path")
    if v1 is None:
        v1 = fwd_scan(cost_u16, p1, p2)
        if final_dir == "up":
            down_accumulate(cost_u16, v1, p1, p2)
    v3 = bwd_accumulate(cost_u16, v1, p1, p2)
    if with_diag:
        diag_accumulate(cost_u16, v3, p1, p2, "down")
        diag_accumulate(cost_u16, v3, p1, p2, "up")
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

    num_directions 4 (cv2 HH4 directions), 3 (SGBM_3WAY) or 8 (MODE_HH: adds
    the four diagonals).
    """
    if num_directions not in (3, 4, 8):
        raise ValueError(f"num_directions must be 3, 4 or 8, got {num_directions}")
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
        v1=v1, final_dir="up" if num_directions >= 4 else "down", with_diag=num_directions == 8)
    return finish_disparity(disp_raw[:H, :W], valid[:H, :W], num_disparities, min_disparity,
                            speckle_window_size, speckle_range, speckle_method)


def finish_disparity(disp_raw: torch.Tensor, valid: torch.Tensor, num_disparities: int,
                     min_disparity: int, speckle_window_size: int, speckle_range: float,
                     speckle_method: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail after the finalize on the (H, W) frame: the min_disparity
    range check, the speckle filter and the -1 fill (sgm_pallas.py:1231-1245)."""
    W = disp_raw.shape[1]
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
