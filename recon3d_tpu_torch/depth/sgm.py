"""Semi-global matching, plain PyTorch oracle (twin of recon3d_tpu/depth/sgm.py).

Each path direction is a Python loop along its axis carrying the whole
orthogonal (rows, D) plane, the same recurrence as the JAX lax.scan. This is
the reference the kernel path (depth/sgm_cuda.py) is held to, and the
`backend='torch'` branch of depth/matcher.py. `speckle_filter_fast` is also
on the kernel path, where it runs as plain tensor code.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from recon3d_tpu_torch.depth import cost as _cost

BIG = 1e9


def _sgm_step(carry: torch.Tensor, c: torch.Tensor, P1: float, P2: float) -> torch.Tensor:
    """One scanline step: carry (M, D) -> aggregated (M, D)."""
    m = carry.min(dim=-1, keepdim=True).values
    edge = torch.full_like(carry[:, :1], BIG)
    dm = torch.cat([edge, carry[:, :-1]], 1)
    dp = torch.cat([carry[:, 1:], edge], 1)
    cand = torch.minimum(torch.minimum(carry, m + P2), torch.minimum(dm, dp) + P1)
    return c + cand - m


def _scan_dir(cost: torch.Tensor, axis: int, reverse: bool, P1: float, P2: float,
              col_shift: int = 0) -> torch.Tensor:
    """Aggregate along `axis` (0 = rows top/bottom, 1 = cols left/right).

    col_shift (+1/-1) turns a vertical scan into a diagonal one by shifting
    the carry along the orthogonal axis each step, zero-filling the entering
    column (which restarts a border path at its matching cost).
    """
    vol = cost.transpose(0, axis) if axis != 0 else cost  # (T, M, D)
    out = torch.empty_like(vol)
    carry = torch.zeros_like(vol[0])
    steps = range(vol.shape[0] - 1, -1, -1) if reverse else range(vol.shape[0])
    for t in steps:
        if col_shift:
            carry = torch.roll(carry, col_shift, 0)
            if col_shift > 0:
                carry[:col_shift] = 0.0
            else:
                carry[col_shift:] = 0.0
        carry = _sgm_step(carry, vol[t], P1, P2)
        out[t] = carry
    return out.transpose(0, axis) if axis != 0 else out


def aggregate(cost: torch.Tensor, p1: float, p2: float, num_directions: int = 4) -> torch.Tensor:
    """Sum of SGM path costs over 3, 4 or 8 directions; cost (H, W, D).

    3 = {L->R, R->L, top->bottom} (cv2 SGBM_3WAY), 4 adds bottom->top, 8 adds
    the diagonals.
    """
    P1, P2 = float(p1), float(p2)
    c = torch.clamp(cost, max=BIG)
    s = _scan_dir(c, 1, False, P1, P2)
    s = s + _scan_dir(c, 1, True, P1, P2)
    s = s + _scan_dir(c, 0, False, P1, P2)
    if num_directions == 3:
        return s
    s = s + _scan_dir(c, 0, True, P1, P2)
    if num_directions == 8:
        s = s + _scan_dir(c, 0, False, P1, P2, col_shift=1)
        s = s + _scan_dir(c, 0, False, P1, P2, col_shift=-1)
        s = s + _scan_dir(c, 0, True, P1, P2, col_shift=1)
        s = s + _scan_dir(c, 0, True, P1, P2, col_shift=-1)
    return s


def _subpixel(S: torch.Tensor, d0: torch.Tensor) -> torch.Tensor:
    """Parabolic refinement around the WTA disparity (interior optima only)."""
    D = S.shape[-1]
    d0c = torch.clamp(d0, 1, D - 2).long()
    pick = lambda off: torch.gather(S, -1, (d0c + off)[..., None])[..., 0]
    c0, cm, cp = pick(0), pick(-1), pick(1)
    denom = torch.clamp(cm + cp - 2.0 * c0, min=1e-6)
    delta = torch.clamp((cm - cp) / (2.0 * denom), -0.5, 0.5)
    refined = d0c.to(torch.float32) + delta
    return torch.where((d0 >= 1) & (d0 <= D - 2), refined, d0.to(torch.float32))


def _uniqueness_mask(S: torch.Tensor, d0: torch.Tensor, uniqueness_ratio: int) -> torch.Tensor:
    """OpenCV uniqueness test: reject if any non-adjacent disparity comes
    within (1 + ratio / 100) of the best cost."""
    if uniqueness_ratio <= 0:
        return torch.ones(d0.shape, dtype=torch.bool, device=S.device)
    best = S.min(dim=-1).values
    d_idx = torch.arange(S.shape[-1], device=S.device)
    adjacent = (d_idx - d0[..., None]).abs() <= 1
    second = torch.where(adjacent, torch.full_like(S, BIG), S).min(dim=-1).values
    return second * 100.0 > best * (100.0 + uniqueness_ratio)


def right_disparity_from_volume(S: torch.Tensor) -> torch.Tensor:
    """Right-view WTA from the left volume: S_R(y, x, d) = S_L(y, x + d, d),
    out-of-range -> BIG, ties to the smallest d."""
    H, W, D = S.shape
    best = torch.full((H, W), BIG, dtype=S.dtype, device=S.device)
    arg = torch.zeros((H, W), dtype=torch.int32, device=S.device)
    for d in range(D):
        col = S[:, :, 0] if d == 0 else torch.cat(
            [S[:, d:, d], torch.full((H, d), BIG, dtype=S.dtype, device=S.device)], 1)
        take = col < best
        best = torch.where(take, col, best)
        arg = torch.where(take, torch.full_like(arg, d), arg)
    return arg


def lr_consistency_mask(d_left: torch.Tensor, d_right: torch.Tensor,
                        max_diff: int = 1, num_disparities: int = None) -> torch.Tensor:
    """Validity via left-right check: |dL(x) - dR(x - dL(x))| <= max_diff."""
    H, W = d_left.shape
    dl = torch.round(d_left).to(torch.int32)
    if num_disparities is None:
        num_disparities = 256
    ok = torch.zeros((H, W), dtype=torch.bool, device=d_left.device)
    for d in range(num_disparities):
        dr = d_right if d == 0 else torch.cat(
            [torch.full((H, d), -10_000, dtype=d_right.dtype, device=d_right.device),
             d_right[:, :-d]], 1)
        ok = ok | ((dl == d) & ((d - dr).abs() <= max_diff))
    return ok


def speckle_filter(disp: torch.Tensor, valid: torch.Tensor, max_range: float = 32.0,
                   window_size: int = 50, iterations: int = 0) -> torch.Tensor:
    """cv2.filterSpeckles-style small-region removal by exact labeling.

    4-connected components (an edge where |d_p - d_q| <= max_range) of at
    most window_size pixels are invalidated. Labels converge by min-label
    hooking plus pointer jumping in O(log(H * W)) rounds. Returns the
    updated validity mask.
    """
    H, W = disp.shape
    if iterations <= 0:
        iterations = int(math.ceil(math.log2(H * W))) + 4
    SENT = H * W
    dev = disp.device
    idx = torch.arange(H * W, dtype=torch.int64, device=dev).reshape(H, W)
    sent = torch.full((H, W), SENT, dtype=torch.int64, device=dev)
    labels = torch.where(valid, idx, sent)
    coords = (torch.arange(H, device=dev)[:, None].expand(H, W),
              torch.arange(W, device=dev)[None, :].expand(H, W))

    def neighbor_min(lab):
        lmin = lab
        for axis in (0, 1):
            n = disp.shape[axis]
            for shift in (1, -1):
                dn = torch.roll(disp, shift, axis)
                ln = torch.roll(lab, shift, axis)
                edge_ok = (disp - dn).abs() <= max_range
                inb = (coords[axis] - shift >= 0) & (coords[axis] - shift < n)
                lmin = torch.minimum(lmin, torch.where(edge_ok & inb, ln, sent))
        return torch.where(valid, lmin, sent)

    def compress(lab):
        flat = torch.cat([lab.reshape(-1), lab.new_tensor([SENT])])
        return flat[lab]

    for _ in range(iterations):
        labels = compress(compress(neighbor_min(labels)))
    counts = torch.bincount(labels.reshape(-1), minlength=H * W + 1)
    return valid & (counts[labels] > window_size)


def _box_count(occ: torch.Tensor, r: int) -> torch.Tensor:
    """Zero-padded (2r+1)^2 box sums of int32 planes (..., H, W), exact:
    two int32 prefix sums, no floating point."""
    for axis in (-2, -1):
        n = occ.shape[axis]
        pad_shape = list(occ.shape)
        pad_shape[axis] = 1
        cs = torch.cat([occ.new_zeros(pad_shape), torch.cumsum(occ, axis, dtype=torch.int32)],
                       axis)
        i = torch.arange(n, device=occ.device)
        hi = torch.clamp(i + r + 1, max=n)
        lo = torch.clamp(i - r, min=0)
        occ = cs.index_select(axis, hi) - cs.index_select(axis, lo)
    return occ


def speckle_filter_fast(disp: torch.Tensor, valid: torch.Tensor,
                        max_range: float = 32.0, window_size: int = 50,
                        side: int | None = None, max_disparity: int = 256) -> torch.Tensor:
    """Gather-free approximate speckle removal (the kernel path's filter).

    Scores each pixel by the number of valid same-disparity-band pixels (band
    width max_range, two phase-shifted binnings, max of the two scores)
    inside a side x side window, and invalidates scores <= window_size. The
    counts are int32 prefix sums, so they are exact.
    """
    if side is None:
        side = 2 * int(2.5 * float(window_size) ** 0.5 / 2.0 + 1.0) + 1
    r = side // 2
    nbins = int(max_disparity / max_range) + 2
    b_idx = torch.arange(nbins, device=disp.device)[:, None, None]
    score = torch.zeros(disp.shape, dtype=torch.int32, device=disp.device)
    for ph in (0.0, 0.5 * max_range):
        bid = torch.floor((disp + ph) / max_range).to(torch.int64)
        occ = (valid[None] & (bid[None] == b_idx)).to(torch.int32)
        boxed = _box_count(occ, r)
        inside = (bid >= 0) & (bid < nbins)
        cnt = torch.gather(boxed, 0, bid.clamp(0, nbins - 1)[None])[0]
        score = torch.maximum(score, torch.where(inside, cnt, torch.zeros_like(cnt)))
    return valid & (score > window_size)


def sgm_disparity(
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
    cost_kind: str = "bt",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full SGM: gray pair -> (disparity float32 incl. min_disparity, -1 on
    invalid pixels; valid bool). cost_kind 'bt' (Birchfield-Tomasi on the
    x-Sobel prefilter) or 'census' (5x5 census Hamming, with the penalties
    scaled to its range)."""
    if p1 is None:
        p1 = 8.0 * block_size * block_size
    if p2 is None:
        p2 = 32.0 * block_size * block_size
    if cost_kind == "bt":
        lpre = _cost.xsobel_prefilter(left_gray, pre_filter_cap)
        rpre = _cost.xsobel_prefilter(right_gray, pre_filter_cap)
        vol = _cost.bt_cost_volume(lpre, rpre, num_disparities, min_disparity)
    elif cost_kind == "census":
        vol = _cost.census_cost_volume(left_gray, right_gray, num_disparities, min_disparity)
        # census costs are small (<= 24): scale the penalties accordingly
        p1 = p1 / (8.0 * block_size * block_size) * 6.0
        p2 = p2 / (32.0 * block_size * block_size) * 64.0
    else:
        raise ValueError(f"unknown cost kind {cost_kind}")
    # zero (not sentinel) out-of-range cells before the box, then mark every
    # window that touches one: [x - r, x + r] crosses x - (min_disp + d) < 0
    # iff x < min_disp + d + r
    vol = _cost.box_aggregate(torch.where(vol > 1e8, torch.zeros_like(vol), vol), block_size)
    H, W, D = vol.shape
    xi = torch.arange(W, device=vol.device)[None, :, None]
    di = torch.arange(D, device=vol.device)[None, None, :]
    vol = torch.where(xi < min_disparity + di + block_size // 2, torch.full_like(vol, 1e5), vol)

    S = aggregate(vol, p1, p2, num_directions)
    d0 = torch.argmin(S, dim=-1).to(torch.int32)
    disp = _subpixel(S, d0) if do_subpixel else d0.to(torch.float32)

    valid = _uniqueness_mask(S, d0, uniqueness_ratio)
    if disp12_max_diff >= 0:
        d_right = right_disparity_from_volume(S)
        valid = valid & lr_consistency_mask(d0.to(torch.float32), d_right,
                                            disp12_max_diff, num_disparities)
    x = torch.arange(W, device=vol.device)[None, :]
    valid = valid & (x - (min_disparity + d0) >= 0)
    if speckle_window_size > 0:
        valid = speckle_filter(disp, valid, speckle_range, speckle_window_size)
    disp_out = torch.where(valid, disp + float(min_disparity), torch.full_like(disp, -1.0))
    return disp_out, valid
