"""Stereo matching costs: Birchfield-Tomasi on the x-Sobel prefilter and
the census transform's Hamming distance (twin of recon3d_tpu/depth/cost.py:
`xsobel_prefilter`, `_bt_bounds`, `bt_cost_volume`, `box_aggregate`,
`census_cost_volume`).

Cost volumes are (H, W, D) float32 with the disparity on the last axis, the
JAX package's layout.
"""
from __future__ import annotations

import torch


def _edge_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices of an axis of length n padded by lo / hi replicated edges."""
    return torch.arange(-lo, n + hi, device=device).clamp_(0, n - 1)


def xsobel_prefilter(gray: torch.Tensor, prefilter_cap: int = 63) -> torch.Tensor:
    """OpenCV SGBM prefilter: 3x3 x-Sobel (replicate borders) clipped to
    [0, 2 * cap] about cap."""
    g = gray.to(torch.float32)
    H, W = g.shape
    gp = g[_edge_index(H, 1, 1, g.device)][:, _edge_index(W, 1, 1, g.device)]
    dx = (
        (gp[:-2, 2:] - gp[:-2, :-2])
        + 2.0 * (gp[1:-1, 2:] - gp[1:-1, :-2])
        + (gp[2:, 2:] - gp[2:, :-2])
    )
    cap = float(prefilter_cap)
    return torch.clamp(dx + cap, 0.0, 2.0 * cap)


def _bt_bounds(img: torch.Tensor):
    """Per-pixel (lo, hi) of the Birchfield-Tomasi half-sample neighborhood,
    half-samples floor((a + b) / 2) as in OpenCV's calcPixelCostBT."""
    left = torch.floor(0.5 * (img + torch.cat([img[:, :1], img[:, :-1]], 1)))
    right = torch.floor(0.5 * (img + torch.cat([img[:, 1:], img[:, -1:]], 1)))
    lo = torch.minimum(torch.minimum(left, right), img)
    hi = torch.maximum(torch.maximum(left, right), img)
    return lo, hi


def bt_cost_volume(left: torch.Tensor, right: torch.Tensor,
                   num_disparities: int = 128, min_disparity: int = 0) -> torch.Tensor:
    """cost(y, x, d) = BT(left(y, x), right(y, x - (min_disparity + d))),
    (H, W, D) float32; out-of-range samples get 1e9."""
    L = left.to(torch.float32)
    R = right.to(torch.float32)
    H, W = L.shape
    lo_l, hi_l = _bt_bounds(L)
    lo_r, hi_r = _bt_bounds(R)
    x = torch.arange(W, device=L.device)
    out = torch.empty((H, W, num_disparities), dtype=torch.float32, device=L.device)
    for d in range(num_disparities):
        shift = min_disparity + d
        Rv, Rlo, Rhi = (torch.roll(a, shift, 1) for a in (R, lo_r, hi_r))
        c_ltr = torch.clamp(torch.maximum(L - Rhi, Rlo - L), min=0.0)
        c_rtl = torch.clamp(torch.maximum(Rv - hi_l, lo_l - Rv), min=0.0)
        c = torch.minimum(c_ltr, c_rtl)
        out[:, :, d] = torch.where(x - shift >= 0, c, torch.full_like(c, 1e9))
    return out


def box_aggregate(cost: torch.Tensor, block_size: int = 5) -> torch.Tensor:
    """Sum costs over a block_size x block_size window (replicate borders),
    as direct taps: exact f32 addition on integer-valued costs."""
    if block_size <= 1:
        return cost
    r = block_size // 2

    def box1d(a, axis):
        n = a.shape[axis]
        ap = a.index_select(axis, _edge_index(n, r, r, a.device))
        out = ap.narrow(axis, 0, n)
        for k in range(1, block_size):
            out = out + ap.narrow(axis, k, n)
        return out

    return box1d(box1d(cost, 0), 1)


def _census(g: torch.Tensor, window: int) -> torch.Tensor:
    """window x window census words (bit i = neighbour i > center, replicate
    borders), int32: window 5 gives 24 bits."""
    H, W = g.shape
    r = window // 2
    gp = g[_edge_index(H, r, r, g.device)][:, _edge_index(W, r, r, g.device)]
    word = torch.zeros((H, W), dtype=torch.int32, device=g.device)
    bit = 0
    for dy in range(window):
        for dx in range(window):
            if dy == r and dx == r:
                continue
            if bit < 32:
                word |= (gp[dy:dy + H, dx:dx + W] > g).to(torch.int32) << bit
            bit += 1
    return word


def _popcount(v: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int32 words below 2^24, without a product
    that could overflow."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return v & 0x3F


def census_cost_volume(left: torch.Tensor, right: torch.Tensor, num_disparities: int = 128,
                       min_disparity: int = 0, window: int = 5) -> torch.Tensor:
    """Census-transform Hamming cost volume (H, W, D), float32 (integer
    valued, exact): cost(y, x, d) = popcount(census_l(y, x) ^
    census_r(y, x - (min_disparity + d))); out-of-range samples get 1e9."""
    L = left.to(torch.float32)
    cl = _census(L, window)
    cr = _census(right.to(torch.float32), window)
    H, W = cl.shape
    x = torch.arange(W, device=L.device)
    out = torch.empty((H, W, num_disparities), dtype=torch.float32, device=L.device)
    for d in range(num_disparities):
        shift = min_disparity + d
        h = _popcount(cl ^ torch.roll(cr, shift, 1)).to(torch.float32)
        out[:, :, d] = torch.where(x - shift >= 0, h, torch.full_like(h, 1e9))
    return out
