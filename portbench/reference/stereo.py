"""Plain reference of the stereo depth frame, stage by stage.

Written from the configuration's stated semantics, in plain PyTorch, and
importing nothing of the program. Every stage takes a `dtype`: the checks
run it in float64 (rectification, WLS, depth and cloud) or float32 (SGM,
whose arithmetic is integer-valued and exact in float32); the control runs
the same code in bfloat16.

- rectification: cv2.initUndistortRectifyMap's maps from the rig, then the
  two-pass form of cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0): a vertical
  pass samples the source at the row where each intermediate pixel's map
  inverse lands, a horizontal pass samples that at map_x; pixels whose
  sample leaves the source are 0, and the 1-D samples wrap around the
  image, as the configuration's `rectify` block states.
- SGM: the x-Sobel prefilter clipped about the prefilter cap, Birchfield-
  Tomasi costs on it (half samples rounded down), zero for samples left of
  the image, a box sum with replicated borders (the column taps summed top
  to bottom, then the row taps left to right, in float32), held as the
  integer part of twice the sum; windows that touch a sample left of the
  image cost `border_cost`. Four scanline paths (left to right, right to
  left, down, up) with P1, P2 (both doubled with the costs), winner takes
  all with ties to the smaller disparity, parabolic sub-pixel refinement,
  the uniqueness ratio, the left-right check against the right view's
  winners (S(x + d, d)), and the box-count speckle filter.
- WLS: the fast global smoother: per sweep a horizontal and a vertical
  tridiagonal solve, guide weights exp(-|dI| / sigma) floored at 1e-6,
  lambda_t = 1.5 lam 4^(T-t-1) / (4^T - 1) (rounded to float32),
  confidence the validity, diag = (conf + wl) + wr, and the Thomas
  algorithm in the configuration's stated arithmetic. Run in float32 it is
  the configuration's own solve, which leaves a few pixels undetermined:
  those on line segments that floored guide edges cut off from every pixel
  with confidence, where the pivots nearly vanish.
- depth and cloud: Z = Q23 / (Q32 d + Q33), points Q [x y d 1]^T
  dehomogenised, colour the given image / 255.
"""
from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64


# ---- rectification -------------------------------------------------------

def rectify_maps(K, dist, R, P, W, H, device, dtype=F64):
    """(map_x, map_y) (H, W): the raw pixel that each rectified pixel shows."""
    K = torch.as_tensor(np.asarray(K, np.float64), dtype=dtype, device=device)
    P = torch.as_tensor(np.asarray(P, np.float64), dtype=dtype, device=device)
    Rm = torch.as_tensor(np.asarray(R, np.float64), dtype=dtype, device=device)
    d = np.zeros(5)
    dd = np.asarray(dist, np.float64).reshape(-1)[:5]
    d[:dd.size] = dd
    k1, k2, p1, p2, k3 = (torch.tensor(float(v), dtype=dtype, device=device) for v in d)
    y, x = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device), indexing="ij")
    rect = torch.stack([(x - P[0, 2]) / P[0, 0], (y - P[1, 2]) / P[1, 1], torch.ones_like(x)], -1)
    ray = rect @ Rm  # R^T applied to each row vector: the raw camera's ray
    xn, yn = ray[..., 0] / ray[..., 2], ray[..., 1] / ray[..., 2]
    r2 = xn * xn + yn * yn
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return K[0, 0] * xd + K[0, 1] * yd + K[0, 2], K[1, 1] * yd + K[1, 2]


def _interp_rows(xq, xp, fp):
    """np.interp along each row: xp (H, W) increasing, fp (H, W), xq (W,);
    constant beyond the ends."""
    H, W = xp.shape
    q = xq.expand(H, -1).contiguous()
    i = torch.searchsorted(xp.contiguous(), q).clamp(1, W - 1)
    x0, x1 = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    f0, f1 = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i)
    t = (q - x0) / (x1 - x0)
    out = f0 + t * (f1 - f0)
    out = torch.where(q <= xp[:, :1], fp[:, :1], out)
    return torch.where(q >= xp[:, -1:], fp[:, -1:], out)


class Rectifier:
    """The two-pass rectification of one camera: its maps, the inverse
    vertical map, the valid mask, and the pixels whose validity lies within
    `margin` px of a bound (decided by rounding, so not compared)."""

    def __init__(self, K, dist, R, P, W, H, device, dtype=F64, margin=1e-3):
        mx, my = rectify_maps(K, dist, R, P, W, H, device, dtype)
        if not bool((torch.diff(mx, dim=1) > 0).all()):
            raise ValueError("map_x is not increasing along the rows")
        xs = torch.arange(W, dtype=dtype, device=device)
        self.vy = _interp_rows(xs, mx, my)
        self.hx = mx
        lo, hi = mx[:, :1], mx[:, -1:]
        inv_ok = (xs >= lo) & (xs <= hi)
        self.valid = (inv_ok & (self.vy >= 0) & (self.vy <= H - 1) & (mx >= 0) & (mx <= W - 1)
                      & (my >= 0) & (my <= H - 1))
        near = torch.zeros_like(self.valid)
        for v, b in ((xs.expand(H, -1), lo), (xs.expand(H, -1), hi), (self.vy, 0.0),
                     (self.vy, H - 1.0), (mx, 0.0), (mx, W - 1.0), (my, 0.0), (my, H - 1.0)):
            near |= (v - b).abs() < margin
        self.ambiguous = near

    def __call__(self, gray):
        """gray (H, W) -> rectified (H, W) in gray's dtype."""
        H, W = gray.shape
        coord = self.vy.to(gray.dtype)
        f = torch.floor(coord)
        t = coord - f
        i0 = f.long() % H
        i1 = (i0 + 1) % H
        cols = torch.arange(W, device=gray.device).expand(H, -1)
        mid = (1 - t) * gray[i0, cols] + t * gray[i1, cols]
        coord = self.hx.to(gray.dtype)
        f = torch.floor(coord)
        t = coord - f
        j0 = f.long() % W
        j1 = (j0 + 1) % W
        rows = torch.arange(H, device=gray.device)[:, None].expand(-1, W)
        out = (1 - t) * mid[rows, j0] + t * mid[rows, j1]
        return torch.where(self.valid, out, torch.zeros_like(out))


def to_gray(img, dtype=F64):
    """BT.601 luma of an (H, W, 3) image taken in the channel order given."""
    x = img.to(dtype)
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


# ---- SGM ------------------------------------------------------------------
# Every function takes a batch of frames: (B, H, W) images, (B, H, W, D) volumes.

def _edge(a, axis, lo, hi):
    n = a.shape[axis]
    idx = torch.arange(-lo, n + hi, device=a.device).clamp(0, n - 1)
    return a.index_select(axis, idx)


def xsobel(gray, cap, dtype):
    g = gray.to(dtype)
    p = _edge(_edge(g, 1, 1, 1), 2, 1, 1)
    dx = ((p[:, :-2, 2:] - p[:, :-2, :-2]) + 2.0 * (p[:, 1:-1, 2:] - p[:, 1:-1, :-2])
          + (p[:, 2:, 2:] - p[:, 2:, :-2]))
    return torch.clamp(dx + cap, 0.0, 2.0 * cap)


def bt_bounds(v):
    left = torch.floor(0.5 * (v + _edge(v, 2, 1, 0)[..., :-1]))
    right = torch.floor(0.5 * (v + _edge(v, 2, 0, 1)[..., 1:]))
    return torch.minimum(torch.minimum(left, right), v), torch.maximum(torch.maximum(left, right), v)


def cost_volume(left, right, D, block, cap, border_cost, dtype):
    """(B, H, W, D) integer costs in units of half a BT level."""
    lv, rv = xsobel(left, cap, dtype), xsobel(right, cap, dtype)
    (llo, lhi), (rlo, rhi) = bt_bounds(lv), bt_bounds(rv)
    lv, llo, lhi, rv, rlo, rhi = (2.0 * a for a in (lv, llo, lhi, rv, rlo, rhi))
    B, H, W = lv.shape
    x = torch.arange(W, device=lv.device)
    raw = torch.zeros((B, H, W, D), dtype=dtype, device=lv.device)
    for d in range(D):
        Rv, Rlo, Rhi = (torch.roll(a, d, 2) for a in (rv, rlo, rhi))
        c = torch.minimum(torch.clamp(torch.maximum(lv - Rhi, Rlo - lv), min=0.0),
                          torch.clamp(torch.maximum(Rv - lhi, llo - Rv), min=0.0))
        raw[..., d] = torch.where(x >= d, c, torch.zeros_like(c))
    r = block // 2
    for axis in (1, 2):
        ext = _edge(raw, axis, r, r)
        n = raw.shape[axis]
        acc = ext.narrow(axis, 0, n)
        for k in range(1, block):
            acc = acc + ext.narrow(axis, k, n)
        raw = acc
    cost = torch.trunc(raw)
    bad = x[:, None] < torch.arange(D, device=lv.device)[None, :] + r
    return torch.where(bad, torch.full_like(cost, float(border_cost)), cost)


def _path(cost, S, axis, reverse, p1, p2):
    """S += the scanline path of `cost` along axis (1 down the rows, 2 along
    the columns)."""
    n = cost.shape[axis]
    pad = torch.nn.functional.pad
    carry = torch.zeros_like(cost.select(axis, 0))
    for s in (range(n - 1, -1, -1) if reverse else range(n)):
        c = cost.select(axis, s)
        m = carry.min(dim=-1, keepdim=True).values
        nb = torch.minimum(pad(carry[..., :-1], (1, 0), value=float("inf")),
                           pad(carry[..., 1:], (0, 1), value=float("inf")))
        cand = torch.minimum(torch.minimum(carry, m + p2), nb + p1)
        carry = c + cand - m
        S.select(axis, s).add_(carry)


def sgm(left, right, m: dict, dtype=torch.float32):
    """(disparity (B, H, W) with -1 on invalid pixels, valid) of rectified
    pairs (B, H, W)."""
    D, block = m["num_disparities"], m["block_size"]
    p1 = 2.0 * 8 * m["channels"] * block * block
    p2 = 2.0 * m["p2_factor"] * m["channels"] * block * block
    cost = cost_volume(left, right, D, block, float(m["pre_filter_cap"]),
                       2 * m["border_cost"], dtype)
    S = torch.zeros_like(cost)
    for axis, reverse in ((2, False), (2, True), (1, False), (1, True)):
        _path(cost, S, axis, reverse, p1, p2)
    del cost
    W = S.shape[2]
    d0 = torch.argmin(S, dim=-1)  # ties to the smaller disparity
    best = S.min(dim=-1).values
    d0c = d0.clamp(1, D - 2)
    cm = torch.gather(S, -1, (d0c - 1)[..., None])[..., 0]
    cp = torch.gather(S, -1, (d0c + 1)[..., None])[..., 0]
    denom = torch.clamp(cm + cp - 2.0 * best, min=1e-6)
    delta = torch.clamp((cm - cp) / (2.0 * denom), -0.5, 0.5)
    inner = (d0 >= 1) & (d0 <= D - 2)
    disp = torch.where(inner, d0c.to(dtype) + delta, d0.to(dtype))
    x = torch.arange(W, device=S.device)
    valid = x >= d0
    lanes = torch.arange(D, device=S.device)
    far = (lanes - d0[..., None]).abs() > 1
    second = torch.where(far, S, torch.full_like(S, float("inf"))).min(dim=-1).values
    valid &= second * 100.0 > best * (100.0 + m["uniqueness_ratio"])
    # the right view's winners: S_R(x, d) = S(x + d, d)
    T = torch.full_like(S, float("inf"))
    for d in range(D):
        T[:, :, :W - d, d] = S[:, :, d:, d]
    del S
    dR = torch.argmin(T, dim=-1)
    del T
    G = torch.gather(dR, 2, (x - d0).clamp(min=0))
    valid &= (d0 - G).abs() <= m["disp12_max_diff"]
    valid &= speckle_box_count(disp, valid, m)
    return torch.where(valid, disp, torch.full_like(disp, -1.0)), valid


def speckle_box_count(disp, valid, m: dict):
    """Keep a valid pixel when more than speckle_window_size valid pixels of
    its disparity band lie in the side x side window around it (zero
    outside the image), for either of two bandings offset by half a band."""
    rng, win = float(m["speckle_range"]), int(m["speckle_window_size"])
    side = 2 * int(2.5 * math.sqrt(win) / 2.0 + 1.0) + 1
    r = side // 2
    dmax = -(-m["num_disparities"] // 128) * 128
    nb = int(dmax / rng) + 2
    score = torch.zeros(disp.shape, dtype=torch.int64, device=disp.device)
    for ph in (0.0, 0.5 * rng):
        band = torch.floor((disp.to(torch.float32) + ph) / rng).long()
        inside = (band >= 0) & (band < nb)
        occ = torch.stack([valid & (band == b) for b in range(nb)], 1).to(torch.float64)
        cnt = torch.nn.functional.avg_pool2d(occ, side, stride=1, padding=r,
                                             count_include_pad=True) * (side * side)
        mine = torch.gather(cnt, 1, band.clamp(0, nb - 1)[:, None])[:, 0].round().long()
        score = torch.maximum(score, torch.where(inside, mine, torch.zeros_like(mine)))
    return score > win


# ---- WLS ------------------------------------------------------------------

def _solve(wl, wr, diag, rhs, axis):
    """Thomas algorithm along `axis` of (B, H, W) planes, in the stated
    arithmetic: inv = 1 / den, cp = -wr inv, dp = (rhs + wl dp) inv,
    u = dp - cp u, each operation rounded on its own."""
    n = rhs.shape[axis]
    cp = torch.empty_like(rhs)
    dp = torch.empty_like(rhs)
    c_prev = torch.zeros_like(rhs.select(axis, 0))
    d_prev = torch.zeros_like(c_prev)
    for i in range(n):
        a = wl.select(axis, i)
        den = diag.select(axis, i) + a * c_prev
        # a line with no confidence at all is singular: its pivot is held
        # at 1e-12 and, its right side being 0, it solves to 0
        den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
        inv = 1.0 / den
        c_prev = -wr.select(axis, i) * inv
        d_prev = (rhs.select(axis, i) + a * d_prev) * inv
        cp.select(axis, i).copy_(c_prev)
        dp.select(axis, i).copy_(d_prev)
    u = torch.zeros_like(c_prev)
    out = torch.empty_like(rhs)
    for i in range(n - 1, -1, -1):
        u = dp.select(axis, i) - cp.select(axis, i) * u
        out.select(axis, i).copy_(u)
    return out


def lambdas(w: dict) -> list:
    """lambda_t of each sweep, float32(lam) * float32(1.5 4^(T-t-1) / (4^T - 1))
    rounded to float32, as the configuration states."""
    T = int(w["iterations"])
    return [float(np.float32(w["lam"]) * np.float32(1.5 * 4.0 ** (T - t - 1) / (4.0 ** T - 1)))
            for t in range(T)]


def wls(disp, valid, guide, w: dict, dtype=F64):
    """The smoother of SGM disparities `disp` (B, H, W) with validity
    `valid` under the gray guides (B, H, W), every step in `dtype`."""
    g = guide.to(dtype)
    conf = valid.to(dtype)
    u = torch.where(valid, disp.to(dtype), torch.zeros((), dtype=dtype, device=disp.device))
    sig = float(w["sigma_color"])
    weights = []
    for axis in (2, 1):
        e = torch.clamp(torch.exp(-torch.diff(g, dim=axis).abs() / sig), min=1e-6)
        zero = torch.zeros_like(e.narrow(axis, 0, 1))
        weights.append((torch.cat([zero, e], axis), torch.cat([e, zero], axis)))
    for lt in lambdas(w):
        for axis, (wl, wr) in zip((2, 1), weights):
            wl_t, wr_t = wl * lt, wr * lt
            u = _solve(wl_t, wr_t, conf + wl_t + wr_t, conf * u, axis)
    return u


# ---- depth and cloud ---------------------------------------------------------

def q_matrix(f, B, cx, cy, dtype=F64, device="cpu"):
    Q = torch.zeros((4, 4), dtype=dtype, device=device)
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3], Q[1, 3], Q[2, 3], Q[3, 2] = -cx, -cy, f, 1.0 / B
    return Q


def depth_and_cloud(disp, Q, color, z_range=(1e-3, 20.0), dtype=F64):
    """(depth (H, W), points (H*W, 3), valid (H*W,), colours (H*W, 3)) of a
    disparity (H, W) under Q, coloured by the uint8 image `color`."""
    d = disp.to(dtype)
    Q = Q.to(dtype)
    H, W = d.shape
    z = Q[2, 3] / (Q[3, 2] * d + Q[3, 3])
    depth = torch.where(d > 0, z.abs(), torch.zeros_like(z))
    y, x = torch.meshgrid(torch.arange(H, dtype=dtype, device=d.device),
                          torch.arange(W, dtype=dtype, device=d.device), indexing="ij")
    h = torch.stack([x, y, d, torch.ones_like(d)], -1) @ Q.T
    pts = (h[..., :3] / h[..., 3:4]).reshape(-1, 3)
    valid = (d.reshape(-1) > 0) & (pts[:, 2] > z_range[0]) & (pts[:, 2] < z_range[1])
    valid &= torch.isfinite(pts).all(1)
    cols = color.to(dtype).reshape(-1, 3) / 255.0
    return depth, pts, valid, cols
