"""Dense image ops on the depth path (twin of recon3d_tpu/ops/image.py:
`rgb_to_gray`, `normalize_minmax`, `colormap_jet`, `bilinear_sample`,
`remap`).

Where the JAX package computes a * b + c, XLA contracts it into one fused
multiply-add; `fma` computes that single rounding, so the port's bilinear
sums agree with the JAX package's bit for bit.
"""
from __future__ import annotations

import torch


def rgb_to_gray(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """ITU-R BT.601 luma, matching cv2.cvtColor COLOR_RGB2GRAY/COLOR_BGR2GRAY."""
    dtype = img.dtype if img.is_floating_point() else torch.float32
    w = torch.tensor([0.299, 0.587, 0.114], dtype=dtype, device=img.device)
    if order == "bgr":
        w = w.flip(0)
    return img.to(dtype) @ w


def normalize_minmax(img: torch.Tensor, lo: float = 0.0, hi: float = 255.0) -> torch.Tensor:
    """cv2.normalize(NORM_MINMAX)."""
    mn, mx = img.min(), img.max()
    return (img - mn) * ((hi - lo) / torch.clamp(mx - mn, min=1e-12)) + lo


def colormap_jet(norm01: torch.Tensor) -> torch.Tensor:
    """cv2.COLORMAP_JET over values in [0, 1] -> float RGB in [0, 1]."""
    v = torch.clamp(norm01, 0.0, 1.0)
    four = 4.0 * v
    r = torch.clamp(torch.minimum(four - 1.5, -four + 4.5), 0.0, 1.0)
    g = torch.clamp(torch.minimum(four - 0.5, -four + 3.5), 0.0, 1.0)
    b = torch.clamp(torch.minimum(four + 0.5, -four + 2.5), 0.0, 1.0)
    return torch.stack([r, g, b], -1)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors with one rounding, as a fused
    multiply-add gives it (CUDA's __fmaf_rn, XLA's contraction of a * b + c).

    The product is exact in float64 (24 + 24 bits). The float64 sum is
    rounded to odd (its error comes from a TwoSum) so that rounding it once
    more to float32 gives the correctly rounded result.
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # s + err == p + c exactly
    bits = s.view(torch.int64)
    # inexact and even: step one ulp toward the exact sum, to the odd neighbour
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits)
    return bits.view(torch.float64).to(torch.float32)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    border_value: float = 0.0) -> torch.Tensor:
    """Sample img (H, W[, C]) at float coords (x, y); constant border.

    The core of cv2.remap(INTER_LINEAR, BORDER_CONSTANT). x / y may be any
    (broadcastable) shape; returns samples of that shape [+C].
    """
    H, W = img.shape[0], img.shape[1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def gather(yi, xi):
        v = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        if img.ndim == 3:
            inb = inb[..., None]
        return torch.where(inb, v, torch.tensor(border_value, dtype=img.dtype,
                                                 device=img.device))

    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    if img.ndim == 3:
        w00, w10, w01, w11 = (w[..., None] for w in (w00, w10, w01, w11))
    # ((w00 g00 + w10 g10) + w01 g01) + w11 g11, contracted as XLA does
    out = fma(w00, gather(y0i, x0i), w10 * gather(y0i, x0i + 1))
    out = fma(w01, gather(y0i + 1, x0i), out)
    return fma(w11, gather(y0i + 1, x0i + 1), out)


def remap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
          border_value: float = 0.0) -> torch.Tensor:
    """cv2.remap(INTER_LINEAR): out[i, j] = img(map_y[i, j], map_x[i, j])."""
    return bilinear_sample(img.to(torch.float32), map_x, map_y, border_value)
