"""Dense image ops on the depth and odometry paths (twin of
recon3d_tpu/ops/image.py: `rgb_to_gray`, `normalize_minmax`, `colormap_jet`,
`histogram_equalize`, `gaussian_blur`, `sobel`, `central_gradients`,
`bilinear_sample`, `remap`, `sweep_bilinear_stack`, `pyramid`,
`resize_bilinear`), and `matmul3`, the 3x3 product as the JAX package
rounds it.

Where the JAX package computes a * b + c, XLA contracts it into one fused
multiply-add; `fma` computes that single rounding, so the port's bilinear
sums agree with the JAX package's bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def histogram_equalize(gray: torch.Tensor) -> torch.Tensor:
    """cv2.equalizeHist on a uint8-range image (values 0..255), float32 in
    the same range. Integer counts and float32 arithmetic in the JAX
    package's order (both roundings half to even), so the result is exact."""
    g = torch.clamp(torch.round(gray.to(torch.float32)), 0, 255).to(torch.int32)
    hist = torch.bincount(g.reshape(-1).long(), minlength=256).to(torch.int32)
    cdf = torch.cumsum(hist, 0, dtype=torch.int32)
    total = g.numel()
    # OpenCV: scale by 255 / (N - cdf(min nonzero)), lut = round((cdf - cdfmin) * scale)
    nonzero_min = torch.min(torch.where(hist > 0, cdf, torch.full_like(cdf, total + 1)))
    denom = torch.clamp(total - nonzero_min, min=1)
    lut = torch.clamp(torch.round((cdf - nonzero_min).to(torch.float32) * 255.0
                                  / denom.to(torch.float32)), 0, 255)
    return lut[g.long()]


def _gaussian_kernel1d(ksize: int, sigma: float, device=None) -> torch.Tensor:
    if sigma <= 0:
        # OpenCV's default sigma from the kernel size
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = torch.arange(ksize, dtype=torch.float32, device=device) - (ksize - 1) / 2.0
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / torch.sum(k)


def _conv_taps(xp: torch.Tensor, k: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """Valid 1-D correlation of xp with the taps k along `dim` (n outputs)."""
    out = None
    for i in range(k.shape[0]):
        term = k[i] * xp.narrow(dim, i, n)
        out = term if out is None else out + term
    return out


def gaussian_blur(img: torch.Tensor, ksize: int = 5, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect-101 borders (cv2.GaussianBlur
    default) of an (H, W) or (H, W, C) image: the rows' pass, then the
    columns'."""
    x = img.to(torch.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    k = _gaussian_kernel1d(ksize, sigma, x.device)
    H, W = x.shape[0], x.shape[1]
    pad = ksize // 2
    xc = x.permute(2, 0, 1)[None]  # (1, C, H, W): reflect pads the last two dims
    xp = F.pad(xc, (0, 0, pad, pad), mode="reflect")
    xc = _conv_taps(xp, k, 2, H)
    xp = F.pad(xc, (pad, pad, 0, 0), mode="reflect")
    out = _conv_taps(xp, k, 3, W)[0].permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def sobel(gray: torch.Tensor):
    """3x3 Sobel gradients (gx, gy) with reflect-101 borders, each the exact
    sum of its taps rounded once to float32 (summed in float64: the same on
    every device; XLA's convolution sums in an order of its own, within a
    few ulps of this)."""
    g = gray.to(torch.float32)
    H, W = g.shape
    gp = F.pad(g[None, None], (1, 1, 1, 1), mode="reflect")[0, 0].to(torch.float64)

    def tap(dy, dx):
        return gp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    gx = (tap(-1, 1) - tap(-1, -1)) + 2.0 * (tap(0, 1) - tap(0, -1)) + (tap(1, 1) - tap(1, -1))
    gy = (tap(1, -1) - tap(-1, -1)) + 2.0 * (tap(1, 0) - tap(-1, 0)) + (tap(1, 1) - tap(-1, 1))
    return gx.to(torch.float32), gy.to(torch.float32)


def central_gradients(gray: torch.Tensor):
    """Central-difference gradients (gx, gy), zero at the borders (the
    odometry Jacobians)."""
    g = gray.to(torch.float32)
    gx = torch.zeros_like(g)
    gy = torch.zeros_like(g)
    gx[:, 1:-1] = (g[:, 2:] - g[:, :-2]) * 0.5
    gy[1:-1, :] = (g[2:, :] - g[:-2, :]) * 0.5
    return gx, gy


def pyramid(gray: torch.Tensor, levels: int) -> list:
    """Gaussian image pyramid (cv2.pyrDown chain) for coarse-to-fine odometry."""
    out = [gray.to(torch.float32)]
    for _ in range(levels - 1):
        blurred = gaussian_blur(out[-1], ksize=5, sigma=1.0)
        out.append(blurred[::2, ::2])
    return out


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


def matmul3(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """v @ M.T for (..., 3) rows and a 3x3 M, rounded as XLA's CPU matrix
    product (Eigen) rounds it outside jit, over the n rows of v flattened:
    in the blocks of 8 rows, output columns 0 and 1 as sequential sums
    (v0 m0 + v1 m1) + v2 m2 and column 2 as the fused multiply-add chain
    fma(v2, m2, fma(v1, m1, v0 m0)); the last n mod 8 rows, and all rows of
    a product of fewer than 16 rows, as the chain in every column. (Checked
    bitwise for n < 16 and n >= 32; products of 16-31 rows take further
    paths there. The port's callers multiply images and clouds.)"""
    shape = v.shape
    v = v.reshape(-1, 3)
    n = v.shape[0]
    Mx = M.to(v.dtype).expand(n, 3, 3)
    chain = torch.stack([fma(v[:, 2], Mx[:, j, 2], fma(v[:, 1], Mx[:, j, 1], v[:, 0] * M[j, 0]))
                         for j in range(3)], -1)
    blocked = 8 * (n // 8) if n >= 16 else 0
    if blocked:
        for j in range(2):
            chain[:blocked, j] = ((v[:blocked, 0] * M[j, 0] + v[:blocked, 1] * M[j, 1])
                                  + v[:blocked, 2] * M[j, 2])
    return chain.reshape(shape)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    border_value: float = 0.0) -> torch.Tensor:
    """Sample img (H, W[, C]) at float coords (x, y); constant border.

    The core of cv2.remap(INTER_LINEAR, BORDER_CONSTANT). x / y may be any
    (broadcastable) shape; returns samples of that shape [+C]. The weighted
    sum is contracted into fused multiply-adds as XLA contracts it inside
    jit.
    """
    return _bilinear(img, x, y, border_value, True)


def _bilinear(img, x, y, border_value, contract):
    """bilinear_sample; contract=False rounds every product and sum on its
    own, as the JAX package's function does when called outside jit."""
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
        return torch.where(inb, v, torch.full((), border_value, dtype=img.dtype,
                                              device=img.device))

    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    if img.ndim == 3:
        w00, w10, w01, w11 = (w[..., None] for w in (w00, w10, w01, w11))
    g00, g10 = gather(y0i, x0i), gather(y0i, x0i + 1)
    g01, g11 = gather(y0i + 1, x0i), gather(y0i + 1, x0i + 1)
    if not contract:
        return ((w00 * g00 + w10 * g10) + w01 * g01) + w11 * g11
    # ((w00 g00 + w10 g10) + w01 g01) + w11 g11, contracted as XLA does
    out = fma(w00, g00, w10 * g10)
    out = fma(w01, g01, out)
    return fma(w11, g11, out)


def remap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
          border_value: float = 0.0) -> torch.Tensor:
    """cv2.remap(INTER_LINEAR): out[i, j] = img(map_y[i, j], map_x[i, j])."""
    return bilinear_sample(img.to(torch.float32), map_x, map_y, border_value)


def _sweep_axis(stack: torch.Tensor, coord: torch.Tensor, bound: int, axis: int):
    """1-D linear resample of a (C, H, W) stack along `axis` (1 or 2) at the
    float positions `coord` (H, W) by a displacement-bounded plane sweep.

    Returns (values, valid): values[c, i, j] interpolates stack[c] along
    `axis` at coord[i, j]; valid marks samples whose tap displacement lies
    in [-bound, bound] and whose coord lies inside the image. The rolls
    wrap, but a wrapped tap is out of the image and so masked by `valid`."""
    n = stack.shape[axis]
    shape = [1, 1]
    shape[axis - 1] = n
    idx = torch.arange(n, dtype=torch.int32, device=coord.device).reshape(shape)
    c0 = torch.floor(coord)
    frac = (coord - c0).to(stack.dtype)
    disp = c0.to(torch.int32) - idx  # integer tap displacement
    acc0 = torch.zeros_like(stack)
    acc1 = torch.zeros_like(stack)
    for s in range(-bound, bound + 2):
        plane = torch.roll(stack, -s, dims=axis)
        acc0 = torch.where((disp == s)[None], plane, acc0)
        acc1 = torch.where((disp == s - 1)[None], plane, acc1)
    vals = (1.0 - frac)[None] * acc0 + frac[None] * acc1
    valid = (disp.abs() <= bound) & (coord >= 0) & (coord <= n - 1)
    return vals, valid


def sweep_bilinear_stack(imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                         bound_y: int, bound_x: int, border_value: float = 0.0) -> torch.Tensor:
    """Gather-free bilinear warp of a channel stack at bounded displacement:
    out[c, i, j] ~= imgs[c, y[i, j], x[i, j]] (bilinear, constant border).

    Two 1-D passes compose the 2-D warp (vertical, then horizontal), so the
    composed sample is imgs[y(i, x(i, j)), x(i, j)]: exact where the
    vertical map is constant along rows, first order elsewhere. Samples
    displaced beyond the bound, or outside the image, return border_value.
    imgs: (C, H, W); x, y: (H, W) float. The JAX package's TPU warp for
    odometry; on the card `compute_rgbd_odometry` gathers instead."""
    stack = imgs.to(torch.float32)
    tv, vy = _sweep_axis(stack, y, bound_y, axis=1)
    # carry the vertical validity through the horizontal resample so the
    # composed sample's mask is read at the column it reads
    tv = torch.cat([tv, vy[None].to(tv.dtype)], 0)
    out, vx = _sweep_axis(tv, x, bound_x, axis=2)
    valid = vx & (out[-1] > 0.999)
    return torch.where(valid[None], out[:-1],
                       torch.tensor(border_value, dtype=stack.dtype, device=stack.device))


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """cv2.resize(INTER_LINEAR) with half-pixel alignment, clamp-to-edge
    sampling (cv2.resize replicates the border); each operation rounds on
    its own, as the JAX package's function does outside jit."""
    H, W = img.shape[:2]
    h, w = out_hw
    ys = (torch.arange(h, dtype=torch.float32, device=img.device) + 0.5) * (H / h) - 0.5
    xs = (torch.arange(w, dtype=torch.float32, device=img.device) + 0.5) * (W / w) - 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gy = torch.clamp(gy, 0.0, H - 1.0)
    gx = torch.clamp(gx, 0.0, W - 1.0)
    return _bilinear(img, gx, gy, 0.0, False)
