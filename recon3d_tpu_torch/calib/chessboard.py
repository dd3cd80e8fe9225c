"""Chessboard corner detection and sub-pixel refinement (twin of
recon3d_tpu/calib/chessboard.py).

The reference's detection path: histogram-equalize + Gaussian-blur the
grayscale, cv2.findChessboardCorners, then cv2.cornerSubPix. Here the
preprocessing and the sub-pixel refinement are PyTorch (the refinement is a
batch of small weighted least-squares solves, all corners at once), and the
initial detection is the built-in saddle-point detector: the port does not
use OpenCV, so `detector="opencv"` takes the built-in path too, as the JAX
package does where cv2 is not installed.

The built-in detector scores saddles as sxy^2 - sxx * syy of Gaussian-
weighted gradient products, which is <= 0 everywhere (Cauchy-Schwarz), so
its threshold keeps only rounding noise and it does not find a board (in
either package). `corner_subpix` does not depend on it: fed initial corners
from elsewhere it refines them as cv2.cornerSubPix does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.calib.model import _device_of
from recon3d_tpu_torch.ops import image as im


def preprocess(gray: torch.Tensor, blur_ksize: int = 5) -> torch.Tensor:
    """Equalize + blur."""
    return im.gaussian_blur(im.histogram_equalize(gray), ksize=blur_ksize)


def corner_subpix(gray: torch.Tensor, corners: torch.Tensor, win: int = 11,
                  iterations: int = 30, eps: float = 1e-3, device=None) -> torch.Tensor:
    """cv2.cornerSubPix: iterate corners to the gradient saddle point.

    gray: (H, W) float; corners: (N, 2) pixel coords; the result float32 on
    `device` (default: gray's device, the card for numpy). win is the half
    window (cv2's winSize=(11, 11) means half window
    11 -> 23x23 samples). For each corner q, solves
    sum_w [grad grad^T] q' = sum_w [grad grad^T] p over the window with
    OpenCV's Gaussian weights, a 2x2 solve, for `iterations` steps; a step
    shorter than eps is not taken. All corners refine together.
    """
    dev = _device_of(gray, device=device)
    g = torch.as_tensor(gray).to(dtype=torch.float32, device=dev)
    n = 2 * win + 1
    ar = torch.arange(n, dtype=torch.float32, device=dev) - win
    # OpenCV mask: exp(-((i - win) / win)^2), separable
    r = ar / win
    w1 = torch.exp(-r * r)
    mask = w1[:, None] * w1[None, :]
    dy, dx = torch.meshgrid(ar, ar, indexing="ij")
    q = torch.as_tensor(corners).to(dtype=torch.float32, device=dev)

    def wsum(a):
        return torch.sum(a, (-2, -1))

    for _ in range(iterations):
        # the window around each q, with central differences
        ys = q[:, 1, None, None] + dy
        xs = q[:, 0, None, None] + dx

        def ip(ddx, ddy):
            return im.bilinear_sample(g, xs + ddx, ys + ddy)

        gx = (ip(1.0, 0.0) - ip(-1.0, 0.0)) * 0.5
        gy = (ip(0.0, 1.0) - ip(0.0, -1.0)) * 0.5
        a = wsum(mask * gx * gx)
        b = wsum(mask * gx * gy)
        cc = wsum(mask * gy * gy)
        bb1 = wsum(mask * gx * gx * dx + mask * gx * gy * dy)
        bb2 = wsum(mask * gx * gy * dx + mask * gy * gy * dy)
        det = a * cc - b * b
        inv_ok = torch.abs(det) > 1e-12
        safe = torch.where(inv_ok, det, torch.ones_like(det))
        zero = torch.zeros_like(det)
        dqx = torch.where(inv_ok, (cc * bb1 - b * bb2) / safe, zero)
        dqy = torch.where(inv_ok, (a * bb2 - b * bb1) / safe, zero)
        step = torch.stack([dqx, dqy], -1)
        step = torch.where(torch.linalg.norm(step, dim=-1, keepdim=True) < eps,
                           torch.zeros_like(step), step)
        q = q + step
    return q


def _native_detect(gray: np.ndarray, pattern_size: Tuple[int, int],
                   device="cuda") -> Optional[np.ndarray]:
    """Built-in detector: Harris-like saddle response + grid ordering (the
    response is computed on `device`, the selection on the host)."""
    nx, ny = pattern_size
    g = torch.as_tensor(np.asarray(gray, np.float32), device=device)
    g = im.gaussian_blur(g, 5, 1.5)
    gx, gy = im.sobel(g)
    # structure tensor, saddle measure = -det(second-moment-ish via products)
    sxx = im.gaussian_blur(gx * gx, 7, 2.0)
    syy = im.gaussian_blur(gy * gy, 7, 2.0)
    sxy = im.gaussian_blur(gx * gy, 7, 2.0)
    resp = (sxy * sxy - sxx * syy + 0.0).cpu().numpy()
    H, W = resp.shape
    # non-max suppression on a coarse grid
    k = max(3, min(H, W) // (max(nx, ny) * 4) | 1)
    from scipy.ndimage import maximum_filter

    local_max = (resp == maximum_filter(resp, size=k)) & (resp > 0.2 * resp.max())
    ys, xs = np.nonzero(local_max)
    if len(xs) < nx * ny:
        return None
    order = np.argsort(resp[ys, xs])[::-1][: nx * ny * 2]
    pts = np.stack([xs[order], ys[order]], -1).astype(np.float64)
    # the nx * ny strongest, sorted into row-major grid order
    pts = pts[: nx * ny]
    idx = np.argsort(pts[:, 1])
    pts = pts[idx].reshape(ny, nx, 2)
    for r in range(ny):
        pts[r] = pts[r][np.argsort(pts[r, :, 0])]
    return pts.reshape(-1, 2)


def find_chessboard_corners(
    gray: np.ndarray,
    pattern_size: Tuple[int, int],
    refine: bool = True,
    detector: str = "opencv",
    subpix_win: int = 11,
    subpix_iterations: int = 30,
    subpix_eps: float = 1e-3,
    device="cuda",
) -> Tuple[bool, Optional[np.ndarray]]:
    """findChessboardCorners + cornerSubPix.

    Returns (found, corners (nx*ny, 2) float64) in OpenCV's row-major order.
    Every detector name takes the built-in detector (the port does not use
    OpenCV; the JAX package falls back to the same detector without cv2), so
    "opencv" answers as the JAX package does without cv2. The detector and
    the refinement run on `device`.
    """
    gray = np.asarray(gray)
    if gray.ndim == 3:
        gray = im.rgb_to_gray(torch.as_tensor(gray, device=device)).cpu().numpy()
    corners = _native_detect(gray, pattern_size, device)
    if corners is None:
        return False, None
    if refine:
        corners = corner_subpix(
            torch.as_tensor(np.asarray(gray, np.float32), device=device),
            torch.as_tensor(corners, dtype=torch.float32, device=device),
            win=subpix_win, iterations=subpix_iterations, eps=subpix_eps,
        ).cpu().numpy().astype(np.float64)
    return True, corners


def chessboard_object_points(pattern_size: Tuple[int, int], square_size: float) -> np.ndarray:
    """Planar board coordinates, z = 0, row-major as OpenCV orders corners."""
    nx, ny = pattern_size
    obj = np.zeros((nx * ny, 3), np.float64)
    obj[:, :2] = np.mgrid[0:nx, 0:ny].T.reshape(-1, 2) * square_size
    return obj
