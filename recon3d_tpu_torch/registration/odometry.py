"""Direct RGB-D odometry, hybrid photometric + geometric term (twin of
recon3d_tpu/registration/odometry.py).

Replaces o3d.pipelines.odometry.compute_rgbd_odometry with
RGBDOdometryJacobianFromHybridTerm (test/check90.py:202-206,
test/colorReco.py:136-142): coarse-to-fine Gauss-Newton on dense image
alignment, minimizing per pixel

    r_I = I_tgt(w(p)) - I_src(p)          (photometric)
    r_Z = Z_tgt(w(p)) - [T p]_z           (geometric)

over the 6-dof twist of T (source -> target camera). Gradients are central
differences, Huber weights tame occlusion outliers, and every Gauss-Newton
sweep is whole-image tensor ops with no host read (a fixed number of sweeps
a level).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.ops import image as im
from recon3d_tpu_torch.registration import se3
from recon3d_tpu_torch.utils.types import CameraIntrinsics, RGBDImage


class OdometryResult(NamedTuple):
    success: torch.Tensor
    transformation: torch.Tensor  # (4, 4) target_from_source
    information: torch.Tensor  # (6, 6)
    inlier_fraction: torch.Tensor


def _level_intr(fx, fy, cx, cy, level):
    """Pyramid level intrinsics in float32, as the JAX package computes them."""
    s = np.float32(0.5 ** level)
    h = np.float32(0.5)
    return fx * s, fy * s, (cx + h) * s - h, (cy + h) * s - h


def _gn_level(I0, Z0, I1, Z1, fx, fy, cx, cy, T0, iterations: int, depth_diff_max: float,
              sigma_i: float, sigma_z: float, sweep_bound: int = 0):
    """`iterations` Gauss-Newton sweeps at one level; returns (T, the last
    sweep's normal matrix, its inlier fraction). sweep_bound > 0 warps the
    six target images with the bounded plane sweep (sweep_bilinear_stack),
    else with per-pixel bilinear gathers."""
    H, W = I0.shape
    dev = I0.device
    fx, fy, cx, cy = (float(v) for v in (fx, fy, cx, cy))  # float32 values
    gx1, gy1 = im.central_gradients(I1)
    zx1, zy1 = im.central_gradients(Z1)
    tgt_stack = torch.stack([I1, Z1, gx1, gy1, zx1, zy1]) if sweep_bound else None

    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    valid0 = (Z0 > 1e-3) & torch.isfinite(Z0)
    x0 = (u - cx) / fx * Z0
    y0 = (v - cy) / fy * Z0
    P0 = torch.stack([x0, y0, Z0], -1)  # (H, W, 3)
    ez = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    ez[..., 2] = 1.0 / sigma_z
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def hw(r, k=1.345):  # Huber weights
        a = torch.abs(r)
        return torch.where(a <= k, 1.0, k / torch.clamp(a, min=1e-12))

    T = T0
    A = frac = None
    for _ in range(iterations):
        P = P0 @ T[:3, :3].T + T[:3, 3]
        X, Y, Z = P[..., 0], P[..., 1], torch.clamp(P[..., 2], min=1e-6)
        uu = fx * X / Z + cx
        vv = fy * Y / Z + cy
        inb = ((uu >= 1) & (uu < W - 2) & (vv >= 1) & (vv < H - 2) & valid0
               & (P[..., 2] > 1e-3))
        if sweep_bound:
            I1w, Z1w, gxw, gyw, zxw, zyw = im.sweep_bilinear_stack(
                tgt_stack, uu, vv, sweep_bound, sweep_bound)
        else:
            I1w, Z1w, gxw, gyw, zxw, zyw = (im.bilinear_sample(img, uu, vv)
                                            for img in (I1, Z1, gx1, gy1, zx1, zy1))
        zvalid = (Z1w > 1e-3) & inb
        r_i = (I1w - I0) / sigma_i
        r_z = (Z1w - P[..., 2]) / sigma_z
        ok = zvalid & (torch.abs(Z1w - P[..., 2]) < depth_diff_max)

        # projection Jacobian d(uu, vv) / dP
        iz = 1.0 / Z
        zero = torch.zeros_like(iz)
        du = torch.stack([fx * iz, zero, -fx * X * iz * iz], -1)
        dv = torch.stack([zero, fy * iz, -fy * Y * iz * iz], -1)

        def JP(g_u, g_v, extra_z=None):
            # gradient wrt P: g_u du + g_v dv (minus e_z / sigma_z for r_z);
            # rotation: d(exp(w^) P)/dw = -hat(P), so g.(-hat(P) dw) = dw.(P x g)
            gP = g_u[..., None] * du + g_v[..., None] * dv
            if extra_z is not None:
                gP = gP - extra_z
            return torch.cat([gP, torch.linalg.cross(P, gP, dim=-1)], -1)  # (H, W, 6)

        Ji = JP(gxw / sigma_i, gyw / sigma_i)
        Jz = JP(zxw / sigma_z, zyw / sigma_z, extra_z=ez)
        w = ok.to(torch.float32)
        wi = w * hw(r_i)
        wz = w * hw(r_z)
        A = (torch.einsum("hwi,hwj,hw->ij", Ji, Ji, wi)
             + torch.einsum("hwi,hwj,hw->ij", Jz, Jz, wz)) + 1e-6 * eye6
        b = (torch.einsum("hwi,hw,hw->i", Ji, r_i, wi)
             + torch.einsum("hwi,hw,hw->i", Jz, r_z, wz))
        xi = -torch.linalg.solve_ex(A, b).result
        T = se3.se3_exp(xi) @ T
        frac = torch.mean(ok.to(torch.float32))
    return T, A, frac


def _gray(color: torch.Tensor) -> torch.Tensor:
    return im.rgb_to_gray(color) if color.ndim == 3 else color.to(torch.float32)


def compute_rgbd_odometry(
    source: RGBDImage,
    target: RGBDImage,
    intrinsics: CameraIntrinsics,
    init: torch.Tensor = None,
    levels: int = 3,
    iterations: Tuple[int, ...] = (10, 10, 10),
    depth_diff_max: float = 0.07,
    min_inlier_fraction: float = 0.1,
    warp: str = "auto",
    sweep_bound: int = 48,
) -> OdometryResult:
    """Hybrid RGB-D odometry (check90.py:202-206 semantics); returns
    target_from_source. Gray intensities are normalized to [0, 1].

    warp: "gather" samples with per-pixel bilinear gathers (exact; what the
    card runs); "sweep" with the gather-free bounded plane sweep of the
    JAX package's TPU path (pixels displaced more than sweep_bound px at
    the finest level count as outliers; the bound halves a level); "auto"
    is "gather": the card has gathers."""
    if warp == "auto":
        warp = "gather"
    if warp not in ("gather", "sweep"):
        raise ValueError(f"unknown warp mode {warp!r}")
    I0 = _gray(source.color)
    I1 = _gray(target.color)
    mx = torch.clamp(torch.maximum(torch.max(I0), torch.max(I1)), min=1.0)
    I0, I1 = I0 / mx, I1 / mx
    Z0 = source.depth.to(torch.float32)
    Z1 = target.depth.to(torch.float32)

    pyr_I0 = im.pyramid(I0, levels)
    pyr_I1 = im.pyramid(I1, levels)
    # depth pyramids use stride decimation (blurring depth mixes surfaces)
    pyr_Z0 = [Z0[::2 ** lv, ::2 ** lv] for lv in range(levels)]
    pyr_Z1 = [Z1[::2 ** lv, ::2 ** lv] for lv in range(levels)]

    dev = Z0.device
    T = (torch.eye(4, dtype=torch.float32, device=dev) if init is None
         else torch.as_tensor(init, dtype=torch.float32, device=dev))
    f0 = [np.float32(v) for v in (intrinsics.fx, intrinsics.fy, intrinsics.cx, intrinsics.cy)]
    info = torch.eye(6, dtype=torch.float32, device=dev)
    frac = torch.tensor(0.0, device=dev)
    for lv in reversed(range(levels)):
        fx, fy, cx, cy = _level_intr(*f0, lv)
        T, info, frac = _gn_level(
            pyr_I0[lv], pyr_Z0[lv], pyr_I1[lv], pyr_Z1[lv], fx, fy, cx, cy, T,
            iterations=iterations[min(lv, len(iterations) - 1)],
            depth_diff_max=depth_diff_max, sigma_i=0.1, sigma_z=0.05,
            sweep_bound=max(4, sweep_bound >> lv) if warp == "sweep" else 0)
    return OdometryResult(success=frac >= min_inlier_fraction, transformation=T,
                          information=info, inlier_fraction=frac)
