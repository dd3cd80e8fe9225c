"""StereoMatcher: the user-facing disparity / depth API (twin of
recon3d_tpu/depth/matcher.py).

`compute_disparity` takes a rectified gray pair to a (refined) disparity.
backend 'cuda' runs the kernel path (depth/sgm_cuda.py with the box-count
speckle filter, then depth/wls_cuda.py): hand-written kernels on CUDA
tensors, their plain versions on CPU tensors, as the JAX package runs its
Pallas kernels in interpret mode off the TPU. backend 'torch' runs the
plain oracle (depth/sgm.py with exact speckle labeling, depth/wls.py).
backend 'auto' resolves by device as the JAX package resolves it by
platform: the kernel path for CUDA tensors, the oracle for CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from recon3d_tpu_torch.config import StereoMatcherConfig, WLSConfig
from recon3d_tpu_torch.depth import sgm as _sgm
from recon3d_tpu_torch.depth import sgm_cuda as _sgmc
from recon3d_tpu_torch.depth import wls as _wls
from recon3d_tpu_torch.depth import wls_cuda as _wlsc
from recon3d_tpu_torch.ops import image as im


def uses_kernel_path(backend: str, device: torch.device) -> bool:
    """Whether `backend` runs the kernel path for tensors on `device`:
    'cuda' always, 'torch' never, 'auto' for CUDA tensors only (JAX's
    'auto' is the Pallas path on a TPU and the XLA oracle elsewhere)."""
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend == "cuda" or (backend == "auto" and torch.device(device).type == "cuda")


def compute_disparity(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    matcher: StereoMatcherConfig = StereoMatcherConfig(),
    wls: WLSConfig = WLSConfig(),
    with_wls: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gray pair -> (disparity float32 px, valid bool). Dense if with_wls."""
    if matcher.mode == "bm":
        # StereoBM: pure block SAD, no path smoothness
        num_directions, p1, p2 = 4, 0.0, 0.0
    else:
        num_directions = {"sgm8": 8, "sgm3": 3}.get(matcher.mode, 4)
        p1, p2 = float(matcher.p1()), float(matcher.p2())
    kernel_path = uses_kernel_path(matcher.backend, left_gray.device)
    kw = dict(
        num_disparities=matcher.num_disparities,
        block_size=matcher.block_size,
        p1=p1, p2=p2,
        num_directions=num_directions,
        uniqueness_ratio=matcher.uniqueness_ratio,
        disp12_max_diff=matcher.disp12_max_diff if matcher.lr_check else -1,
        speckle_window_size=matcher.speckle_window_size,
        speckle_range=float(matcher.speckle_range),
        pre_filter_cap=matcher.pre_filter_cap,
        do_subpixel=matcher.subpixel,
    )
    if kernel_path:
        speckle_method = matcher.speckle_method
        if speckle_method == "auto":
            speckle_method = "fast"
        disp, valid = _sgmc.sgm_disparity_cuda(left_gray, right_gray,
                                               speckle_method=speckle_method, **kw)
    else:
        disp, valid = _sgm.sgm_disparity(left_gray, right_gray, **kw)
    if with_wls:
        refine = _wlsc.wls_refine_cuda if kernel_path else _wls.wls_refine
        disp = refine(disp, valid, left_gray, lam=wls.lam, sigma_color=wls.sigma_color,
                      iterations=wls.iterations)
        valid = disp > 0
    return disp, valid


def disparity_to_depth(disparity: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Metric depth Z = Q23 / (Q32 * d + Q33); 0 where the disparity is <= 0."""
    Q = Q.to(torch.float32)
    denom = Q[3, 2] * disparity + Q[3, 3]
    z = Q[2, 3] / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    return torch.where(disparity > 0, z.abs(), 0.0)


def reproject_image_to_3d(disparity: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """cv2.reprojectImageTo3D: (H, W) disparity -> (H, W, 3) points through
    the full homogeneous transform [X Y Z W]^T = Q [x y d 1]^T."""
    Q = Q.to(torch.float32)
    H, W = disparity.shape
    dev = disparity.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    vec = torch.stack([x, y, disparity.to(torch.float32), torch.ones_like(x)], -1)
    out = vec @ Q.T
    w = out[..., 3:4]
    w = torch.where(w.abs() < 1e-12, 1e-12, w)
    return out[..., :3] / w


class StereoMatcher:
    """Object API over compute_disparity with live tuning.

    matcher = StereoMatcher(cfg, wls_cfg, Q=Q)
    disp, depth = matcher.compute(left_gray, right_gray)
    """

    def __init__(self, config: StereoMatcherConfig = StereoMatcherConfig(),
                 wls: WLSConfig = WLSConfig(), Q: Optional[torch.Tensor] = None,
                 with_wls: bool = True, device="cuda"):
        self.config = config
        self.wls = wls
        self.device = torch.device(device)
        self.Q = None if Q is None else torch.as_tensor(Q, dtype=torch.float32,
                                                        device=self.device)
        self.with_wls = with_wls

    def adjust(self, key: str) -> None:
        self.config = self.config.adjust(key)
        self.wls = self.wls.adjust(key)

    def compute(self, left, right) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        left = torch.as_tensor(left, device=self.device).to(torch.float32)
        right = torch.as_tensor(right, device=self.device).to(torch.float32)
        if left.ndim == 3:
            left = im.rgb_to_gray(left)
            right = im.rgb_to_gray(right)
        disp, _ = compute_disparity(left, right, self.config, self.wls, self.with_wls)
        depth = None if self.Q is None else disparity_to_depth(disp, self.Q)
        return disp, depth
