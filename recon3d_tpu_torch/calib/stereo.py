"""Rectification maps (twin of recon3d_tpu/calib/stereo.py: `rectify_maps`,
cv2.initUndistortRectifyMap as float maps)."""
from __future__ import annotations

from typing import Tuple

import torch

from recon3d_tpu_torch.calib import model as _m


def rectify_maps(K, dist, R, P, image_size: Tuple[int, int],
                 device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2.initUndistortRectifyMap: for every rectified pixel, the source
    pixel in the raw image. Returns (map_x, map_y) float32 (H, W) on
    `device`, computed in float32 as the JAX package computes them."""
    nx, ny = image_size
    dtype = torch.float32
    K, P, R = (torch.as_tensor(a, dtype=dtype, device=device) for a in (K, P, R))
    u = torch.arange(nx, dtype=dtype, device=device)
    v = torch.arange(ny, dtype=dtype, device=device)
    gv, gu = torch.meshgrid(v, u, indexing="ij")
    # rectified pixel -> normalized rectified ray (invert P)
    x = (gu - P[0, 2]) / P[0, 0]
    y = (gv - P[1, 2]) / P[1, 1]
    rays = torch.stack([x, y, torch.ones_like(x)], -1) @ torch.linalg.inv(R).T
    xy = rays[..., :2] / rays[..., 2:3]
    xyd = _m.distort_normalized(xy, torch.as_tensor(dist, dtype=dtype, device=device))
    map_x = K[0, 0] * xyd[..., 0] + K[0, 1] * xyd[..., 1] + K[0, 2]
    map_y = K[1, 1] * xyd[..., 1] + K[1, 2]
    return map_x, map_y
