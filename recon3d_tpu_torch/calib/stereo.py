"""Rectification maps (twin of recon3d_tpu/calib/stereo.py: `rectify_maps`,
cv2.initUndistortRectifyMap as float maps)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg
import torch

from recon3d_tpu_torch.calib import model as _m
from recon3d_tpu_torch.ops.image import matmul3


def _inv3(R) -> torch.Tensor:
    """float32 inverse of a 3x3 as jnp.linalg.inv computes it on the host:
    LAPACK getrf, then getrs (two triangular solves) on the identity. On the
    CPU jaxlib calls SciPy's LAPACK, so this is the same arithmetic."""
    R = np.asarray(R, np.float32)
    return torch.from_numpy(scipy.linalg.lu_solve(scipy.linalg.lu_factor(R),
                                                  np.eye(3, dtype=np.float32)))


def rectify_maps(K, dist, R, P, image_size: Tuple[int, int],
                 device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2.initUndistortRectifyMap: for every rectified pixel, the source
    pixel in the raw image. Returns (map_x, map_y) float32 (H, W) on
    `device`.

    Computed on the host in float32, op for op as the JAX package computes
    them outside jit (one rounding per operation, the 3x3 products as
    `ops.image.matmul3`), then moved to `device`: the maps agree with the
    JAX package's bitwise, whichever device runs the frame.
    """
    nx, ny = image_size
    dtype = torch.float32
    K, P = (torch.as_tensor(np.asarray(a, np.float32)) for a in (K, P))
    Ri = _inv3(R)
    gv, gu = torch.meshgrid(torch.arange(ny, dtype=dtype), torch.arange(nx, dtype=dtype),
                            indexing="ij")
    # rectified pixel -> normalized rectified ray (invert P)
    x = (gu - P[0, 2]) / P[0, 0]
    y = (gv - P[1, 2]) / P[1, 1]
    rays = matmul3(torch.stack([x, y, torch.ones_like(x)], -1), Ri)
    xy = rays[..., :2] / rays[..., 2:3]
    xyd = _m.distort_normalized(xy, torch.as_tensor(np.asarray(dist, np.float32)))
    map_x = K[0, 0] * xyd[..., 0] + K[0, 1] * xyd[..., 1] + K[0, 2]
    map_y = K[1, 1] * xyd[..., 1] + K[1, 2]
    return map_x.to(device), map_y.to(device)
