"""Camera distortion model (twin of recon3d_tpu/calib/model.py: `pad_dist`,
`tilt_matrix`, `distort_normalized`, the part rectification needs).

The full 14-parameter OpenCV distortion vector
[k1 k2 p1 p2 k3 k4 k5 k6 s1 s2 s3 s4 tau_x tau_y]: rational radial,
tangential, thin prism and sensor tilt. Computed in float32 unless the
caller passes float64 tensors, as the JAX package computes with 64-bit
floats off.
"""
from __future__ import annotations

import torch

from recon3d_tpu_torch.ops.image import matmul3


def pad_dist(dist) -> torch.Tensor:
    """Normalize a distortion vector to length 14 (zero-padded), float32."""
    d = torch.as_tensor(dist, dtype=torch.float32).reshape(-1)[:14]
    out = torch.zeros((14,), dtype=d.dtype, device=d.device)
    out[:d.shape[0]] = d
    return out


def tilt_matrix(tau_x, tau_y, dtype=torch.float32) -> torch.Tensor:
    """OpenCV sensor-tilt projection matrix (computeTiltProjectionMatrix)."""
    tau_x = torch.as_tensor(tau_x, dtype=dtype)
    tau_y = torch.as_tensor(tau_y, dtype=dtype)
    cx, sx = torch.cos(tau_x), torch.sin(tau_x)
    cy, sy = torch.cos(tau_y), torch.sin(tau_y)
    one, zero = torch.ones((), dtype=dtype), torch.zeros((), dtype=dtype)
    Rx = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, cx, sx]),
                      torch.stack([zero, -sx, cx])])
    Ry = torch.stack([torch.stack([cy, zero, -sy]), torch.stack([zero, one, zero]),
                      torch.stack([sy, zero, cy])])
    R = Ry @ Rx
    P = torch.stack([torch.stack([R[2, 2], zero, -R[0, 2]]),
                     torch.stack([zero, R[2, 2], -R[1, 2]]),
                     torch.stack([zero, zero, one])])
    return P @ R


def distort_normalized(xy: torch.Tensor, dist) -> torch.Tensor:
    """Apply distortion to normalized image coords xy (..., 2) -> (..., 2).

    Op for op the JAX function as it runs outside jit, one rounding per
    operation and the sensor tilt's 3x3 product as `ops.image.matmul3`, so
    float32 results agree bitwise.
    """
    d = pad_dist(dist).to(dtype=xy.dtype, device=xy.device)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, tx, ty = [d[i] for i in range(14)]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4, r6 = r2 * r2, r2 * r2 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r4
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + s3 * r2 + s4 * r4
    if float(tx) == 0.0 and float(ty) == 0.0:  # tilt is almost always zero
        return torch.stack([xd, yd], -1)
    T = tilt_matrix(tx, ty, dtype=xy.dtype).to(xy.device)
    h = matmul3(torch.stack([xd, yd, torch.ones_like(xd)], -1), T)
    return h[..., :2] / h[..., 2:3]
