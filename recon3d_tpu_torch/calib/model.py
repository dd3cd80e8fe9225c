"""Camera projection model: pinhole + full OpenCV distortion (twin of
recon3d_tpu/calib/model.py).

The complete 14-parameter OpenCV distortion vector
[k1 k2 p1 p2 k3 k4 k5 k6 s1 s2 s3 s4 tau_x tau_y]: rational radial,
tangential, thin prism and sensor tilt, as cv2.projectPoints /
cv2.undistortPoints define them. Each function computes in the dtype of
its inputs (float64 for calibration, float32 for the depth path's maps).

Everything here is differentiable with `torch.func.jacfwd`: no host read
of a tensor value and no Python branch on one, so the Levenberg-Marquardt
of calib/lm.py differentiates through the model. The branches of the JAX
package (the rotation's small-angle and near-pi forms, the sensor tilt's
`lax.cond`) are `torch.where` selections, whose derivative is the chosen
branch's, as `lax.cond`'s is. `rodrigues`, `inv_rodrigues` and
`project_points` also take leading batch axes (a pose a view) where the
JAX package maps over views with `vmap`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from recon3d_tpu_torch.ops.image import matmul3

# a distortion vector of at most 12 entries has no sensor-tilt terms
_TILT_FROM = 12


def pad_dist(dist) -> torch.Tensor:
    """Normalize a distortion vector to length 14 (zero-padded), in its own
    dtype (a Python list becomes torch's default float dtype)."""
    d = torch.as_tensor(dist).reshape(-1)[:14]
    if not d.is_floating_point():
        d = d.to(torch.get_default_dtype())
    return torch.cat([d, d.new_zeros((14 - d.shape[0],))])


def _has_tilt(dist) -> bool:
    """Whether the vector as given holds the sensor-tilt entries: decided by
    its length, never by its values."""
    return torch.as_tensor(dist).numel() > _TILT_FROM


def _skew_rows(k: torch.Tensor) -> torch.Tensor:
    """[k]_x of (..., 3) vectors -> (..., 3, 3)."""
    zero = torch.zeros_like(k[..., 0])
    return torch.stack([
        torch.stack([zero, -k[..., 2], k[..., 1]], -1),
        torch.stack([k[..., 2], zero, -k[..., 0]], -1),
        torch.stack([-k[..., 1], k[..., 0], zero], -1),
    ], -2)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (cv2.Rodrigues
    forward)."""
    rvec = torch.as_tensor(rvec)
    theta = torch.linalg.norm(rvec, dim=-1)[..., None, None]
    small = theta < 1e-12
    # guard the theta -> 0 limit
    safe = torch.where(small, torch.ones_like(theta), theta)
    K = _skew_rows(rvec / safe[..., 0])
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(small, eye + K * theta, R)


def inv_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3) (cv2.Rodrigues
    inverse)."""
    R = torch.as_tensor(R)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_t)[..., None]
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_t = torch.linalg.norm(v, dim=-1, keepdim=True) / 2.0
    # generic case
    axis_generic = v / torch.where(sin_t < 1e-12, torch.ones_like(sin_t), 2.0 * sin_t)
    # theta ~ pi: the axis from the diagonal of (R + I) / 2
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    B = (R + eye) / 2.0
    diag = torch.sqrt(torch.clamp(torch.diagonal(B, dim1=-2, dim2=-1), min=0.0))
    i = torch.argmax(diag, dim=-1, keepdim=True)
    d_i = torch.gather(diag, -1, i)
    col = torch.gather(B, -1, i[..., None, :].expand(*B.shape[:-1], 1))[..., 0]
    col = col / torch.where(d_i < 1e-12, torch.ones_like(d_i), d_i)
    axis_pi = col / torch.clamp(torch.linalg.norm(col, dim=-1, keepdim=True), min=1e-12)
    # the sign from v
    dot = torch.sum(axis_pi * v, -1, keepdim=True)
    axis_pi = axis_pi * torch.where(dot < 0, -torch.ones_like(dot), torch.ones_like(dot))
    near_pi = torch.abs(theta - torch.pi) < 1e-6
    axis = torch.where(near_pi, axis_pi, axis_generic)
    return torch.where(theta < 1e-12, v / 2.0, axis * theta)


def tilt_matrix(tau_x, tau_y, dtype=torch.float64) -> torch.Tensor:
    """OpenCV sensor-tilt projection matrix (computeTiltProjectionMatrix),
    float64 unless `dtype` says otherwise (the JAX package's default under
    the 64-bit mode its calibration runs in)."""
    tau_x = torch.as_tensor(tau_x, dtype=dtype)
    tau_y = torch.as_tensor(tau_y, dtype=dtype)
    cx, sx = torch.cos(tau_x), torch.sin(tau_x)
    cy, sy = torch.cos(tau_y), torch.sin(tau_y)
    one, zero = torch.ones_like(tau_x), torch.zeros_like(tau_x)
    Rx = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, cx, sx]),
                      torch.stack([zero, -sx, cx])])
    Ry = torch.stack([torch.stack([cy, zero, -sy]), torch.stack([zero, one, zero]),
                      torch.stack([sy, zero, cy])])
    R = Ry @ Rx
    P = torch.stack([torch.stack([R[2, 2], zero, -R[0, 2]]),
                     torch.stack([zero, R[2, 2], -R[1, 2]]),
                     torch.stack([zero, zero, one])])
    return P @ R


def _apply_h(xy: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """The homography T on (..., 2) points. float32 rounds the 3x3 product
    as `ops.image.matmul3` (the JAX package's host rounding, which keeps
    `rectify_maps` bitwise); other dtypes take a plain product."""
    h = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    h = matmul3(h, T) if xy.dtype == torch.float32 else h @ T.transpose(-1, -2)
    return h[..., :2] / h[..., 2:3]


def distort_normalized(xy: torch.Tensor, dist) -> torch.Tensor:
    """Apply distortion to normalized image coords xy (..., 2) -> (..., 2).

    Op for op the JAX function as it runs outside jit, one rounding per
    operation and the sensor tilt's 3x3 product as `ops.image.matmul3`, so
    float32 results agree bitwise. The tilt applies where the vector holds
    its entries (more than 12) and they are not both zero: a selection, as
    the JAX package's `lax.cond`, and no host read.
    """
    d = pad_dist(dist).to(dtype=xy.dtype, device=xy.device)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, tx, ty = [d[i] for i in range(14)]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4, r6 = r2 * r2, r2 * r2 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r4
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + s3 * r2 + s4 * r4
    out = torch.stack([xd, yd], -1)
    if not _has_tilt(dist):
        return out
    tilted = _apply_h(out, tilt_matrix(tx, ty, dtype=xy.dtype).to(xy.device))
    return torch.where((tx != 0.0) | (ty != 0.0), tilted, out)


def undistort_normalized(xy_d: torch.Tensor, dist, iters: int = 10) -> torch.Tensor:
    """Invert distort_normalized by fixed-point iteration
    (cv2.undistortPoints)."""
    d = pad_dist(dist).to(dtype=xy_d.dtype, device=xy_d.device)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, tx, ty = [d[i] for i in range(14)]
    if _has_tilt(dist):
        T = tilt_matrix(tx, ty, dtype=xy_d.dtype).to(xy_d.device)
        untilted = _apply_h(xy_d, torch.linalg.inv(T))
        xy_d = torch.where((tx != 0.0) | (ty != 0.0), untilted, xy_d)
    x0, y0 = xy_d[..., 0], xy_d[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        r4, r6 = r2 * r2, r2 * r2 * r2
        radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r4
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + s3 * r2 + s4 * r4
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    return torch.stack([x, y], -1)


def _device_of(*arrays, device=None) -> torch.device:
    """Where a calibration entry point runs: `device` if given, else the
    device of the first tensor among `arrays`, else the card (numpy inputs
    go to the card unless the caller asks for the CPU)."""
    if device is not None:
        return torch.device(device)
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cuda")


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a).to(dtype=ref.dtype, device=ref.device)


def project_points(obj_pts: torch.Tensor, rvec, tvec, K, dist=None) -> torch.Tensor:
    """cv2.projectPoints equivalent: world (..., N, 3) -> pixels (..., N, 2).

    rvec / tvec are (3,) or (..., 3) with the leading axes of obj_pts
    before its point axis (a pose a view)."""
    obj_pts = torch.as_tensor(obj_pts)
    R = rodrigues(_like(rvec, obj_pts))
    t = _like(tvec, obj_pts)
    cam = obj_pts @ R.transpose(-1, -2) + t[..., None, :]
    xy = cam[..., :2] / cam[..., 2:3]
    if dist is not None:
        xy = distort_normalized(xy, dist)
    K = _like(K, obj_pts)
    u = K[0, 0] * xy[..., 0] + K[0, 1] * xy[..., 1] + K[0, 2]
    v = K[1, 1] * xy[..., 1] + K[1, 2]
    return torch.stack([u, v], -1)


def undistort_points(pts: torch.Tensor, K, dist, R=None, P=None, iters: int = 10
                     ) -> torch.Tensor:
    """cv2.undistortPoints: pixels (..., 2) -> normalized (or re-projected
    by P)."""
    pts = torch.as_tensor(pts)
    K = _like(K, pts)
    x = (pts[..., 0] - K[0, 2]) / K[0, 0]
    y = (pts[..., 1] - K[1, 2]) / K[1, 1]
    xy = undistort_normalized(torch.stack([x, y], -1), dist, iters=iters)
    if R is not None:
        xy = _apply_h(xy, _like(R, pts))
    if P is not None:
        P = _like(P, pts)
        u = P[0, 0] * xy[..., 0] + P[0, 1] * xy[..., 1] + P[0, 2]
        v = P[1, 1] * xy[..., 1] + P[1, 2]
        return torch.stack([u, v], -1)
    return xy


def reprojection_errors(obj_pts, img_pts, rvec, tvec, K, dist
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean L2 reprojection error and RMS of one view."""
    img_pts = torch.as_tensor(img_pts)
    proj = project_points(obj_pts, rvec, tvec, K, dist)
    err = torch.linalg.norm(proj - img_pts, dim=-1)
    return torch.mean(err), torch.sqrt(torch.mean(torch.sum((proj - img_pts) ** 2, -1)))
