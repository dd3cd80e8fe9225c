"""Stereo calibration, rectification and the rectification maps (twin of
recon3d_tpu/calib/stereo.py).

  stereo_calibrate   cv2.stereoCalibrate(CALIB_FIX_INTRINSIC): joint LM over
                     the rig transform and the per-view board poses.
  stereo_rectify     cv2.stereoRectify(CALIB_ZERO_DISPARITY): half-rotation
                     split, baseline-aligned global rotation, shared new
                     focal, corner-averaged principal points, P1 / P2 / Q.
  rectify_maps       cv2.initUndistortRectifyMap as float32 maps.

E = [T]x R, F = K2^-T E K1^-1. Calibration runs in float64 on the device
of its points; `stereo_rectify` in the dtype of K1 (float64 after a
calibration, float32 where the depth path rectifies a raw-schema NPZ).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import scipy.linalg
import torch

from recon3d_tpu_torch.calib import lm as _lm
from recon3d_tpu_torch.calib import model as _m
from recon3d_tpu_torch.calib import mono as _mono
from recon3d_tpu_torch.ops.image import matmul3


_skew = _m._skew_rows  # [v]_x of (..., 3) vectors


def _compose(rvec_a, tvec_a, rvec_b, tvec_b):
    """Pose composition: (R_a, t_a) applied after (R_b, t_b); any of the
    four may carry leading batch axes."""
    Ra, Rb = _m.rodrigues(rvec_a), _m.rodrigues(rvec_b)
    R = Ra @ Rb
    t = (Ra @ tvec_b[..., None])[..., 0] + tvec_a
    return _m.inv_rodrigues(R), t


class StereoCalibrationResult(NamedTuple):
    rms: torch.Tensor
    R: torch.Tensor  # (3,3) right-from-left rotation
    T: torch.Tensor  # (3,) translation
    E: torch.Tensor
    F: torch.Tensor
    per_view_errors: torch.Tensor  # (V, 2) mean px error (left, right)


def stereo_calibrate(
    obj_points: torch.Tensor,
    img_points_l: torch.Tensor,
    img_points_r: torch.Tensor,
    K1, dist1, K2, dist2,
    max_iterations: int = 60,
    device=None,
) -> StereoCalibrationResult:
    """cv2.stereoCalibrate with CALIB_FIX_INTRINSIC.

    obj_points (V, N, 3), img_points_* (V, N, 2), computed on `device`
    (default: the points' device, the card for numpy). Intrinsics are
    fixed; the LM optimizes [rvec_rig, tvec_rig, (rvec_i, tvec_i)_views]
    against both cameras' reprojection residuals. The per-view PnP starts
    run one view after another, as the JAX package's vmapped loops leave
    each finished view as it was.
    """
    dev = _m._device_of(img_points_l, img_points_r, obj_points, device=device)
    img_l = torch.as_tensor(img_points_l).to(dev)
    img_r = torch.as_tensor(img_points_r).to(dev)
    obj_points = torch.as_tensor(obj_points).to(dev)
    V = obj_points.shape[0]
    K1, K2 = _m._like(K1, obj_points), _m._like(K2, obj_points)
    dist1, dist2 = _m._like(dist1, obj_points), _m._like(dist2, obj_points)

    # init: per-view PnP in each camera, rig = chordal mean of the relative poses
    def pnp_all(img, K, dist):
        poses = [_mono.solve_pnp(obj_points[v], img[v], K, dist) for v in range(V)]
        return torch.stack([p[0] for p in poses]), torch.stack([p[1] for p in poses])

    rv_l, tv_l = pnp_all(img_l, K1, dist1)
    rv_r, tv_r = pnp_all(img_r, K2, dist2)
    Rl, Rr = _m.rodrigues(rv_l), _m.rodrigues(rv_r)
    R_rel = Rr @ Rl.transpose(-1, -2)
    tv_rel = tv_r - (R_rel @ tv_l[..., None])[..., 0]
    Ms = _m.rodrigues(_m.inv_rodrigues(R_rel))
    U, _, Vt = torch.linalg.svd(torch.sum(Ms, 0))
    R0 = U @ Vt
    R0 = R0 * torch.sign(torch.linalg.det(R0))
    rvec0 = _m.inv_rodrigues(R0)
    tvec0 = torch.mean(tv_rel, 0)

    x0 = torch.cat([rvec0, tvec0, rv_l.reshape(-1), tv_l.reshape(-1)])

    def unpack(x):
        return x[:3], x[3:6], x[6:6 + 3 * V].reshape(V, 3), x[6 + 3 * V:].reshape(V, 3)

    def project_both(x):
        rig_r, rig_t, rv, tv = unpack(x)
        proj_l = _m.project_points(obj_points, rv, tv, K1, dist1)
        rr, tr = _compose(rig_r, rig_t, rv, tv)
        return proj_l, _m.project_points(obj_points, rr, tr, K2, dist2)

    def residual(x):
        proj_l, proj_r = project_both(x)
        return torch.cat([(proj_l - img_l).reshape(-1), (proj_r - img_r).reshape(-1)])

    res = _lm.levenberg_marquardt(residual, x0, max_iterations=max_iterations)
    R = _m.rodrigues(res.x[:3])
    T = res.x[3:6]

    E = _skew(T) @ R
    F = torch.linalg.inv_ex(K2)[0].T @ E @ torch.linalg.inv_ex(K1)[0]
    F = F / torch.where(torch.abs(F[2, 2]) > 1e-12, F[2, 2], torch.ones_like(F[2, 2]))

    proj_l, proj_r = project_both(res.x)
    err_l = torch.mean(torch.linalg.norm(proj_l - img_l, dim=-1), 1)
    err_r = torch.mean(torch.linalg.norm(proj_r - img_r, dim=-1), 1)
    n_res = 2 * V * obj_points.shape[1] * 2
    rms = torch.sqrt(2.0 * res.cost / (n_res / 2))
    return StereoCalibrationResult(rms=rms, R=R, T=T, E=E, F=F,
                                   per_view_errors=torch.stack([err_l, err_r], -1))


class RectifyResult(NamedTuple):
    R1: torch.Tensor
    R2: torch.Tensor
    P1: torch.Tensor
    P2: torch.Tensor
    Q: torch.Tensor


def stereo_rectify(
    K1, dist1, K2, dist2,
    image_size: Tuple[int, int],
    R, T,
    zero_disparity: bool = True,
    alpha: float = -1.0,
    device=None,
) -> RectifyResult:
    """cv2.stereoRectify. image_size = (width, height).

    Splits R into half-rotations applied to each camera, rotates so the
    baseline is axis-aligned, shares the smaller focal, sets principal
    points from undistorted corner means and builds Q. alpha >= 0 applies
    OpenCV's inner / outer rectangle scaling blend. Computes in K1's dtype
    on `device` (default: K1's device, the card for numpy). Which axis the
    baseline takes is read on the host.
    """
    dev = _m._device_of(K1, device=device)
    K1 = torch.as_tensor(K1)
    dtype = K1.dtype

    def cvt(a):
        return torch.as_tensor(a).to(dtype=dtype, device=dev)

    K1, K2, R = cvt(K1), cvt(K2), cvt(R)
    T = cvt(T).reshape(-1)
    dist1, dist2 = cvt(dist1), cvt(dist2)
    nx, ny = image_size

    om = _m.inv_rodrigues(R)
    r_r = _m.rodrigues(om * -0.5)  # half-rotation applied to each camera
    t = r_r @ T
    idx = 0 if bool(torch.abs(t[0]) > torch.abs(t[1])) else 1

    # global rotation aligning the baseline with axis `idx`
    one = torch.ones_like(t[idx])
    uu = torch.zeros(3, dtype=dtype, device=dev)
    uu[idx] = torch.where(t[idx] > 0, one, -one)
    ww = torch.linalg.cross(t, uu)
    nw = torch.linalg.norm(ww)
    nt = torch.linalg.norm(t)
    ang = torch.arccos(torch.clamp(torch.abs(t[idx]) / torch.clamp(nt, min=1e-18), -1.0, 1.0))
    ww = torch.where(nw > 0, ww * (ang / torch.clamp(nw, min=1e-18)), ww)
    wR = _m.rodrigues(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t_new = R2 @ T

    # shared focal: average over cameras of fy (horizontal) / fx (vertical),
    # each shrunk by negative k1, as modern OpenCV does
    def fc_of(K, dist):
        dk1 = _m.pad_dist(dist)[0]
        fc = K[1, 1] if idx == 0 else K[0, 0]
        return torch.where(dk1 < 0, fc * (1.0 + dk1 * (nx * nx + ny * ny) / (4.0 * fc * fc)), fc)

    fc_new = 0.5 * (fc_of(K1, dist1) + fc_of(K2, dist2))

    # principal points from undistorted + rectified image corners
    corners = torch.tensor([[0.0, 0.0], [nx - 1.0, 0.0], [nx - 1.0, ny - 1.0], [0.0, ny - 1.0]],
                           dtype=dtype).to(dev)
    center = torch.tensor([(nx - 1) / 2.0, (ny - 1) / 2.0], dtype=dtype).to(dev)

    def cc_of(K, dist, Rrect):
        und = _m.undistort_points(corners, K, dist, R=Rrect)  # normalized, rectified
        return center - torch.mean(und * fc_new, 0)  # projected with fc_new, cc = 0

    cc1 = cc_of(K1, dist1, R1)
    cc2 = cc_of(K2, dist2, R2)
    if zero_disparity:
        cc1 = cc2 = (cc1 + cc2) * 0.5
    else:
        # only the coordinate orthogonal to the baseline is averaged
        other = 1 - idx
        mean_other = (cc1[other] + cc2[other]) * 0.5
        cc1, cc2 = cc1.clone(), cc2.clone()
        cc1[other] = mean_other
        cc2[other] = mean_other

    fc1 = fc_new
    if alpha >= 0:
        inner1, outer1 = _get_rectangles(K1, dist1, R1, _P_from(fc1, cc1, dtype), (nx, ny))
        inner2, outer2 = _get_rectangles(K2, dist2, R2, _P_from(fc1, cc2, dtype), (nx, ny))
        cx1, cy1 = cc1[0], cc1[1]
        cx2, cy2 = cc2[0], cc2[1]
        s0 = torch.max(torch.stack([
            cx1 / (cx1 - inner1[0]), cy1 / (cy1 - inner1[1]),
            (nx - cx1) / (inner1[2] - cx1), (ny - cy1) / (inner1[3] - cy1),
            cx2 / (cx2 - inner2[0]), cy2 / (cy2 - inner2[1]),
            (nx - cx2) / (inner2[2] - cx2), (ny - cy2) / (inner2[3] - cy2),
        ]))
        s1 = torch.min(torch.stack([
            cx1 / (cx1 - outer1[0]), cy1 / (cy1 - outer1[1]),
            (nx - cx1) / (outer1[2] - cx1), (ny - cy1) / (outer1[3] - cy1),
            cx2 / (cx2 - outer2[0]), cy2 / (cy2 - outer2[1]),
            (nx - cx2) / (outer2[2] - cx2), (ny - cy2) / (outer2[3] - cy2),
        ]))
        s = s0 * (1.0 - alpha) + s1 * alpha
        fc1 = fc_new * s

    P1 = _P_from(fc1, cc1, dtype)
    P2 = _P_from(fc1, cc2, dtype)
    P2[idx, 3] = t_new[idx] * fc1

    Q = torch.zeros((4, 4), dtype=dtype, device=dev)
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3] = -cc1[0]
    Q[1, 3] = -cc1[1]
    Q[2, 3] = fc1
    Q[3, 2] = -1.0 / t_new[idx]
    Q[3, 3] = (cc1[0] - cc2[0]) / t_new[idx]
    return RectifyResult(R1=R1, R2=R2, P1=P1, P2=P2, Q=Q)


def _P_from(fc, cc, dtype) -> torch.Tensor:
    P = torch.zeros((3, 4), dtype=dtype, device=cc.device)
    P[0, 0] = fc
    P[1, 1] = fc
    P[2, 2] = 1.0
    P[0, 2] = cc[0]
    P[1, 2] = cc[1]
    return P


def _get_rectangles(K, dist, R, P, image_size, n: int = 9):
    """OpenCV icvGetRectangles: inscribed and bounding rectangles of the
    undistorted image grid. Returns (x0, y0, x1, y1) for inner and outer."""
    nx, ny = image_size
    dtype, dev = K.dtype, K.device
    # OpenCV samples x * (W - 1) / (N - 1)
    xs = torch.linspace(0.0, nx - 1.0, n, dtype=dtype, device=dev)
    ys = torch.linspace(0.0, ny - 1.0, n, dtype=dtype, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([gx, gy], -1).reshape(-1, 2)
    und = _m.undistort_points(pts, K, dist, R=R, P=P).reshape(n, n, 2)
    ox0, oy0 = torch.min(und[..., 0]), torch.min(und[..., 1])
    ox1, oy1 = torch.max(und[..., 0]), torch.max(und[..., 1])
    ix0 = torch.max(und[:, 0, 0])
    ix1 = torch.min(und[:, -1, 0])
    iy0 = torch.max(und[0, :, 1])
    iy1 = torch.min(und[-1, :, 1])
    return (ix0, iy0, ix1, iy1), (ox0, oy0, ox1, oy1)


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
