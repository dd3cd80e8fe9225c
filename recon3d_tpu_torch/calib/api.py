"""High-level stereo calibration workflow (twin of recon3d_tpu/calib/api.py).

From image pairs to detected corners, per-camera calibration, stereo
calibration with fixed intrinsics, rectification, the saved NPZ and the
text report (`stereo_calibrate_camera`); also the batch mode that loads
saved pairs from a folder (`calibrate_from_folder`).

Host-side orchestration; the numerics run in float64 tensors on `device`
(the card unless the caller asks for the CPU), where the JAX package runs
under jax.enable_x64().
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.calib import chessboard as cb
from recon3d_tpu_torch.calib import mono as _mono
from recon3d_tpu_torch.calib import report as _report
from recon3d_tpu_torch.calib import stereo as _stereo
from recon3d_tpu_torch.calib.npz import StereoParams


def detect_corner_pairs(
    images_left: Sequence[np.ndarray],
    images_right: Sequence[np.ndarray],
    pattern_size: Tuple[int, int],
    detector: str = "opencv",
    device="cuda",
) -> Tuple[List[np.ndarray], List[np.ndarray], List[int]]:
    """Find chessboard corners in every pair; keep pairs found in both views."""
    kept_l, kept_r, idx = [], [], []
    for i, (il, ir) in enumerate(zip(images_left, images_right)):
        ok_l, cl = cb.find_chessboard_corners(il, pattern_size, detector=detector, device=device)
        ok_r, cr = cb.find_chessboard_corners(ir, pattern_size, detector=detector, device=device)
        if ok_l and ok_r:
            kept_l.append(cl)
            kept_r.append(cr)
            idx.append(i)
    return kept_l, kept_r, idx


def stereo_calibrate_camera(
    images_left: Sequence[np.ndarray],
    images_right: Sequence[np.ndarray],
    pattern_size: Tuple[int, int] = (9, 6),
    square_size: float = 1.0,
    image_size: Optional[Tuple[int, int]] = None,
    n_dist: int = 5,
    save_path: Optional[str] = None,
    report_path: Optional[str] = None,
    detector: str = "opencv",
    alpha: float = -1.0,
    device="cuda",
) -> Tuple[StereoParams, dict]:
    """Full stereo calibration from image pairs.

    Returns (StereoParams incl. rectification, info dict with errors).
    """
    if image_size is None:
        h, w = np.asarray(images_left[0]).shape[:2]
        image_size = (w, h)

    corners_l, corners_r, used = detect_corner_pairs(
        images_left, images_right, pattern_size, detector=detector, device=device)
    if len(used) < 3:
        raise RuntimeError(f"need >=3 good pairs, found {len(used)} (of {len(images_left)})")
    obj = cb.chessboard_object_points(pattern_size, square_size)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    objs = put(np.stack([obj] * len(used)))
    img_l, img_r = put(np.stack(corners_l)), put(np.stack(corners_r))

    res_l = _mono.calibrate_camera(objs, img_l, image_size, n_dist=n_dist)
    res_r = _mono.calibrate_camera(objs, img_r, image_size, n_dist=n_dist)
    sres = _stereo.stereo_calibrate(objs, img_l, img_r, res_l.K, res_l.dist, res_r.K,
                                    res_r.dist)
    rect = _stereo.stereo_rectify(res_l.K, res_l.dist, res_r.K, res_r.dist, image_size,
                                  sres.R, sres.T, zero_disparity=True, alpha=alpha)

    def host(t):
        return t.cpu().numpy()

    params = StereoParams(
        mtx1=host(res_l.K), dist1=host(res_l.dist)[None, :],
        mtx2=host(res_r.K), dist2=host(res_r.dist)[None, :],
        R=host(sres.R), T=host(sres.T).reshape(3, 1),
        E=host(sres.E), F=host(sres.F),
        R1=host(rect.R1), R2=host(rect.R2), P1=host(rect.P1), P2=host(rect.P2), Q=host(rect.Q),
    )
    per_view = host(sres.per_view_errors)
    info = {
        "rms_left": float(res_l.rms),
        "rms_right": float(res_r.rms),
        "rms_stereo": float(sres.rms),
        "mean_error_left": float(np.mean(per_view[:, 0])),
        "mean_error_right": float(np.mean(per_view[:, 1])),
        "per_view_errors": per_view,
        "pairs_used": used,
        "image_size": image_size,
    }

    if save_path:
        params.save(save_path)
    if report_path:
        _report.write_stereo_report(
            report_path, params, image_size, len(used),
            info["mean_error_left"], info["mean_error_right"],
            per_view_errors=info["per_view_errors"],
            square_size=square_size, pattern_size=pattern_size,
        )
    return params, info


def calibrate_from_folder(
    folder: str,
    pattern_left: str = "left_*.png",
    pattern_right: str = "right_*.png",
    **kwargs,
) -> Tuple[StereoParams, dict]:
    """Batch calibration from saved image pairs; keyword arguments (device
    among them) go to `stereo_calibrate_camera`."""
    from recon3d_tpu_torch.utils import io

    lefts = sorted(glob.glob(os.path.join(folder, pattern_left)))
    rights = sorted(glob.glob(os.path.join(folder, pattern_right)))
    if len(lefts) != len(rights) or not lefts:
        raise FileNotFoundError(
            f"unpaired calibration images in {folder}: {len(lefts)} left, {len(rights)} right")
    imgs_l = [io.read_color(p) for p in lefts]
    imgs_r = [io.read_color(p) for p in rights]
    return stereo_calibrate_camera(imgs_l, imgs_r, **kwargs)
