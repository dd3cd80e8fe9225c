"""Calibration report writer (twin of recon3d_tpu/calib/report.py).

The content of the reference's stereo calibration report: intrinsics,
distortion, stereo geometry, rectification, baseline and per-camera mean
reprojection errors, from host numpy arrays.
"""
from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np

from recon3d_tpu_torch.calib.npz import StereoParams


def format_matrix(name: str, M: np.ndarray) -> str:
    body = np.array2string(np.asarray(M), precision=6, suppress_small=False,
                           max_line_width=100)
    return f"{name}:\n{body}\n"


def write_stereo_report(
    path: str,
    params: StereoParams,
    image_size,
    n_pairs: int,
    mean_error_left: float,
    mean_error_right: float,
    per_view_errors: Optional[Sequence] = None,
    square_size: Optional[float] = None,
    pattern_size: Optional[tuple] = None,
    timestamp: Optional[str] = None,
) -> str:
    """Write the human-readable calibration report; returns the text."""
    ts = timestamp or datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    L = []
    L.append("=" * 70)
    L.append("STEREO CALIBRATION REPORT (recon3d_tpu_torch)")
    L.append(f"Generated: {ts}")
    L.append("=" * 70)
    L.append("")
    L.append(f"Image size: {image_size[0]} x {image_size[1]}")
    L.append(f"Calibration pairs used: {n_pairs}")
    if pattern_size is not None:
        L.append(f"Chessboard pattern: {pattern_size[0]} x {pattern_size[1]}")
    if square_size is not None:
        L.append(f"Square size: {square_size}")
    L.append("")
    L.append(f"Stereo baseline |T|: {params.baseline:.6f}")
    L.append("")
    L.append("-" * 70)
    L.append("LEFT CAMERA")
    L.append(format_matrix("Camera matrix (mtx1)", params.mtx1))
    L.append(format_matrix("Distortion (dist1)", params.dist1))
    L.append(f"Mean reprojection error: {mean_error_left:.5f} px")
    L.append("")
    L.append("-" * 70)
    L.append("RIGHT CAMERA")
    L.append(format_matrix("Camera matrix (mtx2)", params.mtx2))
    L.append(format_matrix("Distortion (dist2)", params.dist2))
    L.append(f"Mean reprojection error: {mean_error_right:.5f} px")
    L.append("")
    L.append("-" * 70)
    L.append("STEREO GEOMETRY")
    L.append(format_matrix("Rotation R (right from left)", params.R))
    L.append(format_matrix("Translation T", params.T))
    if params.E is not None:
        L.append(format_matrix("Essential matrix E", params.E))
    if params.F is not None:
        L.append(format_matrix("Fundamental matrix F", params.F))
    if params.R1 is not None:
        L.append("-" * 70)
        L.append("RECTIFICATION")
        L.append(format_matrix("R1", params.R1))
        L.append(format_matrix("R2", params.R2))
        L.append(format_matrix("P1", params.P1))
        L.append(format_matrix("P2", params.P2))
        L.append(format_matrix("Q (disparity-to-depth)", params.Q))
        L.append(f"Rectified focal length: {float(np.asarray(params.P1)[0, 0]):.6f} px")
    if per_view_errors is not None:
        L.append("-" * 70)
        L.append("PER-VIEW MEAN REPROJECTION ERRORS (left, right) px")
        for i, e in enumerate(np.asarray(per_view_errors)):
            L.append(f"  view {i:3d}: {e[0]:.5f}  {e[1]:.5f}")
    text = "\n".join(L) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return text
