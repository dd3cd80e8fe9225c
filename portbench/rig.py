"""The stereo rig of a configuration, as plain numpy matrices.

A configuration names the rectified focal length and baseline, the raw
cameras' intrinsics and distortion and the rectifying rotations (as
Rodrigues vectors). `rig_matrices` turns them into the calibration a rig's
NPZ would hold (K1, dist1, K2, dist2, R, T, R1, R2, P1, P2, Q). The program
is handed these as its calibration input; the reference derives its maps
and its Q from the same configuration numbers on its own.
"""
from __future__ import annotations

import numpy as np


def rodrigues(rvec) -> np.ndarray:
    """Axis-angle (3,) -> 3x3 rotation matrix, float64."""
    r = np.asarray(rvec, np.float64)
    theta = float(np.linalg.norm(r))
    if theta == 0.0:
        return np.eye(3)
    k = r / theta
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def rig_matrices(cfg: dict) -> dict:
    """The calibration of `cfg["rig"]` at `cfg["image"]`'s size."""
    rig = cfg["rig"]
    W, H = cfg["image"]["width"], cfg["image"]["height"]
    f, B = float(rig["f_rect_px"]), float(rig["baseline_m"])
    cx, cy = float(rig["rect_cx"]), float(rig["rect_cy"])
    P1 = np.array([[f, 0.0, cx, 0.0], [0.0, f, cy, 0.0], [0.0, 0.0, 1.0, 0.0]])
    P2 = P1.copy()
    P2[0, 3] = -f * B
    Q = np.zeros((4, 4))
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3], Q[1, 3], Q[2, 3], Q[3, 2] = -cx, -cy, f, 1.0 / B
    if not (0 < cx < W and 0 < cy < H):
        raise ValueError(f"rectified principal point ({cx}, {cy}) outside {W}x{H}")
    return {
        "K1": np.asarray(rig["K1"], np.float64), "dist1": np.asarray([rig["dist1"]], np.float64),
        "K2": np.asarray(rig["K2"], np.float64), "dist2": np.asarray([rig["dist2"]], np.float64),
        "R": rodrigues(rig["rvec_pair"]), "T": np.array([[-B], [0.0], [0.0]]),
        "R1": rodrigues(rig["rvec1"]), "R2": rodrigues(rig["rvec2"]),
        "P1": P1, "P2": P2, "Q": Q,
    }
