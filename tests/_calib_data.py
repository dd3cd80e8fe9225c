"""Seeded calibration inputs shared by the calibration parity tests: a
stereo rig with radial + tangential distortion, planar 9x6 chessboard views
(noisy corner observations in both cameras) and an anti-aliased render of
the board. Pure numpy / torch on the CPU, no JAX and no OpenCV."""
import numpy as np
import torch

from recon3d_tpu_torch.calib import model

PATTERN, SQUARE = (9, 6), 0.025
SIZE = (640, 480)  # (width, height)
K1 = np.array([[615.0, 0.0, 322.0], [0.0, 612.0, 241.0], [0.0, 0.0, 1.0]])
D1 = np.array([0.08, -0.12, 0.0012, -0.0008, 0.05])
K2 = np.array([[605.0, 0.0, 318.0], [0.0, 607.0, 236.0], [0.0, 0.0, 1.0]])
D2 = np.array([0.05, -0.10, -0.001, 0.0005, 0.02])
R_RIG = np.array([0.01, -0.02, 0.005])  # right-from-left, axis-angle
T_RIG = np.array([-0.06, 0.001, 0.002])


def rot(rvec) -> np.ndarray:
    return model.rodrigues(torch.as_tensor(np.asarray(rvec, np.float64))).numpy()


def obj_points() -> np.ndarray:
    nx, ny = PATTERN
    obj = np.zeros((nx * ny, 3))
    obj[:, :2] = np.mgrid[0:nx, 0:ny].T.reshape(-1, 2) * SQUARE
    return obj


def project(obj, rvec, tvec, K, dist) -> np.ndarray:
    return model.project_points(torch.as_tensor(obj), torch.as_tensor(rvec),
                                torch.as_tensor(tvec), K, dist).numpy()


def board_poses(V, seed):
    """V board -> left camera poses at 0.4-0.8 m, rotated by a normal draw
    of 0.25 rad an axis, the board in view."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(3) * 0.25,
             np.array([rng.uniform(-0.1, 0.1) - 0.1, rng.uniform(-0.08, 0.08) - 0.06,
                       rng.uniform(0.4, 0.8)])) for _ in range(V)]


def right_pose(rvec, tvec):
    R = rot(R_RIG) @ rot(rvec)
    return (model.inv_rodrigues(torch.as_tensor(R)).numpy(), rot(R_RIG) @ tvec + T_RIG)


def stereo_views(V, seed=0, noise=0.05):
    """(objs (V, N, 3), left corners (V, N, 2), right corners (V, N, 2)),
    the true projections plus seeded Gaussian noise of `noise` px."""
    rng = np.random.RandomState(seed + 100)
    obj = obj_points()
    left, right = [], []
    for rvec, tvec in board_poses(V, seed):
        left.append(project(obj, rvec, tvec, K1, D1))
        right.append(project(obj, *right_pose(rvec, tvec), K2, D2))
    left = np.stack(left) + rng.randn(V, len(obj), 2) * noise
    right = np.stack(right) + rng.randn(V, len(obj), 2) * noise
    return np.stack([obj] * V), left, right


def render_board(K, dist, rvec, tvec, size=SIZE, ss=4) -> np.ndarray:
    """The 9x6 board (10x7 squares, black 30 / white 220 on a white
    surround) at pose (rvec, tvec): (H, W) uint8, each pixel the mean of
    ss x ss undistorted rays cast onto the board's plane."""
    W, H = size
    nx, ny = PATTERN
    R = torch.as_tensor(rot(rvec))
    t = torch.as_tensor(np.asarray(tvec, np.float64))
    off = (torch.arange(ss, dtype=torch.float64) + 0.5) / ss - 0.5
    pu = torch.arange(W, dtype=torch.float64)[None, :, None, None] + off[None, None, None, :]
    pv = torch.arange(H, dtype=torch.float64)[:, None, None, None] + off[None, None, :, None]
    pts = torch.stack(torch.broadcast_tensors(pu, pv), -1)
    xy = model.undistort_points(pts, K, dist, iters=20)
    ray = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    s = (R[:, 2] @ t) / (ray @ R[:, 2])
    b = (s[..., None] * ray - t) @ R
    i, j = torch.floor(b[..., 0] / SQUARE), torch.floor(b[..., 1] / SQUARE)
    on = (i >= -1) & (i <= nx - 1) & (j >= -1) & (j <= ny - 1) & (s > 0)
    val = torch.where(on & (torch.remainder(i + j, 2) == 0), 30.0, 220.0).mean((-2, -1))
    return torch.round(val).to(torch.uint8).numpy()
