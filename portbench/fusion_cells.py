"""What the fusion drivers share: the posed frame pool, the scan's frame
order and the comparison of a volume with the reference.

The pool is rendered on the device from the seed, then held in host memory
as `pipeline/offline.py` holds loaded frames: colour uint8 and depth
float32 metres (the z16 values / depth_scale, converted once), with each
pose's extrinsic (camera from world) as float32. A scan plays the pool
forward and back (0, 1, ..., n-1, n-2, ..., 1, 0, 1, ...) into a fresh
volume for `scan_frames` frames.

A compared state is the program's volume after a known number of the
scan's frames; the reference integrates the same frames into its own
volume in float64. Numbers:

- weight_diff: the share of voxels, among those with weight on either
  side, whose weights differ;
- tsdf_gap: the mean |tsdf gap| over the voxels with weight on both sides;
- color_gap: the mean largest-channel colour gap over the same voxels.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.tsdf import Volume
from portbench.scenes import RGBDOrbit

F64 = torch.float64


def volume_center(tsdf: dict) -> list:
    half = 0.5 * (tsdf["resolution"] - 1) * tsdf["voxel_size"]
    return [o + half for o in tsdf["origin"]]


class FramePool:
    def __init__(self, cfg: dict, n: int, seed: int, device):
        cam = cfg["camera"]
        orbit = RGBDOrbit(n, cam, volume_center(cfg["tsdf"]), seed, device)
        z16, color, world_from_cam = orbit.render()
        raw = z16.cpu().numpy().astype(np.uint16)
        self.depth = [raw[i].astype(np.float32) / float(cam["depth_scale"]) for i in range(n)]
        self.color = [np.ascontiguousarray(color[i].cpu().numpy()) for i in range(n)]
        poses = world_from_cam.cpu().numpy()
        self.ext = [np.asarray(np.linalg.inv(poses[i]), np.float32) for i in range(n)]
        self.n = n

    def index(self, k: int) -> int:
        """The pool frame of a scan's k-th frame (forward and back)."""
        if self.n == 1:
            return 0
        period = 2 * (self.n - 1)
        j = k % period
        return j if j < self.n else period - j


def program_intrinsics(cfg: dict):
    from recon3d_tpu_torch.utils.types import CameraIntrinsics

    c = cfg["camera"]
    return CameraIntrinsics(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"])


def program_volume(cfg: dict, device):
    from recon3d_tpu_torch.fusion.tsdf import make_volume

    t = cfg["tsdf"]
    return make_volume(resolution=t["resolution"], voxel_size=t["voxel_size"],
                       sdf_trunc=t["sdf_trunc"], origin=tuple(t["origin"]),
                       with_color=t["color"], device=device)


def snapshot(vol) -> tuple:
    return (vol.tsdf.clone(), vol.weight.clone(), vol.color.clone())


def reference_state(cfg: dict, pool: FramePool, frames: int, device, dtype=F64) -> Volume:
    """The reference volume after a scan's first `frames` frames."""
    ref = Volume(cfg["tsdf"], device, dtype)
    for k in range(frames):
        i = pool.index(k)
        ref.integrate(torch.from_numpy(pool.depth[i]).to(device),
                      torch.from_numpy(pool.color[i]).to(device),
                      torch.from_numpy(pool.ext[i]).to(device, F64), cfg["camera"])
    return ref


def numbers(state: tuple, ref: Volume) -> dict:
    tsdf, weight, color = (t.to(ref.tsdf.device, F64) for t in state)
    rw = ref.weight.to(F64)
    anyw = (weight > 0) | (rw > 0)
    both = (weight > 0) & (rw > 0)
    nb = max(int(both.sum()), 1)
    return {
        "weight_diff": float(((weight != rw) & anyw).sum()) / max(int(anyw.sum()), 1),
        "tsdf_gap": float(torch.where(both, (tsdf - ref.tsdf.to(F64)).abs(), 0.0).sum()) / nb,
        "color_gap": float(torch.where(both, (color - ref.color.to(F64)).abs().amax(-1),
                                       0.0).sum()) / nb,
    }


def judge(cfg: dict, pool: FramePool, states: list, device) -> list:
    """The numbers of each (state, frames): the program's volume against the
    reference's after the same frames of a scan."""
    return [numbers(state, reference_state(cfg, pool, frames, device)) for state, frames in states]


def control(cfg: dict, pool: FramePool, frames: int, device, dtype) -> list:
    """The control's numbers: the reference in `dtype` in the program's
    place over a scan's first `frames` frames."""
    low = reference_state(cfg, pool, frames, device, dtype)
    return [numbers((low.tsdf, low.weight, low.color), reference_state(cfg, pool, frames, device))]
