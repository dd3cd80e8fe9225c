"""Multi-device leg of the streaming fusion consumer (twin of
recon3d_tpu/parallel/fusion.py, the check90 twin).

A drained backlog of B frames tracks in parallel against the broadcast
keyframe (keyframe-relative poses are independent between promotions) and
the B TSDF integrations fold into the volume with the exact sequential
semantics of B integrate() calls, over a mesh's frame axis
(parallel/mesh.py: in-process shards or a torch.distributed group).

Exact capped-EMA integration over a sharded batch
-------------------------------------------------
The sequential per-frame update (fusion/tsdf.py) is, per voxel,
t' = (t*a + n_k) / (a + w_k) with the stored weight a' = min(a + w_k, W).
Since w_k >= 0, the capped running weight has the closed form
a_k = min(w0 + S_k, W) with S_k the plain prefix sum, so each frame's
update is an affine map t -> alpha_k t + beta_k whose coefficients depend
only on prefix weight sums. Affine maps compose associatively, so:
  pass 1  each shard sums its frames' weight counts;
  gather  the shards' sums; each shard's incoming weight is w0 plus the sum
          of the shards before it (an exclusive prefix);
  pass 2  each shard folds its frames into one affine map (A, B);
  gather  the maps, composed in shard order: M_{n-1} o ... o M_0.
Each frame's samples come from fusion/tsdf.py:_frame_contrib, so K9 runs
twice a frame (once a pass). The result follows the sequential recurrence,
including voxels whose weight crosses weight_max mid-batch, up to float32
rounding of the distributed division ((t*a+n)/d vs (a/d)*t + n/d).

Unlike the JAX package's program, which donates the volume, both entry
points leave the caller's volume intact and return a new one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from recon3d_tpu_torch.fusion import tsdf as _tsdf
from recon3d_tpu_torch.parallel.mesh import Mesh, MeshGrid, axis_view, shard_frames
from recon3d_tpu_torch.registration.odometry import compute_rgbd_odometry
from recon3d_tpu_torch.utils.profiling import annotate
from recon3d_tpu_torch.utils.types import CameraIntrinsics, RGBDImage

Frames = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]  # depths, exts, colors


def _block_weights(vol, frames: Frames, intr, depth_trunc) -> torch.Tensor:
    """Pass 1: the (R, R, R) weight count of a shard's frames."""
    depths, exts, _ = frames
    s = torch.zeros_like(vol.weight)
    for d, e in zip(depths, exts):
        s = s + _tsdf._frame_contrib(vol, d, intr, e, None, depth_trunc)[1]
    return s


def _block_affine(vol, frames: Frames, intr, depth_trunc, weight_max, w_in):
    """Pass 2: a shard's frames folded into one affine map: t_out = A * t_in
    + Bn (color: A * c_in + Bc). w_in is the uncapped incoming weight (w0
    plus the weight count of every frame ordered before the shard)."""
    depths, exts, colors = frames
    with_c = colors is not None
    A = torch.ones_like(vol.tsdf)
    Bn = torch.zeros_like(vol.tsdf)
    Bc = torch.zeros_like(vol.color) if with_c else None
    s = torch.zeros_like(vol.weight)
    for b in range(depths.shape[0]):
        n1, w1, cf = _tsdf._frame_contrib(vol, depths[b], intr, exts[b],
                                          colors[b] if with_c else None, depth_trunc)
        a_prev = torch.clamp(w_in + s, max=weight_max)
        denom = torch.clamp(a_prev + w1, min=1.0)
        upd = w1 > 0.0
        alpha = torch.where(upd, a_prev / denom, 1.0)
        A = alpha * A
        Bn = alpha * Bn + torch.where(upd, n1 / denom, 0.0)
        if with_c:
            Bc = alpha[..., None] * Bc + torch.where(upd[..., None], cf / denom[..., None], 0.0)
        s = s + w1
    return A, Bn, Bc


def _integrate_local(vol: _tsdf.TSDFVolume, parts: Dict[int, Frames], mesh: Mesh,
                     intr: CameraIntrinsics, depth_trunc: float,
                     weight_max: float) -> _tsdf.TSDFVolume:
    """The two passes over the local shards' frames; every process returns
    the whole new volume."""
    with_c = vol.color is not None and next(iter(parts.values()))[2] is not None
    with annotate("fusion.weights"):
        sums = mesh.all_gather({k: _block_weights(vol, f, intr, depth_trunc)
                                for k, f in parts.items()})
    maps = {}
    with annotate("fusion.affine"):
        for k, f in parts.items():
            offset = torch.zeros_like(vol.weight)
            for before in sums[:k]:
                offset = offset + before
            maps[k] = _block_affine(vol, f, intr, depth_trunc, weight_max, vol.weight + offset)
    Ag = mesh.all_gather({k: m[0] for k, m in maps.items()})
    Bng = mesh.all_gather({k: m[1] for k, m in maps.items()})
    Bcg = mesh.all_gather({k: m[2] for k, m in maps.items()}) if with_c else None
    del maps
    At, Bt = torch.ones_like(vol.tsdf), torch.zeros_like(vol.tsdf)
    Ct = torch.zeros_like(vol.color) if with_c else None
    for i in range(mesh.n):
        At, Bt = Ag[i] * At, Ag[i] * Bt + Bng[i]
        if with_c:
            Ct = Ag[i][..., None] * Ct + Bcg[i]
    total = torch.zeros_like(vol.weight)
    for s in sums:
        total = total + s
    new = dataclasses.replace(vol, tsdf=At * vol.tsdf + Bt,
                              weight=torch.clamp(vol.weight + total, max=weight_max))
    if with_c:
        new = dataclasses.replace(new, color=At[..., None] * vol.color + Ct)
    return new


def _check_batch(B: int, mesh: Mesh) -> None:
    if B % mesh.n:
        raise ValueError(f"batch {B} must divide over {mesh.n} shards")


def integrate_frames_exact(
    vol: _tsdf.TSDFVolume,
    depths: torch.Tensor,
    exts: torch.Tensor,
    intr: CameraIntrinsics,
    mesh: Union[Mesh, MeshGrid],
    colors: Optional[torch.Tensor] = None,
    axis_name: str = "frame",
    depth_trunc: float = 3.0,
    weight_max: float = 64.0,
) -> _tsdf.TSDFVolume:
    """Exact sequential-semantics TSDF integrate of a (B, H, W) depth batch
    sharded over `axis_name`, with given (B, 4, 4) camera_from_world
    extrinsics (and (B, H, W, 3) colors). Returns a new volume on
    mesh.device; `vol` is left as it was."""
    with annotate("fusion.integrate_exact"):
        mesh = axis_view(mesh, axis_name)
        _check_batch(depths.shape[0], mesh)
        with_c = vol.color is not None and colors is not None
        exts = torch.as_tensor(exts, dtype=torch.float32)
        tensors = (torch.as_tensor(depths), exts) + ((torch.as_tensor(colors),) if with_c
                                                     else ())
        parts = {k: (p[0], p[1], p[2] if with_c else None)
                 for k, p in shard_frames(mesh, tensors, axis_name).items()}
        return _integrate_local(vol, parts, mesh, intr, depth_trunc, weight_max)


def fused_frames_sharded(
    vol: _tsdf.TSDFVolume,
    key_color: torch.Tensor,
    key_depth: torch.Tensor,
    colors: torch.Tensor,
    depths: torch.Tensor,
    intr: CameraIntrinsics,
    mesh: Union[Mesh, MeshGrid],
    axis_name: str = "frame",
    world_from_key: Optional[torch.Tensor] = None,
    depth_trunc: float = 3.0,
    weight_max: float = 64.0,
    odo_levels: int = 3,
) -> Tuple[_tsdf.TSDFVolume, torch.Tensor, torch.Tensor]:
    """Track + integrate a B-frame backlog sharded over `axis_name`.

    colors / depths: (B, H, W[, 3]) with B divisible by the axis's size.
    Each shard runs compute_rgbd_odometry(keyframe, frame) for its frames,
    one at a time; integration is integrate_frames_exact's. Returns (the new
    volume, world_from_cam (B, 4, 4), success (B,)), all on every process.
    """
    mesh = axis_view(mesh, axis_name)
    _check_batch(depths.shape[0], mesh)
    dev = mesh.device
    wfk = (torch.eye(4, dtype=torch.float32, device=dev) if world_from_key is None
           else torch.as_tensor(world_from_key, dtype=torch.float32).to(dev))
    key = RGBDImage(color=torch.as_tensor(key_color).to(dev),
                    depth=torch.as_tensor(key_depth).to(dev))
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    with_c = vol.color is not None
    parts, wfcs, oks = {}, {}, {}
    for k, (c, d) in shard_frames(mesh, (torch.as_tensor(colors), torch.as_tensor(depths)),
                                  axis_name).items():
        poses, ok = [], []
        for b in range(d.shape[0]):
            res = compute_rgbd_odometry(key, RGBDImage(color=c[b], depth=d[b]), intr,
                                        levels=odo_levels)
            # streaming.py's convention: odometry(key, cur) returns
            # cur_from_key; world pose = world_from_key @ inv(cur_from_key)
            cur_from_key = torch.where(res.success, res.transformation, eye)
            poses.append(wfk @ torch.linalg.inv(cur_from_key))
            ok.append(res.success)
        wfcs[k], oks[k] = torch.stack(poses), torch.stack(ok)
        parts[k] = (d, torch.linalg.inv(wfcs[k]), c if with_c else None)
    new = _integrate_local(vol, parts, mesh, intr, depth_trunc, weight_max)
    return new, torch.cat(mesh.all_gather(wfcs)), torch.cat(mesh.all_gather(oks))
