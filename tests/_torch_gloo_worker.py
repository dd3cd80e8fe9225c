"""The rank programs of tests/test_torch_parallel.py's and
tests/test_torch_parallel_fusion.py's gloo runs: the port's multi-device
consumers on a CPU process group, one shard a rank. It imports no JAX, so a
spawned rank starts with torch alone."""
import datetime
import os

import torch
import torch.distributed as dist

from recon3d_tpu_torch.config import StereoMatcherConfig, WLSConfig
from recon3d_tpu_torch.depth import sgm_sharded
from recon3d_tpu_torch.fusion import tsdf
from recon3d_tpu_torch.parallel import batch, fusion
from recon3d_tpu_torch.parallel.mesh import make_mesh

# the consumers' settings, shared with the in-process run they are held to
SGM_KW = dict(num_disparities=32, block_size=5, num_directions=8)
MATCHER = StereoMatcherConfig(num_disparities=16, block_size=3, speckle_window_size=0)
WLS = WLSConfig(iterations=2)


def run_consumers(mesh, pair, frames):
    """Both consumers on `mesh`: the row-sharded SGM of one pair and the
    frame-parallel depth of a batch."""
    disp, valid = sgm_sharded.sgm_disparity_cuda_rowsharded(
        *pair, make_mesh(mesh.n, ("row",), device=mesh.device, group=mesh.group), **SGM_KW)
    b_disp, b_valid, mean = batch.batched_depth(*frames, mesh, MATCHER, WLS)
    return {"disp": disp, "valid": valid, "batch_disp": b_disp, "batch_valid": b_valid,
            "mean": mean}


RANK_THREADS = 2  # a rank's torch threads: CPU reductions split by the thread count


def run_fusion(mesh, colors, depths, exts, weight_max):
    """parallel/fusion.py on `mesh`: integrate_frames_exact of the batch at
    its given poses (with color), and fused_frames_sharded of its frames
    1-4 against frame 0 (96x80 frames, a 48^3 volume). Runs on RANK_THREADS
    threads, as a rank does: the odometry's sums round by the split."""
    threads = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    try:
        return _run_fusion(mesh, colors, depths, exts, weight_max)
    finally:
        torch.set_num_threads(threads)


def _run_fusion(mesh, colors, depths, exts, weight_max):
    from recon3d_tpu_torch.utils.types import CameraIntrinsics

    intr = CameraIntrinsics(80.0, 80.0, 96 / 2 - 0.5, 80 / 2 - 0.5)
    vol = dict(voxel_size=0.02, sdf_trunc=0.1, origin=(-0.5, -0.5, 0.5), device="cpu")
    colors, depths = torch.tensor(colors), torch.tensor(depths)
    out = fusion.integrate_frames_exact(tsdf.make_volume(48, **vol), depths, torch.tensor(exts),
                                        intr, mesh, colors=colors, weight_max=weight_max)
    fused, wfc, ok = fusion.fused_frames_sharded(
        tsdf.make_volume(48, with_color=False, **vol), colors[0], depths[0], colors[1:5],
        depths[1:5], intr, mesh, odo_levels=2)
    return {"tsdf": out.tsdf, "weight": out.weight, "color": out.color,
            "fused_tsdf": fused.tsdf, "fused_weight": fused.weight, "poses": wfc, "ok": ok}


def _join(rank, world, store):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(RANK_THREADS)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    return make_mesh(axis_names=("frame",), device="cpu", group=dist.group.WORLD)


def rank_main(rank, world, store, out_dir, pair, frames):
    """One rank: join the gloo group through the file store, run both
    consumers on its shard, save what every rank receives."""
    mesh = _join(rank, world, store)
    try:
        pair = tuple(torch.tensor(a) for a in pair)
        frames = tuple(torch.tensor(a) for a in frames)
        torch.save(run_consumers(mesh, pair, frames), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def fusion_rank_main(rank, world, store, out_dir, colors, depths, exts, weight_max):
    """One rank of run_fusion; saves what every rank receives."""
    mesh = _join(rank, world, store)
    try:
        torch.save(run_fusion(mesh, colors, depths, exts, weight_max),
                   os.path.join(out_dir, f"fusion_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
