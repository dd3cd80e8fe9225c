"""The rank program of tests/test_torch_parallel.py's gloo run: both
multi-device consumers of the port on a CPU process group, one shard a
rank. It imports no JAX, so a spawned rank starts with torch alone."""
import datetime
import os

import torch
import torch.distributed as dist

from recon3d_tpu_torch.config import StereoMatcherConfig, WLSConfig
from recon3d_tpu_torch.depth import sgm_sharded
from recon3d_tpu_torch.parallel import batch
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


def rank_main(rank, world, store, out_dir, pair, frames):
    """One rank: join the gloo group through the file store, run both
    consumers on its shard, save what every rank receives."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(axis_names=("frame",), device="cpu", group=dist.group.WORLD)
        pair = tuple(torch.tensor(a) for a in pair)
        frames = tuple(torch.tensor(a) for a in frames)
        torch.save(run_consumers(mesh, pair, frames), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
