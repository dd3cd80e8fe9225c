"""Frame-parallel depth over a shard mesh (twin of the depth half of
recon3d_tpu/parallel/batch.py).

`batched_depth` splits a batch of stereo frames over a mesh's "frame" axis,
runs compute_disparity on each shard's frames and reduces the mean valid
disparity over all shards with a psum (parallel/mesh.py). The pair-parallel
registration of the JAX module (register_pairs_batched, _ransac_batched,
_sharded) waits for the registration port.
"""
from __future__ import annotations

from typing import Tuple

import torch

from recon3d_tpu_torch.config import StereoMatcherConfig, WLSConfig
from recon3d_tpu_torch.depth.matcher import compute_disparity
from recon3d_tpu_torch.parallel.mesh import Mesh, shard_frames


def batched_depth(
    lefts: torch.Tensor,
    rights: torch.Tensor,
    mesh: Mesh,
    mcfg: StereoMatcherConfig = StereoMatcherConfig(),
    wcfg: WLSConfig = WLSConfig(),
    with_wls: bool = True,
    axis: str = "frame",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame-data-parallel disparity over a mesh.

    lefts / rights: (B, H, W) gray batches, B divisible by the mesh's size.
    Returns (disp (B, H, W), valid (B, H, W), the mean valid disparity over
    the whole batch as a 0-d tensor), all on every process, on mesh.device.
    """
    lefts = torch.as_tensor(lefts, dtype=torch.float32)
    rights = torch.as_tensor(rights, dtype=torch.float32)
    shards = shard_frames(mesh, (lefts, rights), axis)
    disp, valid, sums, counts = {}, {}, {}, {}
    for k, (ls, rs) in shards.items():
        frames = [compute_disparity(a, b, mcfg, wcfg, with_wls) for a, b in zip(ls, rs)]
        disp[k] = torch.stack([d for d, _ in frames])
        valid[k] = torch.stack([v for _, v in frames])
        sums[k] = torch.where(valid[k], disp[k], 0.0).sum()
        counts[k] = valid[k].to(torch.float32).sum()
    total, count = mesh.psum(sums), mesh.psum(counts)
    mean = total / torch.clamp(count, min=1.0)
    return torch.cat(mesh.all_gather(disp)), torch.cat(mesh.all_gather(valid)), mean
