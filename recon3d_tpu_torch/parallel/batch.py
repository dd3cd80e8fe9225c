"""Frame-parallel depth and pair-parallel registration over shard meshes
(twin of recon3d_tpu/parallel/batch.py).

`batched_depth` splits a batch of stereo frames over a mesh's "frame" axis,
runs compute_disparity on each shard's frames and reduces the mean valid
disparity over all shards with a psum (parallel/mesh.py).

The registration entry points run a batch of fragment pairs (the
reference's mini1.py:263-321 pair loop): ICP (`register_pairs_batched`),
RANSAC-FPFH + ICP refine + information matrix
(`register_pairs_ransac_batched`, what Scanner3D calls), and ICP with the
pairs split over a mesh (`register_pairs_sharded`). The JAX package vmaps
one program over the pairs; here each pair runs the port's own
registration call in turn, so a batch equals its per-pair calls bitwise on
one device. Clouds come as a list of PointClouds or as one PointCloud whose
tensors carry a leading batch axis (B, N, ...); results stack on a leading
batch axis.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from recon3d_tpu_torch.config import StereoMatcherConfig, WLSConfig
from recon3d_tpu_torch.depth.matcher import compute_disparity
from recon3d_tpu_torch.parallel.mesh import Mesh, MeshGrid, axis_view, frame_sharding, shard_frames
from recon3d_tpu_torch.registration.icp import (RegistrationResult, information_matrix,
                                                registration_icp)
from recon3d_tpu_torch.registration.ransac import registration_ransac_fpfh
from recon3d_tpu_torch.utils.profiling import annotate
from recon3d_tpu_torch.utils.types import PointCloud

Clouds = Union[PointCloud, Sequence[PointCloud]]


def batched_depth(
    lefts: torch.Tensor,
    rights: torch.Tensor,
    mesh: Union[Mesh, MeshGrid],
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
    with annotate("batch.depth"):
        mesh = axis_view(mesh, axis)
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


def _map_cloud(pc: PointCloud, fn) -> PointCloud:
    """fn applied to each tensor of the cloud (None fields stay None)."""
    return PointCloud(*(None if a is None else fn(a)
                        for a in (pc.points, pc.valid, pc.colors, pc.normals)))


def _unstack_clouds(clouds: Clouds) -> List[PointCloud]:
    """A list of clouds from a list, or from a cloud with a leading batch
    axis (points (B, N, 3))."""
    if not isinstance(clouds, PointCloud):
        return list(clouds)
    if clouds.points.ndim != 3:
        raise ValueError(f"a batched cloud has points (B, N, 3), not {tuple(clouds.points.shape)}")
    return [_map_cloud(clouds, lambda a: a[b]) for b in range(clouds.points.shape[0])]


def _stack_results(results: Sequence[RegistrationResult]) -> RegistrationResult:
    """Per-pair results stacked on a leading batch axis."""
    return RegistrationResult(*(torch.stack(field) for field in zip(*results)))


def _pair_lists(sources: Clouds, targets: Clouds):
    srcs, tgts = _unstack_clouds(sources), _unstack_clouds(targets)
    if len(srcs) != len(tgts):
        raise ValueError(f"{len(srcs)} sources and {len(tgts)} targets")
    return srcs, tgts


def register_pairs_batched(
    sources: Clouds,
    targets: Clouds,
    inits: Optional[torch.Tensor] = None,
    threshold: float = 0.02,
    method: str = "point_to_point",
    max_iterations: int = 30,
) -> RegistrationResult:
    """ICP over B fragment pairs (mini1.py:263-321's pair loop). inits:
    (B, 4, 4) initial source -> target transforms, the identity by default.
    Returns the RegistrationResult with a leading (B,) axis."""
    srcs, tgts = _pair_lists(sources, targets)
    if not srcs:
        raise ValueError("no pairs to register")
    results = [registration_icp(s, t, threshold=threshold,
                                init=None if inits is None else inits[b], method=method,
                                max_iterations=max_iterations)
               for b, (s, t) in enumerate(zip(srcs, tgts))]
    return _stack_results(results)


def register_pairs_ransac_batched(
    sources: Clouds,
    targets: Clouds,
    feats_src: Union[torch.Tensor, Sequence[torch.Tensor]],
    feats_tgt: Union[torch.Tensor, Sequence[torch.Tensor]],
    distance_threshold: float,
    num_trials: int = 65536,
    chunk: int = 4,
) -> Tuple[RegistrationResult, torch.Tensor]:
    """RANSAC-FPFH + ICP refine + information matrix over B pairs
    (mini1.py:263-321). feats_*: (B, N, 33) or a list of (N, 33). Each pair
    runs registration_ransac_fpfh with its own default seed, so the batch
    equals the per-pair calls. The pairs run one at a time, so one pair's
    (Ns, Nt) feature-distance matrix is alive at once; `chunk` is kept for
    the JAX signature and has no effect. Returns (RegistrationResult with a
    leading (B,) axis, information matrices (B, 6, 6))."""
    srcs, tgts = _pair_lists(sources, targets)
    if not len(srcs) == len(feats_src) == len(feats_tgt):
        raise ValueError(f"{len(srcs)} pairs, {len(feats_src)} source and "
                         f"{len(feats_tgt)} target feature sets")
    results, infos = [], []
    for s, t, fs, ft in zip(srcs, tgts, feats_src, feats_tgt):
        res = registration_ransac_fpfh(s, t, fs, ft, distance_threshold, num_trials=num_trials)
        results.append(res)
        infos.append(information_matrix(s, t, distance_threshold, res.transformation))
    return _stack_results(results), torch.stack(infos)


def register_pairs_sharded(
    sources: Clouds,
    targets: Clouds,
    mesh: Union[Mesh, MeshGrid],
    inits: Optional[torch.Tensor] = None,
    threshold: float = 0.02,
    method: str = "point_to_point",
    max_iterations: int = 30,
    axis: str = "frame",
) -> RegistrationResult:
    """register_pairs_batched with the pairs split over the mesh's axis: each
    shard registers B / n pairs on mesh.device and every process gets all B
    results (an all_gather), in pair order."""
    mesh = axis_view(mesh, axis)
    srcs, tgts = _pair_lists(sources, targets)
    B = len(srcs)
    dev = mesh.device
    if inits is None:
        inits = torch.eye(4, dtype=torch.float32, device=dev).expand(B, 4, 4)
    parts = {}
    for k, sl in frame_sharding(mesh, B, axis).items():
        parts[k] = register_pairs_batched(
            [_map_cloud(pc, lambda a: a.to(dev)) for pc in srcs[sl]],
            [_map_cloud(pc, lambda a: a.to(dev)) for pc in tgts[sl]],
            inits[sl].to(dev), threshold=threshold, method=method,
            max_iterations=max_iterations)
    return RegistrationResult(*(
        torch.cat(mesh.all_gather({k: getattr(r, name) for k, r in parts.items()}))
        for name in RegistrationResult._fields))
