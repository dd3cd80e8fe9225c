"""Voxel-grid downsampling into a fixed-capacity buffer (twin of
recon3d_tpu/pointcloud/voxel.py: `voxel_downsample`, `voxel_ids`).

Open3D semantics (voxel_down_sample): all points falling in a voxel are
averaged (positions, colors, normals alike). As in the JAX package:
  1. integer voxel coordinates floor((p - origin) * (1 / voxel_size)),
  2. a stable lexicographic sort (invalid points sort last),
  3. heads of runs mark voxels; a running count gives segment ids, and
     voxels beyond `capacity` share one overflow bucket with the invalid
     points,
  4. per-voxel sums by a segmented reduction over the sorted order
     (`torch.segment_reduce`: each segment summed on its own, in order, so
     no voxel's sum is the difference of two large prefix sums, and the
     result does not depend on the order of atomics); mean = sum / count.
"""
from __future__ import annotations

from typing import Optional

import torch

from recon3d_tpu_torch.utils.types import PointCloud

SENT = 2 ** 30  # voxel coordinate of invalid points: sorts after every real voxel


def _lexsort_rows(v: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic order of (N, 3) int rows, column 0 first
    (jnp.lexsort((v2, v1, v0))): three stable sorts, last key first."""
    order = torch.sort(v[:, 2], stable=True).indices
    for col in (1, 0):
        order = order[torch.sort(v[order, col], stable=True).indices]
    return order


def voxel_downsample(pc: PointCloud, voxel_size: float, capacity: Optional[int] = None,
                     origin: float = 0.0) -> PointCloud:
    """Average points per voxel into min(capacity, N) rows (capacity
    defaults to the input's N, which no voxel count can exceed); voxels
    beyond capacity are dropped."""
    N = pc.capacity
    cap = capacity or N
    dev = pc.points.device
    inv = 1.0 / torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    v = torch.floor((pc.points - origin) * inv).to(torch.int32)
    v = torch.where(pc.valid[:, None], v, SENT)

    order = _lexsort_rows(v)
    vs = v[order]
    valid_s = pc.valid[order]
    # a segment starts at each new voxel; runs are cut before the invalid tail
    head = torch.ones(N, dtype=torch.bool, device=dev)
    head[1:] = (vs[1:] != vs[:-1]).any(dim=1)
    seg = torch.cumsum((head & valid_s).to(torch.int32), 0) - 1  # 0-based voxel id
    seg = torch.where(valid_s & (seg < cap), seg, cap)  # overflow bucket

    chans = [valid_s.to(torch.float32)[:, None], pc.points[order]]
    if pc.colors is not None:
        chans.append(pc.colors[order])
    if pc.normals is not None:
        chans.append(pc.normals[order])
    X = torch.cat(chans, 1) * chans[0]  # (N, C) per-point contributions
    # seg is nondecreasing: segment j holds the rows of voxel j (j < cap)
    lengths = torch.bincount(seg, minlength=cap + 1)
    # the buffer holds min(cap, N) rows, as the JAX package's argsort slice
    sums = torch.segment_reduce(X, "sum", lengths=lengths, axis=0, unsafe=True)[:min(cap, N)]

    counts = sums[:, 0]
    denom = torch.clamp(counts, min=1.0)[:, None]
    pts = sums[:, 1:4] / denom
    c0 = 4
    cols = nrm = None
    if pc.colors is not None:
        cols = sums[:, c0:c0 + 3] / denom
        c0 += 3
    if pc.normals is not None:
        nrm = sums[:, c0:c0 + 3]
        nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=1, keepdim=True), min=1e-12)
    return PointCloud(points=pts, valid=counts > 0, colors=cols, normals=nrm)


def voxel_ids(points: torch.Tensor, valid: torch.Tensor, voxel_size: float,
              origin: float = 0.0) -> torch.Tensor:
    """Integer voxel coordinates (N, 3); invalid rows get a sentinel."""
    size = torch.tensor(voxel_size, dtype=torch.float32, device=points.device)
    v = torch.floor((points - origin) / size).to(torch.int32)
    return torch.where(valid[:, None], v, SENT)
