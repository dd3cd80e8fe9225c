"""Row-sharded semi-global matching (twin of recon3d_tpu/depth/sgm_sharded.py).

One frame's (H, W, D) cost volume is split over a mesh's row axis
(parallel/mesh.py). The horizontal paths and the finalize are row-local
and run on each shard. The vertical and diagonal paths cross the shard
boundaries and run as a carry-plane relay: a shard's last (W, D) carry
(two of them for a diagonal pair) goes to its neighbour, which scans its
own rows from it (K10 / K11, depth/sgm_cuda.py, through their in-place
entries on the shards' own volumes). The box window's and the
prefilter's support at the seams comes from halo rows of the neighbours'
PREFILTERED planes (exchanging raw rows would replicate twice at the
image's edges). Every kernel computes the single-device path's
integer-valued f32 arithmetic and the carries are relayed, never
approximated, so the result equals sgm_disparity_cuda bit for bit.

Heights that do not split into n shards of 8-row-aligned rows are padded
with edge-replicated rows (1080 -> 1088 on 2, 4 or 8 shards). The last
shard's pad rows are dead: its prefiltered planes there repeat its last
real row, and the relays take and hand on their carries at its last real
row (`h_real`).

Kernels a frame on n shards: K2 (cost + L_fwd on the halo-extended rows)
n, K13 (K3's backward scan on a shard, counted apart from K3) n, K10 n for
each vertical direction, K11 n for each diagonal direction (SGM-8), K12
(the finalize) n.

JAX runs every shard in every relay round and keeps round k's result on
shard k. Here shard k waits for its neighbour's carry, scans once with its
own real rows and sends its carry on: the same result without the n-fold
work. On the in-process mesh the shards run one after another on one
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from recon3d_tpu_torch import kernels
from recon3d_tpu_torch.depth import sgm_cuda
from recon3d_tpu_torch.parallel.mesh import Mesh

_HALO = 8  # prefiltered plane rows exchanged per side (>= the box radius)


def bwd_accumulate_shard(cost_u16: torch.Tensor, v1: torch.Tensor, p1: float,
                         p2: float) -> torch.Tensor:
    """K13: v3 = v1 + L_bwd on one shard's volumes, written over v1
    (sgm_sharded._bwd_accumulate). The TPU reused K3's kernel body for it;
    this launches K3's kernel and counts the launch here, not on K3."""
    sgm_cuda._check_volumes(cost_u16, v1)
    if not kernels.use_kernel(cost_u16, v1):
        return sgm_cuda.bwd_accumulate_plain(cost_u16, v1, p1, p2)
    sgm_cuda.launch_bwd_accumulate(cost_u16, v1, p1, p2)
    bwd_accumulate_shard.launches += 1
    return v1


bwd_accumulate_shard.launches = 0


@dataclass
class RowShards:
    """One frame's padded volumes over a row mesh: the int16 cost and the
    f32 path sum (v1, then v3, then S) of each local shard, each
    (ceil(Hl, 64), WP, DP); the frame is H x W, a shard holds Hl rows and
    the last shard's final `pad` rows are dead."""

    mesh: Mesh
    H: int
    W: int
    Hl: int
    pad: int
    cost: Dict[int, torch.Tensor]
    S: Dict[int, torch.Tensor]

    def h_real(self, k: int) -> int:
        """Shard k's real rows."""
        return self.Hl - (self.pad if k == self.mesh.n - 1 else 0)


def _with_halos(mesh: Mesh, xs: Dict[int, torch.Tensor], halo: int) -> Dict[int, torch.Tensor]:
    """Each local shard's (C, rows, W) planes with `halo` rows of each
    neighbour's above and below; the first and the last shard repeat their
    own edge row instead (the single-device path's edge padding)."""
    n = mesh.n
    above = mesh.ppermute({k: x[:, -halo:] for k, x in xs.items()},
                          [(i, i + 1) for i in range(n - 1)])
    below = mesh.ppermute({k: x[:, :halo] for k, x in xs.items()},
                          [(i, i - 1) for i in range(1, n)])
    return {k: torch.cat([above.get(k, x[:, :1].expand(-1, halo, -1)), x,
                          below.get(k, x[:, -1:].expand(-1, halo, -1))], 1)
            for k, x in xs.items()}


def _crop_pad(v: torch.Tensor, rows: int, padded: int) -> torch.Tensor:
    """The `rows` rows after the halo, zero-padded to `padded` rows."""
    out = v.new_zeros((padded,) + tuple(v.shape[1:]))
    out[:rows] = v[_HALO:_HALO + rows]
    return out


def shard_volumes(left_gray: torch.Tensor, right_gray: torch.Tensor, mesh: Mesh,
                  num_disparities: int, min_disparity: int, block_size: int,
                  pre_filter_cap: int, p1: float, p2: float) -> RowShards:
    """The local shards' cost and v1 = L_fwd (sgm_sharded.py:137-201): the
    one-row raw halo and the prefilter, the last shard's pad rows set to its
    last real plane row, the 8-row halo of the prefiltered planes, K2 on the
    halo-extended rows, the halo cropped and the rows re-padded to 64."""
    n = mesh.n
    H, W = left_gray.shape
    Hpad = -(-H // (n * 8)) * (n * 8)
    pad = Hpad - H
    Hl = Hpad // n
    if Hl - pad < _HALO:
        raise ValueError(f"H={H} leaves the last of {n} shards only {Hl - pad} real rows "
                         f"(< the {_HALO}-row halo); use fewer shards")
    pair = torch.stack([torch.as_tensor(g, dtype=torch.float32) for g in (left_gray, right_gray)])
    pair = pair.to(mesh.device)
    if pad:
        pair = torch.cat([pair, pair[:, -1:].expand(-1, pad, -1)], 1)
    ext1 = _with_halos(mesh, {k: pair[:, k * Hl:(k + 1) * Hl] for k in mesh.local}, 1)
    planes = {}
    for k, x in ext1.items():
        p = torch.stack(sgm_cuda.prefilter_planes(x[0], x[1], pre_filter_cap))[:, 1:-1]
        if pad:
            rows = k * Hl + torch.arange(Hl, device=p.device)
            last = min(max(H - 1 - k * Hl, 0), Hl - 1)
            p = torch.where((rows >= H)[None, :, None], p[:, last:last + 1], p)
        planes[k] = p
    del ext1, pair
    ext = _with_halos(mesh, planes, _HALO)
    del planes
    HLP, WP, DP = sgm_cuda.padded_shape(Hl, W, num_disparities)
    HPE = sgm_cuda.padded_shape(Hl + 2 * _HALO, W, num_disparities)[0]
    cost, S = {}, {}
    for k in mesh.local:
        cost_e, v1_e = sgm_cuda.cost_fwd_down(None, None, num_disparities, min_disparity,
                                              block_size, pre_filter_cap, p1, p2, HPE, WP, DP,
                                              False, planes=tuple(ext.pop(k)))
        cost[k], S[k] = _crop_pad(cost_e, Hl, HLP), _crop_pad(v1_e, Hl, HLP)
        del cost_e, v1_e
    return RowShards(mesh, H, W, Hl, pad, cost, S)


def relay(sh: RowShards, scan, carry_planes: Tuple[int, ...], reverse: bool, p1: float,
          p2: float) -> None:
    """One path pass over the shards in chain order (down: 0 to n-1, up:
    n-1 to 0), in place on sh.S: each local shard takes its neighbour's
    carry (zero for the first), runs `scan` in place on its volume
    (sgm_cuda._vscan_carry_ with carry_planes (), _diag_carry_ with (2,))
    over its rows and hands its carry on."""
    mesh, n = sh.mesh, sh.mesh.n
    hop = -1 if reverse else 1
    for k in (range(n - 1, -1, -1) if reverse else range(n)):
        if k not in sh.S:
            continue
        shape = carry_planes + tuple(sh.S[k].shape[1:])
        src, dst = k - hop, k + hop
        carry = (mesh.recv(src, k, shape) if 0 <= src < n
                 else torch.zeros(shape, dtype=torch.float32, device=sh.S[k].device))
        sh.S[k], carry = scan(sh.cost[k], sh.S[k], carry, p1, p2, reverse, sh.h_real(k))
        if 0 <= dst < n:
            mesh.send(carry, k, dst)


def aggregate(sh: RowShards, p1: float, p2: float, num_directions: int) -> None:
    """v1 -> S in place on the shards: the backward path (K13), then the
    relays of the downward path, the upward one (4 and 8 directions) and
    the two diagonal pairs (8 directions)."""
    for k in sh.S:
        bwd_accumulate_shard(sh.cost[k], sh.S[k], p1, p2)
    relay(sh, sgm_cuda._vscan_carry_, (), False, p1, p2)
    if num_directions >= 4:
        relay(sh, sgm_cuda._vscan_carry_, (), True, p1, p2)
    if num_directions == 8:
        relay(sh, sgm_cuda._diag_carry_, (2,), False, p1, p2)
        relay(sh, sgm_cuda._diag_carry_, (2,), True, p1, p2)


def sgm_disparity_cuda_rowsharded(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    mesh: Mesh,
    axis_name: str = "row",
    num_disparities: int = 128,
    min_disparity: int = 0,
    block_size: int = 5,
    p1: float | None = None,
    p2: float | None = None,
    num_directions: int = 4,
    uniqueness_ratio: int = 10,
    disp12_max_diff: int = 1,
    speckle_window_size: int = 50,
    speckle_range: float = 32.0,
    pre_filter_cap: int = 63,
    do_subpixel: bool = True,
    speckle_method: str = "fast",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded twin of sgm_cuda.sgm_disparity_cuda, equal to it bit for
    bit: the (H, W) gray pair, the same on every process, -> (disparity f32
    incl. min_disparity, -1 on invalid pixels; valid bool), both (H, W) on
    every process. The speckle filter runs on the gathered frame, as the
    single-device tail."""
    if num_directions not in (3, 4, 8):
        raise ValueError(f"num_directions must be 3, 4 or 8, got {num_directions}")
    if block_size // 2 > _HALO:
        raise ValueError(f"block_size={block_size} needs {block_size // 2} prefiltered halo "
                         f"rows per side but only {_HALO} are exchanged")
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")
    if p1 is None:
        p1 = 8.0 * block_size * block_size
    if p2 is None:
        p2 = 32.0 * block_size * block_size
    sh = shard_volumes(left_gray, right_gray, mesh, num_disparities, min_disparity, block_size,
                       pre_filter_cap, p1, p2)
    aggregate(sh, p1, p2, num_directions)
    disp, valid = {}, {}
    for k in mesh.local:
        del sh.cost[k]
        d, v = sgm_cuda.wta_finalize(sh.S.pop(k), num_disparities, uniqueness_ratio,
                                     disp12_max_diff, do_subpixel, w_real=sh.W)
        disp[k], valid[k] = d[:sh.Hl, :sh.W], v[:sh.Hl, :sh.W]
    disp_raw = torch.cat(mesh.all_gather(disp))[:sh.H]
    valid = torch.cat(mesh.all_gather(valid))[:sh.H]
    return sgm_cuda.finish_disparity(disp_raw, valid, num_disparities, min_disparity,
                                     speckle_window_size, speckle_range, speckle_method)
