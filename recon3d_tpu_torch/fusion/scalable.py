"""Scalable TSDF: hashed voxel bricks with static shapes (twin of
recon3d_tpu/fusion/scalable.py).

Replaces o3d.pipelines.integration.ScalableTSDFVolume (mini1.py:33-37,
check90.py:36-41) for unbounded scenes: the dense grid of fusion/tsdf.py
caps the working volume at resolution * voxel_size (~1 m at the defaults),
while real scans sweep rooms. Everything stays on the device:

- a fixed pool of `capacity` bricks of brick_size^3 voxels each;
- an open-addressing hash table; each probe round, unresolved keys
  scatter-min themselves into a claim buffer (`scatter_reduce_` "amin", an
  order-free reduction, so the card and the host resolve insertion races
  alike), the smallest key taking each free slot;
- allocate-on-first-touch per frame: candidate bricks come from the depth
  image's backprojected points at the surface +/- sdf_trunc along the ray,
  deduplicated by a sort;
- voxel-centric masked updates over the whole pool (only allocated bricks
  change), with a weight cap so long streams keep a moving average. The
  update samples the depth with a plain gather, as the JAX package does
  (K9 serves the dense volume only).

The hash multiplies and shifts 32-bit unsigned words; PyTorch's uint32
lacks those operations on most backends, so they run in int64 on the low 32
bits (`_hash`). The arithmetic rounds as the jitted JAX integrate on the CPU
(fusion/tsdf.py's helpers: fused multiply-adds where XLA contracts them).

Meshing: export_dense() scatters bricks into a dense TSDFVolume over a
window, then fusion/marching.py applies; extract_triangle_mesh() marches
the occupied windows only. Host-side: integrate's 4x4 inverse, maybe_grow
(two scalar reads), occupied_bounds / occupied_window_origins, save / load.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from recon3d_tpu_torch.fusion.tsdf import TSDFVolume, _cam_coords, _project
from recon3d_tpu_torch.ops.image import fma
from recon3d_tpu_torch.utils.types import CameraIntrinsics, TriangleMesh

logger = logging.getLogger("recon3d_tpu_torch.fusion.scalable")

EMPTY = -1
_KEY_BIAS = 512  # brick coords in [-512, 512) pack into 10 bits each
_KEY_EMPTY = 2 ** 30  # sorts after every real key
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ScalableTSDFVolume:
    """Brick pool + hash table, all tensors on one device.

    brick_keys: (K,) int32 packed brick coordinates (or -1 unallocated)
    table:      (T,) int32 hash slots -> brick index (or -1)
    tsdf/weight:(K, B, B, B) float32; color (K, B, B, B, 3) float32 or None
    origin:     (3,) float32; voxel_size, sdf_trunc: 0-d float32
    n_alloc:    0-d int32 allocated brick count
    n_dropped:  0-d int32 candidate bricks lost to pool / table overflow
    """

    brick_keys: torch.Tensor
    table: torch.Tensor
    tsdf: torch.Tensor
    weight: torch.Tensor
    origin: torch.Tensor
    voxel_size: torch.Tensor
    sdf_trunc: torch.Tensor
    n_alloc: torch.Tensor
    n_dropped: torch.Tensor
    color: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.tsdf.shape[0]

    @property
    def brick_size(self) -> int:
        return self.tsdf.shape[1]

    def occupancy(self) -> torch.Tensor:
        return self.n_alloc / self.capacity


def make_scalable_volume(
    voxel_size: float = 0.004,
    sdf_trunc: float = 0.02,
    brick_size: int = 8,
    capacity: int = 4096,
    table_size: int = 16384,
    origin=(0.0, 0.0, 0.0),
    with_color: bool = True,
    device="cuda",
) -> ScalableTSDFVolume:
    if table_size & (table_size - 1):
        raise ValueError(f"table_size must be 2^n, got {table_size}")
    K, B = capacity, brick_size

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    return ScalableTSDFVolume(
        brick_keys=torch.full((K,), EMPTY, dtype=torch.int32, device=device),
        table=torch.full((table_size,), EMPTY, dtype=torch.int32, device=device),
        tsdf=torch.zeros((K, B, B, B), dtype=torch.float32, device=device),
        weight=torch.zeros((K, B, B, B), dtype=torch.float32, device=device),
        color=torch.zeros((K, B, B, B, 3), dtype=torch.float32, device=device)
        if with_color else None,
        origin=f32(origin), voxel_size=f32(voxel_size), sdf_trunc=f32(sdf_trunc),
        n_alloc=i32(0), n_dropped=i32(0))


def _pack_key(bc: torch.Tensor) -> torch.Tensor:
    """(..., 3) int32 brick coords -> packed int32 key (10 bits an axis)."""
    b = bc + _KEY_BIAS
    ok = ((b >= 0) & (b < 1024)).all(-1)
    key = (b[..., 0] * 1024 + b[..., 1]) * 1024 + b[..., 2]
    return torch.where(ok, key, _KEY_EMPTY).to(torch.int32)


def _unpack_key(key: torch.Tensor) -> torch.Tensor:
    bz = key % 1024
    by = (key // 1024) % 1024
    bx = key // (1024 * 1024)
    return torch.stack([bx, by, bz], -1) - _KEY_BIAS


def _mul_u32(u: torch.Tensor, m: int) -> torch.Tensor:
    """u * m mod 2^32 of int64 words u < 2^32, in two 16-bit halves of m so
    that no product leaves int64's range."""
    lo = u * (m & 0xFFFF)
    hi = ((u * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash(key: torch.Tensor, table_size: int) -> torch.Tensor:
    """The JAX package's murmur-style uint32 avalanche of the int32 keys
    (masking the low bits of a bare multiplicative hash would make slots
    depend on the low key bits only), as int64 slots in [0, table_size)."""
    u = key.to(torch.int64) & _U32
    u = _mul_u32(u, 2654435761)
    u = u ^ (u >> 16)
    u = _mul_u32(u, 2246822519)
    u = u ^ (u >> 13)
    return u & (table_size - 1)


def _lookup(vol: ScalableTSDFVolume, keys: torch.Tensor, probes: int = 8) -> torch.Tensor:
    """Batched hash lookup: packed keys -> brick indices (or -1)."""
    T = vol.table.shape[0]
    found = torch.full(keys.shape, EMPTY, dtype=torch.int32, device=keys.device)
    h = _hash(keys, T)
    for p in range(probes):
        cand = vol.table[(h + p) & (T - 1)]
        ck = torch.where(cand >= 0, vol.brick_keys[torch.clamp(cand, min=0).long()], _KEY_EMPTY)
        hit = (found < 0) & (cand >= 0) & (ck == keys)
        found = torch.where(hit, cand, found)
    return found


def _claim(T: int, slot: torch.Tensor, free: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """One claim round: the smallest free key scattered to each slot."""
    claim = torch.full((T,), _KEY_EMPTY, dtype=torch.int32, device=keys.device)
    return claim.scatter_reduce_(0, torch.where(free, slot, T - 1),
                                 torch.where(free, keys, _KEY_EMPTY), "amin")


def _set_dropping(dst: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """dst.at[where(keep, idx, len)].set(where(keep, values, -1),
    mode="drop"): writes into a buffer one row longer, then the slice."""
    n = dst.shape[0]
    buf = torch.cat([dst, dst.new_full((1,), EMPTY)])
    buf[torch.where(keep, idx, n)] = torch.where(keep, values, EMPTY).to(dst.dtype)
    return buf[:n]


def _allocate(vol: ScalableTSDFVolume, cand_keys: torch.Tensor,
              probes: int = 8) -> ScalableTSDFVolume:
    """Insert candidate packed keys (any shape, _KEY_EMPTY = skip). Each probe
    round, unresolved keys claim free slots (smallest key wins), winners take
    the slot and the next pool index, losers probe the next slot. Pool /
    table overflow adds to n_dropped."""
    K = vol.capacity
    T = vol.table.shape[0]
    skeys = torch.sort(cand_keys.reshape(-1)).values
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    keys = torch.where(first & (skeys < _KEY_EMPTY), skeys, _KEY_EMPTY)

    table, brick_keys = vol.table, vol.brick_keys
    n_alloc, n_drop = vol.n_alloc, vol.n_dropped
    unresolved = keys < _KEY_EMPTY
    h = _hash(keys, T)
    for p in range(probes):
        slot = (h + p) & (T - 1)
        cur = table[slot]
        curk = torch.where(cur >= 0, brick_keys[torch.clamp(cur, min=0).long()], _KEY_EMPTY)
        hit = unresolved & (cur >= 0) & (curk == keys)
        unresolved = unresolved & ~hit
        free = unresolved & (cur < 0)
        won = free & (_claim(T, slot, free, keys)[slot] == keys)
        new_idx = n_alloc + torch.cumsum(won.to(torch.int32), 0) - 1
        ok = won & (new_idx < K)
        table = _set_dropping(table, slot, ok, new_idx)
        brick_keys = _set_dropping(brick_keys, new_idx.long(), ok, keys)
        n_alloc = n_alloc + ok.sum(dtype=torch.int32)
        n_drop = n_drop + (won & ~ok).sum(dtype=torch.int32)
        unresolved = unresolved & ~won
    n_drop = n_drop + unresolved.sum(dtype=torch.int32)
    return dataclasses.replace(vol, table=table, brick_keys=brick_keys,
                               n_alloc=n_alloc.to(torch.int32), n_dropped=n_drop.to(torch.int32))


def _rebuild_table(brick_keys: torch.Tensor, table_size: int,
                   probes: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hash table of an existing (unique-key) brick pool, the rehash of
    grow(): _allocate's claim rounds, mapping slots to the bricks' existing
    pool indices. Also returns the count of live bricks that found no slot
    within `probes` (grow() folds it into n_dropped)."""
    T = table_size
    K = brick_keys.shape[0]
    dev = brick_keys.device
    keys = torch.where(brick_keys >= 0, brick_keys, _KEY_EMPTY)
    idxs = torch.arange(K, dtype=torch.int32, device=dev)
    table = torch.full((T,), EMPTY, dtype=torch.int32, device=dev)
    unresolved = keys < _KEY_EMPTY
    h = _hash(keys, T)
    for p in range(probes):
        slot = (h + p) & (T - 1)
        free = unresolved & (table[slot] < 0)
        won = free & (_claim(T, slot, free, keys)[slot] == keys)
        table = _set_dropping(table, slot, won, idxs)
        unresolved = unresolved & ~won
    return table, unresolved.sum(dtype=torch.int32)


def grow(vol: ScalableTSDFVolume, capacity: Optional[int] = None,
         table_size: Optional[int] = None) -> ScalableTSDFVolume:
    """A volume with a larger brick pool (default 2x) and a rehashed table;
    existing bricks keep their pool indices, so the TSDF is untouched.
    n_dropped becomes the rehash's losses (the re-scan after growth
    re-touches any surface the dropped bricks covered)."""
    K = vol.capacity
    newK = capacity if capacity is not None else 2 * K
    newT = table_size if table_size is not None else 2 * vol.table.shape[0]
    if newK < K or newT & (newT - 1):
        raise ValueError(f"grow needs capacity >= {K} and a 2^n table, got {newK}, {newT}")

    def grow_pool(a, fill):
        return torch.cat([a, a.new_full((newK - K,) + tuple(a.shape[1:]), fill)])

    brick_keys = grow_pool(vol.brick_keys, EMPTY)
    table, n_unplaced = _rebuild_table(brick_keys, newT)
    return dataclasses.replace(
        vol, brick_keys=brick_keys, table=table, tsdf=grow_pool(vol.tsdf, 0.0),
        weight=grow_pool(vol.weight, 0.0),
        color=None if vol.color is None else grow_pool(vol.color, 0.0),
        n_dropped=n_unplaced)


def maybe_grow(vol: ScalableTSDFVolume, occupancy_threshold: float = 0.85,
               max_capacity: int = 1 << 20) -> ScalableTSDFVolume:
    """Host-side growth policy: call between frames. Doubles the pool when
    occupancy crosses the threshold or candidate bricks were dropped (logged
    as a warning). Costs two scalar device reads."""
    n_alloc = int(vol.n_alloc)
    n_dropped = int(vol.n_dropped)
    if n_dropped > 0:
        logger.warning("scalable TSDF dropped %d candidate bricks (pool %d/%d full) — "
                       "growing", n_dropped, n_alloc, vol.capacity)
    if n_dropped > 0 or n_alloc > occupancy_threshold * vol.capacity:
        if vol.capacity >= max_capacity:
            if n_dropped > 0:
                logger.error("scalable TSDF at max capacity %d; dropping bricks", vol.capacity)
            return vol
        return grow(vol)
    return vol


def integrate(
    vol: ScalableTSDFVolume,
    depth: torch.Tensor,
    intr: CameraIntrinsics,
    extrinsic,
    color: Optional[torch.Tensor] = None,
    depth_trunc: float = 3.0,
    weight_max: float = 64.0,
    alloc_stride: int = 2,
) -> ScalableTSDFVolume:
    """Fuse one depth (+ color) frame: allocate the touched bricks, then
    update; returns a new volume.

    extrinsic: (4, 4) camera_from_world, as fusion/tsdf.py's integrate.
    weight_max caps the accumulated weights (a moving average on long
    streams).
    """
    dev = vol.tsdf.device
    B = vol.brick_size
    depth = torch.as_tensor(depth, dtype=torch.float32).to(dev)
    H, W = depth.shape

    # ---- allocation: bricks touched by surface +/- trunc along the ray
    cam_from_world = torch.as_tensor(extrinsic, dtype=torch.float32).to(dev)
    # the 4x4 inverse on the host, LAPACK's on every device: an ulp of the
    # card's solver would move points across brick faces and allocate other
    # bricks than the host (one sync a frame, as maybe_grow's reads)
    world_from_cam = torch.linalg.inv(cam_from_world.cpu()).to(dev)
    ds = depth[::alloc_stride, ::alloc_stride]
    h, w = ds.shape
    u = (torch.arange(w, dtype=torch.float32, device=dev) * alloc_stride).expand(h, w)
    v = (torch.arange(h, dtype=torch.float32, device=dev) * alloc_stride)[:, None].expand(h, w)
    ok = (ds > 1e-4) & (ds < depth_trunc)
    # divide by 0-d tensors: CUDA divides by a Python scalar as a product
    # with its reciprocal
    fx, fy = (torch.full((), f, dtype=torch.float32, device=dev) for f in (intr.fx, intr.fy))
    rays = torch.stack([(u - intr.cx) / fx, (v - intr.cy) / fy, torch.ones_like(ds)], -1)
    span = vol.voxel_size * B
    cands = []
    for t in (-1.0, 0.0, 1.0):
        z = ds + t * vol.sdf_trunc
        pw = torch.stack(_cam_coords(rays * z[..., None], world_from_cam), -1)
        bc = torch.floor((pw - vol.origin) / span).to(torch.int32)
        cands.append(torch.where(ok, _pack_key(bc), _KEY_EMPTY))
    vol = _allocate(vol, torch.stack(cands))

    # ---- voxel-centric update over the whole pool (masked)
    bc = _unpack_key(torch.clamp(vol.brick_keys, min=0))  # (K, 3)
    alive = vol.brick_keys >= 0
    idx = torch.arange(B, dtype=torch.float32, device=dev)
    local = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1)  # (B, B, B, 3)
    g = bc.to(torch.float32)[:, None, None, None, :] * B + local  # (K, B, B, B, 3)
    pts = fma(g, vol.voxel_size.expand_as(g), vol.origin.expand_as(g))
    z, inb, vc, uc = _project(pts, H, W, intr, cam_from_world)
    del pts, g
    inb = inb & alive[:, None, None, None]
    vcl, ucl = vc.long(), uc.long()
    d = depth[vcl, ucl]
    valid_d = (d > 1e-4) & (d < depth_trunc) & inb
    sdf = d - z
    tsdf_new = torch.clamp(sdf / vol.sdf_trunc, -1.0, 1.0)
    upd = valid_d & (sdf > -vol.sdf_trunc)
    w_old = vol.weight
    w_sum = w_old + upd.to(torch.float32)
    den = torch.clamp(w_sum, min=1.0)
    tsdf = torch.where(upd, fma(vol.tsdf, w_old, tsdf_new) / den, vol.tsdf)
    out = dataclasses.replace(vol, tsdf=tsdf, weight=torch.clamp(w_sum, max=weight_max))
    if vol.color is not None and color is not None:
        c = torch.as_tensor(color).to(dev)
        if c.dtype == torch.uint8:
            c = c.to(torch.float32) * (1.0 / torch.full((), 255.0, dtype=torch.float32,
                                                        device=dev))
        cf = c.to(torch.float32)[vcl, ucl]
        w3 = w_old[..., None].expand_as(cf)
        cnew = torch.where(upd[..., None], fma(vol.color, w3, cf) / den[..., None], vol.color)
        out = dataclasses.replace(out, color=cnew)
    return out


def export_dense(vol: ScalableTSDFVolume, window_origin, resolution: int = 256) -> TSDFVolume:
    """Scatter bricks into a dense TSDFVolume covering [window_origin,
    window_origin + resolution * voxel_size)^3: the bridge to the dense
    marching and point extraction."""
    B = vol.brick_size
    R = resolution
    dev = vol.tsdf.device
    bc = _unpack_key(torch.clamp(vol.brick_keys, min=0))
    alive = vol.brick_keys >= 0
    base_vox = bc * B  # (K, 3) voxel coords in the global lattice
    win = torch.as_tensor(window_origin, dtype=torch.float32).to(dev)
    win0 = torch.round((win - vol.origin) / vol.voxel_size).to(torch.int32)
    idx = torch.arange(B, dtype=torch.int32, device=dev)
    lx, ly, lz = torch.meshgrid(idx, idx, idx, indexing="ij")
    gx = base_vox[:, 0, None, None, None] + lx - win0[0]
    gy = base_vox[:, 1, None, None, None] + ly - win0[1]
    gz = base_vox[:, 2, None, None, None] + lz - win0[2]
    inside = ((gx >= 0) & (gx < R) & (gy >= 0) & (gy < R) & (gz >= 0) & (gz < R)
              & alive[:, None, None, None])
    at = (torch.where(inside, gx, R).long(), torch.where(inside, gy, 0).long(),
          torch.where(inside, gz, 0).long())

    def scatter(src, tail=()):
        out = torch.zeros((R + 1, R, R) + tail, dtype=torch.float32, device=dev)
        mask = inside[..., None] if tail else inside
        out[at] = torch.where(mask, src, 0.0)
        return out[:R]

    return TSDFVolume(tsdf=scatter(vol.tsdf), weight=scatter(vol.weight),
                      color=None if vol.color is None else scatter(vol.color, (3,)),
                      origin=vol.origin + win0.to(torch.float32) * vol.voxel_size,
                      voxel_size=vol.voxel_size, sdf_trunc=vol.sdf_trunc)


def _alive_bricks(vol: ScalableTSDFVolume) -> np.ndarray:
    """(n, 3) int brick coordinates of the allocated bricks, on the host."""
    keys = vol.brick_keys
    return _unpack_key(keys[keys >= 0].long()).cpu().numpy()


def occupied_bounds(vol: ScalableTSDFVolume) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: (min_corner, max_corner) world AABB of allocated bricks."""
    bc = _alive_bricks(vol)
    if not len(bc):
        z = np.zeros(3, np.float32)
        return z, z
    B = vol.brick_size
    vs = float(vol.voxel_size)
    org = vol.origin.cpu().numpy()
    lo = org + bc.min(0) * B * vs
    hi = org + (bc.max(0) + 1) * B * vs
    return lo.astype(np.float32), hi.astype(np.float32)


def occupied_window_origins(vol: ScalableTSDFVolume, window: int = 256) -> List[np.ndarray]:
    """World-space origins of the `window`^3 dense blocks that contain at
    least one allocated brick, found by walking the brick keys (not the
    dense AABB), so sparse scenes pay only for blocks with content. Blocks
    tile on a (window - 2)-voxel stride from the occupied min corner (a
    1-voxel overlap keeps cross-block surfaces closed)."""
    bc = _alive_bricks(vol)
    if not len(bc):
        return []
    B = vol.brick_size
    vs = float(vol.voxel_size)
    org = vol.origin.cpu().numpy()
    step_vox = window - 2
    lo_vox = bc.min(0) * B
    # a brick's voxel extent relative to the occupied min corner; a brick
    # straddles at most two windows an axis (B << window)
    vmin = bc * B - lo_vox
    vmax = vmin + B - 1
    w0 = vmin // step_vox
    w1 = vmax // step_vox
    wins = set()
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                sel = np.stack([w0[:, 0] if dx == 0 else w1[:, 0],
                                w0[:, 1] if dy == 0 else w1[:, 1],
                                w0[:, 2] if dz == 0 else w1[:, 2]], -1)
                wins.update(map(tuple, sel.tolist()))
    base = org + lo_vox * vs
    return [np.asarray(base + np.asarray(w, np.float64) * step_vox * vs, np.float32)
            for w in sorted(wins)]


def extract_triangle_mesh(vol: ScalableTSDFVolume, window: int = 256) -> TriangleMesh:
    """Mesh the occupied extent: dense-export and march only the occupied
    `window`^3 blocks (occupied_window_origins), with a 1-voxel overlap so
    surfaces crossing block borders stay closed; then the cleanup chain."""
    from recon3d_tpu_torch.fusion import marching
    from recon3d_tpu_torch.mesh import ops as mops

    dev = vol.tsdf.device
    lo, _hi = occupied_bounds(vol)
    meshes = []
    for origin in occupied_window_origins(vol, window):
        v, t, c, _ = marching.extract_triangle_mesh(export_dense(vol, origin, window)).to_numpy()
        if len(t):
            meshes.append((v, t, c))
    if not meshes:
        return marching.extract_triangle_mesh(export_dense(vol, lo, window))
    verts = np.concatenate([m[0] for m in meshes], 0)
    cols = np.concatenate([m[2] for m in meshes], 0) if meshes[0][2] is not None else None
    tris, off = [], 0
    for v, t, _ in meshes:
        tris.append(t + off)
        off += len(v)
    tris = np.concatenate(tris, 0).astype(np.int32)
    mesh = TriangleMesh(
        vertices=torch.as_tensor(verts, dtype=torch.float32, device=dev),
        triangles=torch.as_tensor(tris, device=dev),
        vertex_valid=torch.ones((len(verts),), dtype=torch.bool, device=dev),
        triangle_valid=torch.ones((len(tris),), dtype=torch.bool, device=dev),
        vertex_colors=None if cols is None else torch.as_tensor(cols, dtype=torch.float32,
                                                                device=dev))
    return mops.cleanup(mesh)


_FIELDS = ("brick_keys", "table", "tsdf", "weight", "origin", "voxel_size", "sdf_trunc",
           "n_alloc", "n_dropped")


def save_scalable_volume(path: str, vol: ScalableTSDFVolume) -> str:
    """Checkpoint the brick pool + hash table to one compressed NPZ (the JAX
    package's keys, so either package loads the other's checkpoints)."""
    d = {k: getattr(vol, k).cpu().numpy() for k in _FIELDS}
    if vol.color is not None:
        d["color"] = vol.color.cpu().numpy()
    np.savez_compressed(path, **d)
    return path


def load_scalable_volume(path: str, device="cuda") -> ScalableTSDFVolume:
    """Load a save_scalable_volume checkpoint onto `device`."""
    with np.load(path) as d:
        return ScalableTSDFVolume(
            **{k: torch.as_tensor(np.array(d[k]), device=device) for k in _FIELDS},
            color=torch.as_tensor(np.array(d["color"]), device=device) if "color" in d else None)
