"""Incremental mesh extraction over a dense TSDF volume (twin of
recon3d_tpu/fusion/incremental.py).

A live re-mesh (a viewer's per-frame extract, mini1.py:357-360) need not
re-extract the whole volume: one integrated frame only perturbs the visible
surface shell. This module tracks mesh-relevant change per z-slab (the same
8-row slabs the full extractor walks) and refreshes only dirty slabs:

  - `integrate` wraps tsdf.integrate_donated(with_changed_z=True): an (R,)
    bool z-profile of bitwise tsdf / color change and weight-threshold
    crossings, mapped to the slab windows it touches.
  - `update` re-runs the full extractor's own `_slab_tris` and gradient
    orientation on the dirty slabs only, into a persistent per-slab
    triangle cache, and folds their corners into a persistent weld table
    (subtract the slab's old corners, insert its new ones): a refresh costs
    the dirty slabs' churn, not the soup.
  - `mesh_device` emits the welded mesh from the table as a fixed-capacity
    TriangleMesh with validity masks, with no host read.
  - `mesh` compacts it (extract_triangle_mesh's contract). Clean slabs are
    frozen and dirty slabs run the identical slab code, so it has the same
    welded vertex and face SETS as a full extract.

Cache layout (the JAX package's): slab i owns rows [i * cap, (i + 1) * cap)
of the soup. The full extractor packs slabs tightly with a cursor instead,
so soup ORDER differs from extract_triangle_soup, but the welded vertex and
face sets are identical (the tests canonicalize both).

Differences from the JAX program, none of which changes a welded set:
- Slabs march one after another (`_slab_tris` computes geometry for its
  emitted rows only), so there is no cap/8 "small-content" variant and no
  power-of-two batch sizes: dirty slabs refresh in chunks of `batch_k`,
  each chunk's corners probing the table in one loop that ends when all
  are resolved (one host read a round) or after `probes` rounds.
- The table's corner sums are float64: the sum of a slot's float32 corners
  is then exact, so subtract-and-insert never drifts and the card's atomic
  adds give the same bits in any order. A vertex is that sum over its count,
  rounded once to float32 (the full extract rounds its float32 sum first).
- A slot's color is that of the last corner (in lane order) that inserted
  into it, where the JAX scatter leaves the winner to the backend.
"""
from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from recon3d_tpu_torch.fusion import marching as _marching
from recon3d_tpu_torch.fusion import tsdf as _tsdf
from recon3d_tpu_torch.fusion.tsdf import TSDFVolume
from recon3d_tpu_torch.utils.types import CameraIntrinsics, TriangleMesh

_log = logging.getLogger(__name__)


class MeshCache(NamedTuple):
    """Persistent per-slab triangle cache + slot-keyed weld table.

    The weld table is an open-addressing hash over origin-quantized vertex
    keys whose slots PERSIST across refreshes. A dirty slab subtracts its old
    corners' contributions (tracked by `fslot`) and inserts its new ones.
    Slots whose count returns to zero keep their key (tombstones); a
    returning surface reuses them."""

    tri: torch.Tensor     # (n_slabs, cap, 3, 3) oriented triangle positions
    val: torch.Tensor     # (n_slabs, cap) bool
    fslot: torch.Tensor   # (n_slabs, cap, 3) int64 weld slot per corner
    dirty: torch.Tensor   # (n_slabs,) bool: slabs needing a refresh
    key: torch.Tensor     # (S, 3) int32 quantized vertex key per slot
    used: torch.Tensor    # (S,) bool slot claimed (persists at count 0)
    vsum: torch.Tensor    # (S, 3) float64 sum of the slot's corner copies
    vcnt: torch.Tensor    # (S,) int32 copy count
    ccol: torch.Tensor    # (S, 3) float32 last sampled vertex color
    nunres: torch.Tensor  # () int32 corners left slotless since the last reset
    ndrop: torch.Tensor   # (n_slabs,) int32 triangles each slab's cap cut at
    #                       its last refresh (sum = the mesh's truncation)


class IncrementalMesher:
    """Dirty-slab marching tetrahedra with a persistent triangle cache.

    Usage (a live fuse / re-mesh loop):
        im = IncrementalMesher(resolution=256)
        vol = im.integrate(vol, depth, intr, extrinsic, color)  # per frame
        mesh = im.mesh_device(vol)   # on demand; refreshes dirty slabs
    """

    def __init__(self, resolution: int, slab: int = 8, max_triangles: Optional[int] = None,
                 weight_min: float = 1.0, table_bits: Optional[int] = None, probes: int = 16,
                 batch_k: int = 8, cap_mult: int = 4, device="cuda"):
        R = resolution
        self.batch_k = batch_k
        self.R, self.slab, self.weight_min = R, slab, float(weight_min)
        self.device = torch.device(device)
        self.n_slabs = (R - 1) // slab + (1 if (R - 1) % slab else 0)
        if max_triangles is None:
            # extract_triangle_mesh's budget: the incremental mesh equals a
            # default full extract only if the two budgets (caps) agree
            max_triangles = _marching.default_max_triangles(R)
        # the full extractor's per-slab cap formula; cap_mult 4 keeps a wall
        # at constant z (the whole mesh in 1-2 slabs) from being truncated,
        # and what is cut is counted (dropped_triangles)
        self.cap_mult = cap_mult
        self.cap = _marching.slab_cap(R, slab, max_triangles, mult=cap_mult)
        # z-window per slab: start voxel and first-owned corner row (the
        # last slab is shifted in-bounds; z_lo masks the overlap rows)
        self._z0s = np.minimum(np.arange(self.n_slabs) * slab, R - 1 - slab).astype(np.int64)
        self._z_los = (np.arange(self.n_slabs) * slab).astype(np.int64)
        self._hit_rows = torch.as_tensor(
            np.clip(self._z0s[:, None] + np.arange(slab + 1)[None, :], 0, R - 1),
            device=self.device)
        # weld table ~4x the global triangle budget (unique vertices run
        # ~tris / 2, so its load stays under 0.25)
        if table_bits is None:
            table_bits = max(14, (max_triangles * 4 - 1).bit_length())
        self.table_bits, self.probes = table_bits, probes
        S = 1 << table_bits
        dev = self.device
        self.cache = MeshCache(
            tri=torch.zeros((self.n_slabs, self.cap, 3, 3), dtype=torch.float32, device=dev),
            val=torch.zeros((self.n_slabs, self.cap), dtype=torch.bool, device=dev),
            fslot=torch.zeros((self.n_slabs, self.cap, 3), dtype=torch.int64, device=dev),
            dirty=torch.ones((self.n_slabs,), dtype=torch.bool, device=dev),  # first = full
            key=torch.zeros((S, 3), dtype=torch.int32, device=dev),
            used=torch.zeros((S,), dtype=torch.bool, device=dev),
            vsum=torch.zeros((S, 3), dtype=torch.float64, device=dev),
            vcnt=torch.zeros((S,), dtype=torch.int32, device=dev),
            ccol=torch.zeros((S, 3), dtype=torch.float32, device=dev),
            nunres=torch.zeros((), dtype=torch.int32, device=dev),
            ndrop=torch.zeros((self.n_slabs,), dtype=torch.int32, device=dev),
        )
        # weld-table health: tombstones keep their keys, so a very long
        # session can exhaust probe chains; update() reads the unresolved
        # counter every `health_check_every` refreshes and rebuilds the
        # table when it is nonzero, bounding silent triangle loss to one
        # check window
        self.health_check_every = 64
        self._updates_since_check = 0
        self._warned_dropped = False

    # ---- integrate with dirty tracking -------------------------------
    def dirty_hits(self, changed_z: torch.Tensor) -> torch.Tensor:
        """(R,) changed-z profile -> (n_slabs,) slab hits, on the device (no
        host read: StreamingFusion calls it in its per-frame step). Slab i
        reads voxel rows [z0, z0 + slab], so it is hit iff any of them
        changed."""
        return changed_z[self._hit_rows].any(1)

    def integrate(self, vol: TSDFVolume, depth, intr: CameraIntrinsics, extrinsic,
                  color=None) -> TSDFVolume:
        """tsdf.integrate_donated twin that also accumulates dirty slabs
        (check90.py:188-226, the consumer's per-frame integrate)."""
        vol, changed_z = _tsdf.integrate_donated(vol, depth, intr, extrinsic, color=color,
                                                 with_changed_z=True,
                                                 changed_weight_min=self.weight_min)
        self.cache = self.cache._replace(dirty=self.cache.dirty | self.dirty_hits(changed_z))
        return vol

    def mark_all_dirty(self) -> None:
        """Invalidate the whole cache (e.g. after loading a checkpoint).
        Resets the persistent weld table too: after a reload the cached
        contributions no longer describe the table, so the next update()
        rebuilds from scratch rather than subtract stale sums."""
        c = self.cache
        self.cache = c._replace(
            dirty=torch.ones_like(c.dirty), val=torch.zeros_like(c.val),
            key=torch.zeros_like(c.key), used=torch.zeros_like(c.used),
            vsum=torch.zeros_like(c.vsum), vcnt=torch.zeros_like(c.vcnt),
            ccol=torch.zeros_like(c.ccol), nunres=torch.zeros_like(c.nunres),
            ndrop=torch.zeros_like(c.ndrop))

    # ---- dirty-slab refresh ------------------------------------------
    def _probe(self, q: torch.Tensor, used: torch.Tensor, key: torch.Tensor):
        """Probe M corner keys `q` (M, 3) against the persistent table: each
        round an unresolved corner claims its current slot if empty (the
        lowest lane wins, a scatter-min), and resolves where the slot's key
        is its own; the others probe on quadratically. Same-key corners
        share a probe path, so a key never splits across slots. Returns
        (used, key, slot of each corner, unresolved)."""
        M = q.shape[0]
        S = 1 << self.table_bits
        dev = q.device
        ql = q.to(torch.int64)
        # the JAX package's int32 hash wraps; its low table_bits bits are
        # those of the same products and xors in int64
        cur = ((ql[:, 0] * _marching._HASH_PRIMES[0]) ^ (ql[:, 1] * _marching._HASH_PRIMES[1])
               ^ (ql[:, 2] * _marching._HASH_PRIMES[2])) & (S - 1)
        lane = torch.arange(M, dtype=torch.int64, device=dev)
        slot_of = torch.zeros(M, dtype=torch.int64, device=dev)
        unresolved = torch.ones(M, dtype=torch.bool, device=dev)
        for p in range(self.probes):
            if not bool(unresolved.any()):
                break
            cand = torch.where(unresolved & ~used[cur], cur, S)
            claim = torch.full((S + 1,), M, dtype=torch.int64, device=dev)
            claim.scatter_reduce_(0, cand, lane, "amin")
            claim = claim[:S]
            won = claim < M
            used = used | won
            key = torch.where(won[:, None], q[torch.clamp(claim, max=max(M - 1, 0))], key)
            match = unresolved & used[cur] & (key[cur] == q).all(1)
            slot_of = torch.where(match, cur, slot_of)
            unresolved = unresolved & ~match
            cur = (cur + 2 * p + 1) & (S - 1)
        return used, key, slot_of, unresolved

    def _refresh(self, vol: TSDFVolume, idxs) -> None:
        """Refresh the slabs `idxs` (host ints): march them, subtract their
        old corners from the table, insert the new ones, and store the
        triangles, corner slots and drop counts in their cache rows."""
        c = self.cache
        dev = c.tri.device
        K, cap = len(idxs), self.cap
        tris, sels, drops = [], [], []
        for i in idxs:
            tri, sel, n, total = _marching._slab_tris(vol, int(self._z0s[i]),
                                                      int(self._z_los[i]), self.slab, cap,
                                                      self.weight_min)
            # the orientation reads only the slab's tsdf neighborhood, so
            # caching it stays exact
            tri[:n] = _marching._orient_by_gradient(vol, tri[:n])
            tris.append(tri)
            sels.append(sel)
            drops.append(total - n)
        tri = torch.stack(tris)  # (K, cap, 3, 3)
        sel = torch.stack(sels)  # (K, cap)
        ci = torch.as_tensor(idxs, dtype=torch.int64, device=dev)

        # remove the chunk's OLD contributions: exactly what earlier refreshes
        # added (val / fslot track them); the cache is the mesher's own, so
        # it is updated in place
        old_m = c.val[ci].reshape(-1).repeat_interleave(3)
        old_slot = c.fslot[ci].reshape(-1)[old_m]
        c.vsum.index_add_(0, old_slot, -c.tri[ci].reshape(-1, 3)[old_m].double())
        c.vcnt.index_add_(0, old_slot, torch.full_like(old_slot, -1, dtype=torch.int32))

        # insert the NEW corners: the valid lanes (in lane order) probe the
        # persistent table
        corners = tri.reshape(-1, 3)
        v3 = sel.reshape(-1).repeat_interleave(3)
        lanes = torch.nonzero(v3)[:, 0]
        quant = vol.voxel_size / 256.0
        q = _marching._quantize(corners[lanes], v3[lanes], quant, vol.origin)
        used, key, slot_c, unres_c = self._probe(q, c.used, c.key)
        slot_of = torch.zeros(v3.shape[0], dtype=torch.int64, device=dev)
        slot_of[lanes] = slot_c
        unresolved = torch.zeros_like(v3)
        unresolved[lanes] = unres_c

        # triangle-atomic: keep a triangle only if all three corners landed
        # slots, so a later removal stays symmetric
        tri_ok = sel & ~unresolved.reshape(K, cap, 3).any(2)
        add = torch.nonzero(tri_ok.reshape(-1).repeat_interleave(3))[:, 0]
        c.vsum.index_add_(0, slot_of[add], corners[add].double())
        c.vcnt.index_add_(0, slot_of[add], torch.ones_like(add, dtype=torch.int32))
        color_fn = _marching.sample_volume_colors(vol)
        if color_fn is not None and add.numel():
            # a slot's color is its last inserting corner's (lane order)
            last = torch.full((1 << self.table_bits,), -1, dtype=torch.int64, device=dev)
            last.scatter_reduce_(0, slot_of[add], add, "amax")
            won = torch.nonzero(last >= 0)[:, 0]
            c.ccol[won] = color_fn(corners[last[won]])
        c.tri.index_copy_(0, ci, tri)
        c.val.index_copy_(0, ci, tri_ok)
        c.fslot.index_copy_(0, ci, slot_of.reshape(K, cap, 3))
        c.dirty.index_fill_(0, ci, False)
        c.nunres.add_(unresolved.sum(dtype=torch.int32))
        # triangles past the per-slab cap are LOST for this refresh; record
        # them so dropped_triangles surfaces the truncation
        c.ndrop.index_copy_(0, ci, torch.tensor(drops, dtype=torch.int32, device=dev))
        self.cache = c._replace(key=key, used=used)

    @property
    def unresolved_corners(self) -> int:
        """Corners that found no weld slot since the last table reset (their
        triangles were dropped). Reads one scalar from the device."""
        return int(self.cache.nunres)

    @property
    def dropped_triangles(self) -> int:
        """Triangles the CURRENT cached mesh is missing because dense slabs
        exceeded the per-slab cap. Nonzero means the live mesh has holes:
        construct the mesher with a larger max_triangles. Reads the device."""
        return int(self.cache.ndrop.sum())

    def _run_update(self, vol: TSDFVolume) -> None:
        """Refresh all currently-dirty slabs in chunks of batch_k (one host
        read of the dirty mask picks them)."""
        dirty = torch.nonzero(self.cache.dirty)[:, 0].tolist()
        for pos in range(0, len(dirty), self.batch_k):
            self._refresh(vol, dirty[pos:pos + self.batch_k])

    def update(self, vol: TSDFVolume) -> "IncrementalMesher":
        """Refresh the dirty slabs; clean slabs cost nothing. Every
        `health_check_every` refreshes the unresolved-corner counter is
        read; nonzero means probe chains hit tombstone saturation, so the
        weld table is rebuilt from scratch (one full re-mesh) instead of
        silently dropping triangles."""
        self._run_update(vol)
        self._updates_since_check += 1
        if self._updates_since_check >= self.health_check_every:
            self._updates_since_check = 0
            if self.unresolved_corners > 0:
                _log.warning("incremental mesher: %d corners unresolved (weld table "
                             "saturated by tombstones): rebuilding the table",
                             self.unresolved_corners)
                self.mark_all_dirty()
                self._run_update(vol)
            ndrop = self.dropped_triangles
            if ndrop > 0 and not self._warned_dropped:
                self._warned_dropped = True
                _log.warning("incremental mesher: %d triangles exceed the per-slab cache "
                             "quota (%d) and are missing from the live mesh: raise "
                             "max_triangles", ndrop, self.cap)
        return self

    # ---- weld ---------------------------------------------------------
    def mesh_device(self, vol: TSDFVolume) -> TriangleMesh:
        """Refresh + incremental weld, on the device: a fixed-capacity mesh
        with validity masks (the table's slots are its vertices, the cache
        rows its faces)."""
        self.update(vol)
        c = self.cache
        vvalid = c.vcnt > 0
        verts = (c.vsum / torch.clamp(c.vcnt, min=1)[:, None]).to(torch.float32)
        faces = c.fslot.reshape(-1, 3).to(torch.int32)
        nondeg = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & \
            (faces[:, 0] != faces[:, 2])
        colors = None if vol.color is None else torch.where(vvalid[:, None], c.ccol, 0.0)
        return TriangleMesh(vertices=torch.where(vvalid[:, None], verts, 0.0), triangles=faces,
                            vertex_valid=vvalid, triangle_valid=c.val.reshape(-1) & nondeg,
                            vertex_colors=colors)

    def mesh(self, vol: TSDFVolume) -> TriangleMesh:
        """Refresh + weld + compaction: extract_triangle_mesh's contract
        (mini1.py:357-360), for save / export paths."""
        md = self.mesh_device(vol)
        vv, tv = md.vertex_valid, md.triangle_valid
        dev = vv.device
        n = int(vv.sum())
        if n == 0:
            return TriangleMesh(vertices=torch.zeros((1, 3), dtype=torch.float32, device=dev),
                                triangles=torch.zeros((1, 3), dtype=torch.int32, device=dev),
                                vertex_valid=torch.zeros((1,), dtype=torch.bool, device=dev),
                                triangle_valid=torch.zeros((1,), dtype=torch.bool, device=dev))
        remap = torch.full((vv.shape[0],), -1, dtype=torch.int32, device=dev)
        remap[vv] = torch.arange(n, dtype=torch.int32, device=dev)
        faces = remap[md.triangles[tv].long()]
        colors = None if md.vertex_colors is None else md.vertex_colors[vv]
        return TriangleMesh(vertices=md.vertices[vv], triangles=faces,
                            vertex_valid=torch.ones((n,), dtype=torch.bool, device=dev),
                            triangle_valid=torch.ones((faces.shape[0],), dtype=torch.bool,
                                                      device=dev),
                            vertex_colors=colors)


def weld_mesh_device(soup: torch.Tensor, tri_valid: torch.Tensor, voxel_size: float,
                     color_fn=None, table_bits: int = 22) -> TriangleMesh:
    """Triangle soup -> fixed-capacity TriangleMesh on the soup's device.

    weld_mesh's twin without the compaction: vertices stay at soup capacity
    with a validity mask, faces index welded group ids directly."""
    verts = soup.reshape(-1, 3)
    vvalid = tri_valid.repeat_interleave(3)
    quant = torch.full((), voxel_size / 256.0, dtype=torch.float32, device=soup.device)
    vert_sum, vert_count, inv, n_unique = _marching._weld_device_hash(
        verts, vvalid, quant, table_bits=table_bits)
    n = verts.shape[0]
    vertices = vert_sum / torch.clamp(vert_count, min=1)[:, None].to(torch.float32)
    vertex_valid = torch.arange(n, device=soup.device) < n_unique
    faces = inv.reshape(-1, 3)
    nondeg = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & \
        (faces[:, 0] != faces[:, 2])
    colors = None if color_fn is None else torch.where(vertex_valid[:, None],
                                                       color_fn(vertices), 0.0)
    return TriangleMesh(vertices=vertices, triangles=faces, vertex_valid=vertex_valid,
                        triangle_valid=tri_valid & nondeg, vertex_colors=colors)
