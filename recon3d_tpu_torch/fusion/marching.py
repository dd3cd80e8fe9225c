"""Isosurface mesh extraction from the TSDF grid by marching tetrahedra
(twin of recon3d_tpu/fusion/marching.py).

Each cube splits into 6 tetrahedra sharing the main diagonal 0-7; a tet
yields 0, 1 or 2 triangles, computed rather than looked up. As in the JAX
package every (cube, tet) slot owns 2 candidate triangles with a validity
bit; the grid is walked in z-slabs, each slab's valid candidates are
compacted in (x, y, z, tet, a/b) order into at most `cap_per_slab` rows and
only those get their geometry; the soup is then oriented by the TSDF
gradient and welded into an indexed mesh.

Differences from the JAX program, none of which changes a result:
- A slab's candidates are compacted with `nonzero` over the row-major
  validity bits (the order the JAX package's per-row stable argsort, cumsum
  and searchsorted give the first `total` rows), so the geometry runs for
  the `n` emitted rows only.
- Soup rows are written only below the buffer's end. Where the buffer
  overflows the JAX scatter collapses the excess onto its last row; the
  port keeps that row's own triangle. Both count the excess in `dropped`.
- The welds' float sums run as segmented sums over the rows grouped by
  vertex, in index order within a group, as XLA's CPU scatter-add adds
  them; on the card they do not depend on the order of atomics.

Floating-point operations are rounded as XLA rounds the jitted functions
on the CPU (corner positions, edge interpolation, the orientation's
centroid, cross and dot products: noted where they are computed), so the
CPU port is bitwise the JAX package and the card bitwise the CPU port.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from recon3d_tpu_torch.fusion.tsdf import TSDFVolume
from recon3d_tpu_torch.ops.image import fma
from recon3d_tpu_torch.utils.types import TriangleMesh

# 6-tetrahedra decomposition of the unit cube (corner c = (x + (c & 1),
# y + ((c >> 1) & 1), z + ((c >> 2) & 1))), all sharing the diagonal 0-7
_TETS = (
    (0, 5, 1, 7),
    (0, 1, 3, 7),
    (0, 3, 2, 7),
    (0, 2, 6, 7),
    (0, 6, 4, 7),
    (0, 4, 5, 7),
)
_CORNER_OFFSETS = np.array(
    [[(c & 1), ((c >> 1) & 1), ((c >> 2) & 1)] for c in range(8)], np.float32)
_TETS_ARR = np.array(_TETS, np.int64)  # (6, 4) corner ids per tet


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 saturating at the int32 range, as XLA converts."""
    return x.double().clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def _tet_triangles(p: torch.Tensor, v: torch.Tensor, ok: torch.Tensor):
    """Triangles of one tet across a batch.

    p (..., 4, 3) corner positions, v (..., 4) tsdf values, ok (...,) mask.
    Returns (tri_a, tri_b) (..., 3, 3) and their validity (..., ); by the
    count of inside (v < 0) corners: 1 or 3 -> one triangle, 2 -> a quad as
    two triangles.
    """
    inside = v < 0.0
    n_in = inside.to(torch.int32).sum(-1)

    def interp(a_idx, b_idx, fused=True):
        va = torch.gather(v, -1, a_idx[..., None])[..., 0]
        vb = torch.gather(v, -1, b_idx[..., None])[..., 0]
        pa = torch.gather(p, -2, a_idx[..., None, None].expand(*a_idx.shape, 1, 3))[..., 0, :]
        pb = torch.gather(p, -2, b_idx[..., None, None].expand(*b_idx.shape, 1, 3))[..., 0, :]
        d = va - vb
        t = torch.clamp(va / torch.where(d.abs() < 1e-12, 1e-12, d), 0.0, 1.0)[..., None]
        # pa + t * (pb - pa)
        return fma(t.expand_as(pa), pb - pa, pa) if fused else pa + t * (pb - pa)

    # corners ordered insides first (stable by index), outsides after
    rank = torch.sort(torch.where(inside, 0, 1).to(torch.uint8), dim=-1, stable=True).indices
    r = [rank[..., i] for i in range(4)]
    # XLA's CPU code rounds the interpolation of the first vertex of tri1,
    # tri3 and tri2a twice and contracts every other into a fused multiply-add
    tri1 = torch.stack([interp(r[0], r[1], False), interp(r[0], r[2]), interp(r[0], r[3])], -2)
    tri3 = torch.stack([interp(r[0], r[3], False), interp(r[1], r[3]), interp(r[2], r[3])], -2)
    q01, q10, q11 = interp(r[0], r[3]), interp(r[1], r[2]), interp(r[1], r[3])
    tri2a = torch.stack([interp(r[0], r[2], False), q01, q10], -2)
    tri2b = torch.stack([q10, q01, q11], -2)
    tri_a = torch.where((n_in == 2)[..., None, None], tri2a,
                        torch.where((n_in == 3)[..., None, None], tri3, tri1))
    valid_a = ok & (n_in >= 1) & (n_in <= 3)
    valid_b = ok & (n_in == 2)
    return tri_a, tri2b, valid_a, valid_b


def _tet_validity(vals: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Candidate validity bits without geometry: vals (..., 8) cube corner
    values, ok (...,) -> (..., 12) bools [tet0_a, tet0_b, tet1_a, ...]."""
    inside = (vals < 0.0).to(torch.int32)
    out = []
    for tet in _TETS:
        n_in = sum(inside[..., c] for c in tet)
        out += [ok & (n_in >= 1) & (n_in <= 3), ok & (n_in == 2)]
    return torch.stack(out, -1)


def _tet_validity_z(vals_z, ok: torch.Tensor) -> torch.Tensor:
    """_tet_validity on 8 separate (Z, X, Y) corner slices -> (Z, 12, X, Y)."""
    inside = [(v < 0.0).to(torch.int32) for v in vals_z]
    out = []
    for tet in _TETS:
        n_in = sum(inside[c] for c in tet)
        out += [ok & (n_in >= 1) & (n_in <= 3), ok & (n_in == 2)]
    return torch.stack(out, 1)


def _slab_tris(vol: TSDFVolume, z0: int, z_lo: int, slab: int, cap_per_slab: int,
               weight_min: float):
    """Triangles of the cubes whose corner z lies in [z0, z0 + slab) and is
    >= z_lo, compacted to a (cap_per_slab, 3, 3) buffer; returns (tri, sel,
    n, total): rows r < n are the emitted triangles (`sel`), the rest hold
    zeros, and total > n counts the candidates the cap cut."""
    t, w, R = vol.tsdf, vol.weight, vol.resolution
    dev = t.device
    X = Y = R - 1
    Z = slab
    K = Z * 12
    twz = t.permute(2, 0, 1)[z0:z0 + slab + 1]
    wwz = w.permute(2, 0, 1)[z0:z0 + slab + 1]

    def corner(a, c):
        cz, cx, cy = (c >> 2) & 1, c & 1, (c >> 1) & 1
        return a[cz:cz + Z, cx:cx + X, cy:cy + Y]

    vals_z = [corner(twz, c) for c in range(8)]
    wok = corner(wwz, 0) >= weight_min
    for c in range(1, 8):
        wok = wok & (corner(wwz, c) >= weight_min)
    zidx = z0 + torch.arange(Z, device=dev)
    ok = wok & (zidx >= z_lo)[:, None, None]

    # compaction on the validity bits: candidate (g = x * Y + y, k = z * 12 + j)
    val = _tet_validity_z(vals_z, ok).permute(2, 3, 0, 1).reshape(X * Y * K)
    flat = torch.nonzero(val)[:, 0]
    total = int(flat.shape[0])
    n = min(total, cap_per_slab)
    flat = flat[:n]
    g, k = flat // K, flat % K

    x, y = g // Y, g % Y
    z_rel = k // 12
    tet_i = (k % 12) // 2
    ab = k % 2
    cids = torch.as_tensor(_TETS_ARR, device=dev)[tet_i]  # (n, 4)
    v8 = torch.stack([vz[z_rel, x, y] for vz in vals_z], -1)  # (n, 8)
    vv = torch.gather(v8, 1, cids)
    base = torch.stack([x, y, z0 + z_rel], -1).to(torch.float32)
    corners = base[:, None, :] + torch.as_tensor(_CORNER_OFFSETS, device=dev)[cids]
    # (base + offset) * voxel_size + origin: XLA's CPU code contracts x and y
    # into fused multiply-adds and rounds z twice
    pp = fma(corners, vol.voxel_size.expand_as(corners), vol.origin.expand_as(corners))
    pp[..., 2] = corners[..., 2] * vol.voxel_size + vol.origin[2]
    sel_n = torch.ones(n, dtype=torch.bool, device=dev)
    ta, tb, _, _ = _tet_triangles(pp, vv, sel_n)
    tri = torch.zeros((cap_per_slab, 3, 3), dtype=torch.float32, device=dev)
    tri[:n] = torch.where((ab == 1)[:, None, None], tb, ta)
    sel = torch.arange(cap_per_slab, device=dev) < n
    return tri, sel, n, total


def default_max_triangles(resolution: int) -> int:
    """Resolution-scaled triangle budget (R^3 / 4, within [2^14, 2^19])."""
    return max(1 << 14, min(1 << 19, resolution ** 3 // 4))


def slab_cap(resolution: int, slab: int, max_triangles: int, mult: int = 4) -> int:
    """Per-slab triangle cap: `mult` x the uniform quota, bounded by the
    global buffer and the cube-count ceiling."""
    R = resolution
    n_slabs = (R - 1) // slab + (1 if (R - 1) % slab else 0)
    quota = max_triangles // n_slabs + 1
    return min(mult * quota, max_triangles, (R - 1) * (R - 1) * slab * 12)


def extract_triangle_soup(vol: TSDFVolume, max_triangles: int = 1 << 19,
                          weight_min: float = 1.0, slab: int = 8, with_dropped: bool = False,
                          cap_mult: int = 4):
    """TSDF -> triangle soup: (max_triangles, 3, 3) positions, (max_triangles,)
    validity, the count of valid rows and, with `with_dropped`, the number of
    triangles the per-slab caps and the buffer cut (0-d int32 tensors)."""
    R = vol.resolution
    dev = vol.tsdf.device
    n_slabs = (R - 1) // slab + (1 if (R - 1) % slab else 0)
    cap_per_slab = slab_cap(R, slab, max_triangles, mult=cap_mult)
    out_tri = torch.zeros((max_triangles, 3, 3), dtype=torch.float32, device=dev)
    out_val = torch.zeros((max_triangles,), dtype=torch.bool, device=dev)
    cursor = dropped = 0
    for i in range(n_slabs):
        z0 = min(i * slab, R - 1 - slab)
        tri, _, n, total = _slab_tris(vol, z0, i * slab, slab, cap_per_slab, weight_min)
        m = max(0, min(n, max_triangles - cursor))
        out_tri[cursor:cursor + m] = tri[:m]
        out_val[cursor:cursor + m] = True
        cursor += n
        dropped += total - n
    dropped += max(cursor - max_triangles, 0)
    count = torch.tensor(min(cursor, max_triangles), dtype=torch.int32, device=dev)
    if with_dropped:
        return out_tri, out_val, count, torch.tensor(dropped, dtype=torch.int32, device=dev)
    return out_tri, out_val, count


def _group_sums(verts: torch.Tensor, vvalid: torch.Tensor, inv: torch.Tensor, n: int):
    """(vert_sum (n, 3), vert_count (n,)) of the valid vertices by group id:
    a segmented sum over the rows stably sorted by group, so each group adds
    its rows in index order (XLA's CPU scatter-add order), on any device."""
    tgt = torch.where(vvalid, inv.to(torch.int64), n)
    order = torch.sort(tgt, stable=True).indices
    lengths = torch.bincount(tgt, minlength=n + 1)
    rows = torch.where(vvalid[:, None], verts, 0.0)[order]
    vert_sum = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0, unsafe=True)[:n]
    return vert_sum, lengths[:n].to(torch.int32)


def _quantize(verts: torch.Tensor, vvalid: torch.Tensor, quant: torch.Tensor, ref):
    if ref is None:
        ref = torch.where(vvalid[:, None], verts, torch.tensor(3.4e38, device=verts.device))
        ref = ref.amin(0) if verts.shape[0] else verts.new_zeros(3)
        ref = torch.where(vvalid.any(), ref, 0.0)
    ref = torch.as_tensor(ref, dtype=torch.float32, device=verts.device)
    return _to_int32(torch.round((verts - ref) / quant))


def _weld_device(verts: torch.Tensor, vvalid: torch.Tensor, quant: torch.Tensor, ref=None):
    """Group identical quantized vertices by a stable lexicographic sort.

    Returns (vert_sum (N, 3), vert_count (N,), inv (N,) group id of each
    vertex, n_unique); groups are keyed by round((verts - ref) / quant), ref
    defaulting to the minimum valid vertex; invalid vertices form a trailing
    group excluded from the sums."""
    q = _quantize(verts, vvalid, quant, ref)
    q = torch.where(vvalid[:, None], q, torch.iinfo(torch.int32).max)
    perm = torch.sort(q[:, 2], stable=True).indices
    for col in (1, 0):
        perm = perm[torch.sort(q[perm, col], stable=True).indices]
    qs = q[perm]
    first = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    first[1:] = (qs[1:] != qs[:-1]).any(1)
    gid = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    inv = torch.empty_like(gid)
    inv[perm] = gid
    n = verts.shape[0]
    vert_sum, vert_count = _group_sums(verts, vvalid, inv, n)
    n_unique = torch.where(vvalid, inv + 1, 0).max() if n else inv.new_zeros(())
    return vert_sum, vert_count, inv, n_unique


_HASH_PRIMES = (73856093, 19349663, 83492791)


def _weld_device_hash(verts: torch.Tensor, vvalid: torch.Tensor, quant: torch.Tensor,
                      table_bits: int = 22, probes: int = 16, ref=None):
    """Sort-free weld over an open-addressing hash table of the quantized
    coordinates; same contract as _weld_device, group ids by slot rank.

    Each round scatter-mins the unresolved vertices' indices into their
    current slots, claims empty slots, and resolves every vertex whose slot
    owner has its key; the others probe on quadratically. The rounds stop
    when all are resolved (one host check a round) or after `probes`;
    leftovers become singleton groups."""
    N = verts.shape[0]
    S = 1 << table_bits
    dev = verts.device
    q = _quantize(verts, vvalid, quant, ref)
    q = torch.where(vvalid[:, None], q, -1)
    # the int32 hash of the JAX package wraps; its low table_bits bits are
    # those of the same products and xors in int64
    ql = q.to(torch.int64)
    h = ((ql[:, 0] * _HASH_PRIMES[0]) ^ (ql[:, 1] * _HASH_PRIMES[1])
         ^ (ql[:, 2] * _HASH_PRIMES[2])) & (S - 1)

    idx = torch.arange(N, dtype=torch.int64, device=dev)
    owner = torch.full((S,), N, dtype=torch.int64, device=dev)
    slot_of = torch.zeros(N, dtype=torch.int64, device=dev)
    unresolved = vvalid.clone()
    cur = h
    for p in range(probes):
        if not bool(unresolved.any()):
            break
        claim = torch.full((S,), N, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, cur[unresolved], idx[unresolved], "amin")
        owner = torch.where(owner == N, claim, owner)
        own_i = owner[cur]
        own_q = q[torch.clamp(own_i, max=N - 1)]
        match = unresolved & (own_i < N) & (own_q == q).all(1)
        slot_of = torch.where(match, cur, slot_of)
        unresolved = unresolved & ~match
        cur = (cur + 2 * p + 1) & (S - 1)

    occupied = owner < N
    rank = torch.cumsum(occupied.to(torch.int64), 0) - 1
    n_slots = occupied.sum()
    resolved = vvalid & ~unresolved
    extra = torch.cumsum(unresolved.to(torch.int64), 0) - 1
    inv = torch.where(resolved, rank[slot_of],
                      torch.where(unresolved, n_slots + extra, 0)).to(torch.int32)
    n_unique = (n_slots + unresolved.sum()).to(torch.int32)
    vert_sum, vert_count = _group_sums(verts, vvalid, inv, N)
    return vert_sum, vert_count, inv, n_unique


def weld_mesh(tri_soup: torch.Tensor, tri_valid: torch.Tensor, voxel_size: float,
              color_fn=None, method: str = "hash", ref=None) -> TriangleMesh:
    """Triangle soup -> indexed TriangleMesh: vertices quantized to
    voxel_size / 256 and merged (each merged vertex the mean of its copies,
    divided in float64), faces with repeated vertices dropped. method
    "hash" (default) or "sort" picks the weld."""
    dev = tri_soup.device
    weld = _weld_device_hash if method == "hash" else _weld_device
    quant = torch.tensor(voxel_size / 256.0, dtype=torch.float32, device=dev)
    vert_sum, vert_count, inv, n_unique = weld(
        tri_soup.reshape(-1, 3), tri_valid.repeat_interleave(3), quant, ref=ref)
    n_u = int(n_unique)
    if n_u == 0:
        return TriangleMesh(vertices=torch.zeros((1, 3), dtype=torch.float32, device=dev),
                            triangles=torch.zeros((1, 3), dtype=torch.int32, device=dev),
                            vertex_valid=torch.zeros((1,), dtype=torch.bool, device=dev),
                            triangle_valid=torch.zeros((1,), dtype=torch.bool, device=dev))
    out_verts = (vert_sum[:n_u].double()
                 / torch.clamp(vert_count[:n_u], min=1).double()[:, None]).to(torch.float32)
    faces = inv.reshape(-1, 3)[tri_valid]
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & \
        (faces[:, 0] != faces[:, 2])
    faces = faces[good]
    colors = None if color_fn is None else color_fn(out_verts)
    return TriangleMesh(vertices=out_verts, triangles=faces,
                        vertex_valid=torch.ones((n_u,), dtype=torch.bool, device=dev),
                        triangle_valid=torch.ones((faces.shape[0],), dtype=torch.bool,
                                                  device=dev),
                        vertex_colors=colors)


def sample_volume_colors(vol: TSDFVolume):
    """color_fn(verts) -> (N, 3) trilinear sampler over the color grid, or
    None without color. (The JAX package runs it op by op, outside jit, so
    each operation rounds on its own.)"""
    if vol.color is None:
        return None

    def color_fn(verts):
        verts = torch.as_tensor(verts, dtype=torch.float32, device=vol.color.device)
        g = (verts - vol.origin) / vol.voxel_size
        R = vol.resolution
        g0 = torch.floor(g).to(torch.int32)
        f = g - g0
        acc = None
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    wgt = ((f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
                           * (f[:, 2] if dz else 1 - f[:, 2]))
                    idx = torch.clamp(g0 + torch.tensor([dx, dy, dz], dtype=torch.int32,
                                                        device=g0.device), 0, R - 1).long()
                    term = wgt[:, None] * vol.color[idx[:, 0], idx[:, 1], idx[:, 2]]
                    acc = term if acc is None else acc + term
        return torch.clamp(acc, 0.0, 1.0)

    return color_fn


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross of (..., 3) rows as XLA's CPU code rounds it:
    a1 b2 - a2 b1 as fma(a1, b2, -(a2 b1)), and so on."""
    def c(i, j):
        return fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))

    return torch.stack([c(1, 2), c(2, 0), c(0, 1)], -1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) of (..., 3) rows as the fused multiply-add chain XLA
    makes of it."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _orient_by_gradient(vol: TSDFVolume, soup: torch.Tensor) -> torch.Tensor:
    """Flip triangles whose normal opposes the local TSDF gradient, so the
    winding is outward (inside (-) -> outside (+)) everywhere."""
    # jnp.mean: the sum times the float32 reciprocal of 3
    third = 1.0 / torch.tensor(3.0, dtype=torch.float32, device=soup.device)
    centroid = ((soup[:, 0] + soup[:, 1]) + soup[:, 2]) * third
    g = (centroid - vol.origin) / vol.voxel_size
    gi = torch.clamp(_to_int32(torch.round(g)), 1, vol.resolution - 2).long()
    x, y, z = gi[:, 0], gi[:, 1], gi[:, 2]
    t = vol.tsdf
    grad = torch.stack([t[x + 1, y, z] - t[x - 1, y, z], t[x, y + 1, z] - t[x, y - 1, z],
                        t[x, y, z + 1] - t[x, y, z - 1]], -1)
    n = _cross(soup[:, 1] - soup[:, 0], soup[:, 2] - soup[:, 0])
    flip = _dot3(n, grad) < 0
    return torch.where(flip[:, None, None], soup[:, [0, 2, 1]], soup)


def extract_triangle_mesh(vol: TSDFVolume, max_triangles: Optional[int] = None,
                          weight_min: float = 1.0) -> TriangleMesh:
    """ScalableTSDFVolume.extract_triangle_mesh equivalent: the soup at the
    1x per-slab cap, re-run at 4x only when triangles were dropped, oriented
    by the gradient and welded (hash) with origin-anchored quantization."""
    if max_triangles is None:
        max_triangles = default_max_triangles(vol.resolution)
    soup, valid, _, dropped = extract_triangle_soup(vol, max_triangles=max_triangles,
                                                    weight_min=weight_min, with_dropped=True,
                                                    cap_mult=1)
    if int(dropped) > 0:
        soup, valid, _ = extract_triangle_soup(vol, max_triangles=max_triangles,
                                               weight_min=weight_min, cap_mult=4)
    soup = _orient_by_gradient(vol, soup)
    return weld_mesh(soup, valid, float(vol.voxel_size), color_fn=sample_volume_colors(vol),
                     ref=vol.origin)
