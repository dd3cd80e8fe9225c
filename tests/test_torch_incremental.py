"""Port parity for fusion/incremental.py against the JAX package's
IncrementalMesher on the CPU: 4 SyntheticRGBDCamera frames (160x120, fx =
fy = 130, step 0.015) at their true poses into a 96^3 volume (voxel 0.015,
sdf_trunc 0.06), with and without color. Bars and what was measured:
  integrate: the volume bitwise JAX's (measured equal) and the dirty-slab
  mask exact (measured equal), dirty_hits exact on seeded profiles;
  after each update, against the port's full extract_triangle_mesh (the
  same _slab_tris rows): equal vertex and face counts, the face set equal
  through the vertex pairing below, vertices atol 1e-6 (measured 4.2e-7:
  the port's float64 corner sums against the extract's float32 ones), and
  at most 0.2 % of the vertices with a weld key one off their partner's
  (a mean an ulp away straddling a key boundary; the 0.2 % of JAX's own
  cross-implementation bar, tests/test_incremental.py:36-53; measured 0-4
  of ~8,400); against JAX's IncrementalMesher: the same bars (measured
  4.2e-7, 4-9 keys one off);
  dropped_triangles and unresolved_corners equal (measured 0 and 0, and
  nonzero drops at a tight budget).
Each vertex is paired with the vertex of the other mesh nearest it among
those with its weld key round(v / quant) or a neighbouring one, one to one;
the faces, relabeled through the pairing, must be the same set.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import SyntheticRGBDCamera
from recon3d_tpu.fusion import incremental as jinc
from recon3d_tpu.fusion import tsdf as jtsdf
from recon3d_tpu.utils.types import CameraIntrinsics as JIntrinsics
from recon3d_tpu_torch.fusion import incremental as inc
from recon3d_tpu_torch.fusion import marching, tsdf
from recon3d_tpu_torch.utils.types import CameraIntrinsics

R, VOXEL, TRUNC, ORIGIN = 96, 0.015, 0.06, (-0.72, -0.72, 0.3)
QUANT = float(np.float32(VOXEL)) / 256.0


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def frames():
    cam = SyntheticRGBDCamera(width=160, height=120, fx=130.0, fy=130.0, n_frames=4, step=0.015)
    cam.open()
    return [(*cam.grab(), np.linalg.inv(cam.true_pose(k)).astype(np.float32))
            for k in range(4)]


def _intr():
    return (JIntrinsics(fx=jnp.float32(130.0), fy=jnp.float32(130.0), cx=jnp.float32(79.5),
                        cy=jnp.float32(59.5)), CameraIntrinsics(130.0, 130.0, 79.5, 59.5))


def _match_meshes(got, ref, atol=1e-6):
    """Pair every vertex of `got` with the vertex of `ref` whose weld key
    round(v / quant) is its own or a neighbour's and which lies nearest; the
    pairing must be one to one within `atol`. Returns (vertex max abs, faces
    of `got` relabeled to `ref`'s vertices and canonicalized, `ref`'s
    canonical faces, weld keys that differ). A key straddles a rounding
    boundary where the two means differ by an ulp, so keys alone cannot
    order both meshes alike."""
    vg, tg, _, _ = got.to_numpy()
    vr, tr, _, _ = ref.to_numpy()
    assert len(vg) == len(vr) > 0 and len(tg) == len(tr)
    kg = np.round(np.asarray(vg, np.float64) / QUANT).astype(np.int64)
    kr = np.round(np.asarray(vr, np.float64) / QUANT).astype(np.int64)

    def code(k):
        return ((k[:, 0] + (1 << 20)) << 42) | ((k[:, 1] + (1 << 20)) << 21) | (k[:, 2] + (1 << 20))

    cr = code(kr)
    order = np.argsort(cr)
    best, dist = np.full(len(vg), -1), np.full(len(vg), np.inf)
    for off in np.stack(np.meshgrid(*[[-1, 0, 1]] * 3, indexing="ij"), -1).reshape(-1, 3):
        c = code(kg + off)
        pos = np.clip(np.searchsorted(cr, c, sorter=order), 0, len(cr) - 1)
        hit = order[pos]
        dd = np.where(cr[hit] == c, np.abs(vg - vr[hit]).max(1), np.inf)
        closer = dd < dist
        best[closer], dist[closer] = hit[closer], dd[closer]
    assert (best >= 0).all() and len(np.unique(best)) == len(best)

    def canon(t):
        f = np.sort(t, axis=1)
        return f[np.lexsort(f.T[::-1])]

    return float(dist.max()), canon(best[tg]), canon(tr), int((kg != kr[best]).any(1).sum())


def _vertices(mesh):
    return int(mesh.vertex_valid.sum())


def _same_sets(got, ref, what):
    vmax, fg, fr, straddle = _match_meshes(got, ref)
    assert vmax <= 1e-6, (what, vmax)
    np.testing.assert_array_equal(fg, fr, err_msg=what)
    assert straddle <= max(2, 0.002 * 2 * _vertices(got)), (what, straddle)


@pytest.mark.parametrize("with_color", [False, True])
def test_incremental_mesher_matches_jax_and_the_full_extract(frames, with_color):
    ji, pi = _intr()
    jvol = jtsdf.make_volume(resolution=R, voxel_size=VOXEL, sdf_trunc=TRUNC, origin=ORIGIN,
                             with_color=with_color)
    pvol = tsdf.make_volume(R, VOXEL, TRUNC, origin=ORIGIN, with_color=with_color,
                            device="cpu")
    jm = jinc.IncrementalMesher(resolution=R)
    pm = inc.IncrementalMesher(resolution=R, device="cpu")
    assert (pm.cap, pm.n_slabs, pm.table_bits) == (jm.cap, jm.n_slabs, jm.table_bits)
    for k, (c, d, pose) in enumerate(frames):
        jc = jnp.asarray(c) if with_color else None
        pc = torch.tensor(c) if with_color else None
        jvol = jm.integrate(jvol, jnp.asarray(d), ji, jnp.asarray(pose), jc)
        pvol = pm.integrate(pvol, torch.tensor(d), pi, torch.tensor(pose), pc)
        np.testing.assert_array_equal(pvol.tsdf.numpy(), np.asarray(jvol.tsdf))
        np.testing.assert_array_equal(pm.cache.dirty.numpy(), np.asarray(jm.cache.dirty))
        live = pm.mesh(pvol)
        _same_sets(live, marching.extract_triangle_mesh(pvol), f"frame {k}: vs the full extract")
        _same_sets(live, jm.mesh(jvol), f"frame {k}: vs JAX's mesher")
        assert not bool(pm.cache.dirty.any())
        assert pm.dropped_triangles == jm.dropped_triangles == 0
        assert pm.unresolved_corners == jm.unresolved_corners == 0
        if with_color:
            assert live.vertex_colors.shape == live.vertices.shape
            assert bool(((live.vertex_colors >= 0) & (live.vertex_colors <= 1)).all())


def test_dirty_hits_match_jax():
    jm = jinc.IncrementalMesher(resolution=R)
    pm = inc.IncrementalMesher(resolution=R, device="cpu")
    rng = np.random.RandomState(3)
    for p in (0.0, 0.01, 0.05, 0.5):
        changed = rng.rand(R) < p
        np.testing.assert_array_equal(pm.dirty_hits(torch.tensor(changed)).numpy(),
                                      np.asarray(jm.dirty_hits(jnp.asarray(changed))))


def test_dropped_triangles_at_a_tight_budget_match_jax(frames):
    """A budget far below the surface: every dense slab is cut at its cap,
    and both meshers count the same drops."""
    ji, pi = _intr()
    c, d, pose = frames[0]
    jvol = jtsdf.make_volume(resolution=R, voxel_size=VOXEL, sdf_trunc=TRUNC, origin=ORIGIN,
                             with_color=False)
    pvol = tsdf.make_volume(R, VOXEL, TRUNC, origin=ORIGIN, with_color=False, device="cpu")
    jm = jinc.IncrementalMesher(resolution=R, max_triangles=1 << 11)
    pm = inc.IncrementalMesher(resolution=R, max_triangles=1 << 11, device="cpu")
    jm.update(jm.integrate(jvol, jnp.asarray(d), ji, jnp.asarray(pose)))
    pm.update(pm.integrate(pvol, torch.tensor(d), pi, torch.tensor(pose)))
    assert pm.dropped_triangles == jm.dropped_triangles > 0
    np.testing.assert_array_equal(pm.cache.ndrop.numpy(), np.asarray(jm.cache.ndrop))


def test_mesh_device_and_rebuild_after_mark_all_dirty(frames):
    """The device mesh carries the compacted mesh's geometry; a table
    rebuild (mark_all_dirty) gives the same sets as the incremental one."""
    _, pi = _intr()
    pvol = tsdf.make_volume(R, VOXEL, TRUNC, origin=ORIGIN, with_color=True, device="cpu")
    pm = inc.IncrementalMesher(resolution=R, device="cpu")
    for c, d, pose in frames[:2]:
        pvol = pm.integrate(pvol, torch.tensor(d), pi, torch.tensor(pose), torch.tensor(c))
        pm.update(pvol)
    md = pm.mesh_device(pvol)
    assert md.vertices.shape[0] == 1 << pm.table_bits
    _same_sets(md, pm.mesh(pvol), "mesh_device vs mesh")
    before = pm.mesh(pvol)
    pm.mark_all_dirty()
    assert bool(pm.cache.dirty.all()) and int(pm.cache.vcnt.sum()) == 0
    _same_sets(pm.mesh(pvol), before, "rebuilt table")


def test_weld_mesh_device_matches_jax():
    rng = np.random.RandomState(5)
    base = rng.rand(300, 3).astype(np.float32)
    soup = base[rng.randint(0, 300, size=(400, 3))]  # shared corners weld
    valid = rng.rand(400) < 0.8
    jm = jinc.weld_mesh_device(jnp.asarray(soup), jnp.asarray(valid), 0.01, table_bits=14)
    pm = inc.weld_mesh_device(torch.tensor(soup), torch.tensor(valid), 0.01, table_bits=14)
    assert int(pm.vertex_valid.sum()) == int(np.asarray(jm.vertex_valid).sum())
    vj, tj, _, _ = jm.to_numpy()
    vp, tp, _, _ = pm.to_numpy()
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_array_equal(tp, tj)
