"""Port parity for marching tetrahedra, the welds, mesh/ops.py and the PLY
codec: recon3d_tpu_torch's plain versions (CPU tensors) against the jitted
JAX functions on the CPU, on one fused volume carried across with
convert.tsdf_volume.

The volume: R = 64 (voxel 0.016, sdf_trunc 0.05, origin (-0.512, -0.512,
0.902)) after three SyntheticRGBDCamera(160, 120, fx = fy = 130) frames at
their true poses, with color. Bars: the soup, its validity, count and
`dropped` bitwise at a budget that drops nothing; count and `dropped` at
budgets that drop (per slab and past the buffer); both welds (sums, counts,
group ids, n_unique) bitwise, the hash weld also when its probes run out;
orientation, trilinear colors, extract_triangle_mesh (with and without the
4x re-run) and every mesh/ops.py function bitwise; PLY files byte-identical
to the JAX writer's and read back equal. The port reproduces XLA's CPU
rounding where it contracts products into fused multiply-adds (corner
positions, edge interpolation, cross products, norms, the smoothing step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import SyntheticRGBDCamera as JSyntheticRGBDCamera
from recon3d_tpu.fusion import marching as jm
from recon3d_tpu.fusion import tsdf as jt
from recon3d_tpu.mesh import ops as jo
from recon3d_tpu.utils import io as jio
from recon3d_tpu.utils.types import CameraIntrinsics as JCameraIntrinsics
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.fusion import marching as tm
from recon3d_tpu_torch.mesh import ops as to
from recon3d_tpu_torch.utils import io as tio

VOLUME = dict(resolution=64, voxel_size=0.016, sdf_trunc=0.05, origin=(-0.512, -0.512, 0.902))

@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: several test workers share one host, and more
    threads a worker oversubscribe its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)



@pytest.fixture(scope="module")
def vols():
    cam = JSyntheticRGBDCamera(width=160, height=120, fx=130.0, fy=130.0, n_frames=3)
    cam.open()
    intr = JCameraIntrinsics(fx=jnp.float32(130.0), fy=jnp.float32(130.0),
                             cx=jnp.float32(79.5), cy=jnp.float32(59.5))
    jv = jt.make_volume(**VOLUME)
    for k in range(3):
        c, d = cam.grab()
        jv = jt.integrate(jv, jnp.asarray(d), intr, jnp.asarray(cam.true_pose(k), jnp.float32),
                          color=jnp.asarray(c))
    arrays = {f.name: np.asarray(getattr(jv, f.name)) for f in dataclasses.fields(jv)}
    return jv, convert.tsdf_volume(arrays, device="cpu")


def _port_mesh(jmesh):
    return convert.triangle_mesh({f.name: None if getattr(jmesh, f.name) is None
                                  else np.asarray(getattr(jmesh, f.name))
                                  for f in dataclasses.fields(jmesh)}, device="cpu")


def _assert_mesh_equal(tmesh, jmesh, what):
    for f in dataclasses.fields(jmesh):
        a, b = getattr(jmesh, f.name), getattr(tmesh, f.name)
        assert (a is None) == (b is None), (what, f.name)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{what}: {f.name}")


def test_soup_matches_jax_without_drops(vols):
    jv, tv = vols
    js, jval, jc, jd = jm.extract_triangle_soup(jv, max_triangles=1 << 17, with_dropped=True,
                                                cap_mult=1)
    ts, tval, tc, td = tm.extract_triangle_soup(tv, max_triangles=1 << 17, with_dropped=True,
                                                cap_mult=1)
    assert int(jd) == int(td) == 0 and int(tc) == int(jc) > 10000
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("max_triangles,slab,cap_mult", [(1 << 14, 8, 1), (1 << 14, 5, 4),
                                                         (8000, 8, 4)])
def test_soup_counts_what_it_drops(vols, max_triangles, slab, cap_mult):
    """Per-slab caps that cut (1x of a 2^14 budget; slab 5 leaves a ragged
    last slab) and a buffer that overflows (8000 rows)."""
    jv, tv = vols
    _, jval, jc, jd = jm.extract_triangle_soup(jv, max_triangles=max_triangles, slab=slab,
                                               with_dropped=True, cap_mult=cap_mult)
    _, tval, tc, td = tm.extract_triangle_soup(tv, max_triangles=max_triangles, slab=slab,
                                               with_dropped=True, cap_mult=cap_mult)
    assert int(td) > 0 and (int(tc), int(td)) == (int(jc), int(jd))
    assert int(tval.sum()) == int(tc)


@pytest.fixture(scope="module")
def soup(vols):
    jv, tv = vols
    js, jval, _ = jm.extract_triangle_soup(jv, max_triangles=1 << 16)
    jo_ = jm._orient_by_gradient(jv, js)
    to_ = tm._orient_by_gradient(tv, torch.tensor(np.asarray(js)))
    return np.asarray(js), np.asarray(jval), np.asarray(jo_), to_


def test_tet_validity_and_triangles_match_jax():
    """The per-tet case logic on random corner values with zeros, ties and
    a partial mask, in both layouts, and the triangles of every case."""
    rng = np.random.RandomState(5)
    vals = rng.choice(np.float32([-1.0, -0.25, 0.0, 0.5, 2.0]), size=(4000, 8))
    ok = rng.rand(4000) < 0.9
    ref = np.asarray(jm._tet_validity(jnp.asarray(vals), jnp.asarray(ok)))
    np.testing.assert_array_equal(tm._tet_validity(torch.tensor(vals), torch.tensor(ok)).numpy(),
                                  ref)
    vz = [torch.tensor(vals[:, c].reshape(10, 20, 20)) for c in range(8)]
    okz = torch.tensor(ok.reshape(10, 20, 20))
    refz = np.asarray(jm._tet_validity_z([jnp.asarray(v.numpy()) for v in vz],
                                         jnp.asarray(ok.reshape(10, 20, 20))))
    np.testing.assert_array_equal(tm._tet_validity_z(vz, okz).numpy(), refz)
    p = rng.rand(4000, 4, 3).astype(np.float32)
    v = vals[:, :4]
    jout = jax.jit(jm._tet_triangles)(jnp.asarray(p), jnp.asarray(v), jnp.asarray(ok))
    tout = tm._tet_triangles(torch.tensor(p), torch.tensor(v), torch.tensor(ok))
    for name, a, b in zip(("valid_a", "valid_b"), jout[2:], tout[2:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    for name, a, b in zip(("tri_a", "tri_b"), jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_orientation_matches_jax(soup):
    js, jval, jor, tor = soup
    np.testing.assert_array_equal(tor.numpy(), jor)
    flipped = (jor != js).any(axis=(1, 2)) & jval
    assert 0 < flipped.sum() < jval.sum()


@pytest.mark.parametrize("method,kw", [("sort", {}), ("hash", {}),
                                       ("hash", dict(table_bits=12, probes=2))])
def test_welds_match_jax(vols, soup, method, kw):
    """The hash weld with a 4096-slot table and 2 probes leaves vertices
    unresolved: those become singleton groups in both packages."""
    jv, tv = vols
    _, jval, jor, _ = soup
    jweld = jm._weld_device if method == "sort" else jm._weld_device_hash
    tweld = tm._weld_device if method == "sort" else tm._weld_device_hash
    verts, vvalid = jor.reshape(-1, 3), np.repeat(jval, 3)
    jout = jweld(jnp.asarray(verts), jnp.asarray(vvalid), jnp.float32(0.016 / 256), ref=jv.origin,
                 **kw)
    tout = tweld(torch.tensor(verts), torch.tensor(vvalid),
                 torch.tensor(0.016 / 256, dtype=torch.float32), ref=tv.origin, **kw)
    for name, a, b in zip(("vert_sum", "vert_count", "inv", "n_unique"), jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    if kw:  # the leftovers split groups the full table merges
        full = tm._weld_device_hash(torch.tensor(verts), torch.tensor(vvalid),
                                    torch.tensor(0.016 / 256, dtype=torch.float32),
                                    ref=tv.origin)
        assert int(tout[3]) > int(full[3])
    # and with the soup's own minimum as the reference
    jout = jweld(jnp.asarray(verts), jnp.asarray(vvalid), jnp.float32(0.016 / 256), **kw)
    tout = tweld(torch.tensor(verts), torch.tensor(vvalid),
                 torch.tensor(0.016 / 256, dtype=torch.float32), **kw)
    for name, a, b in zip(("vert_sum", "vert_count", "inv", "n_unique"), jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_weld_of_an_empty_soup():
    mesh = tm.weld_mesh(torch.zeros((16, 3, 3)), torch.zeros(16, dtype=torch.bool), 0.05)
    assert not bool(mesh.triangle_valid.any()) and not bool(mesh.vertex_valid.any())


def test_volume_colors_match_jax(vols):
    jv, tv = vols
    verts = np.random.RandomState(0).uniform(-0.55, 0.55, (5000, 3)).astype(np.float32)
    verts[:, 2] += 1.4
    ref = np.asarray(jm.sample_volume_colors(jv)(verts))
    np.testing.assert_array_equal(tm.sample_volume_colors(tv)(torch.tensor(verts)).numpy(), ref)
    assert tm.sample_volume_colors(dataclasses.replace(tv, color=None)) is None


@pytest.mark.parametrize("max_triangles", [None, 1 << 15])
def test_extract_triangle_mesh_matches_jax(vols, max_triangles):
    """The default budget (no drop at 1x), and 2^15, where the 1x per-slab
    cap drops and the soup is re-extracted at 4x."""
    jv, tv = vols
    if max_triangles:
        _, _, _, dropped = tm.extract_triangle_soup(tv, max_triangles=max_triangles,
                                                    with_dropped=True, cap_mult=1)
        assert int(dropped) > 0
    jmesh = jm.extract_triangle_mesh(jv, max_triangles=max_triangles)
    tmesh = tm.extract_triangle_mesh(tv, max_triangles=max_triangles)
    _assert_mesh_equal(tmesh, jmesh, "extract_triangle_mesh")
    assert tmesh.triangles.shape[0] > 10000 and tmesh.vertex_colors is not None


@pytest.fixture(scope="module")
def mesh(vols):
    jmesh = jm.extract_triangle_mesh(vols[0])
    return jmesh, _port_mesh(jmesh)


@pytest.mark.parametrize("iterations,lam", [(5, 0.5), (2, 0.3)])
def test_smoothing_matches_jax(mesh, iterations, lam):
    jmesh, tmesh = mesh
    _assert_mesh_equal(to.filter_smooth_laplacian(tmesh, iterations, lam),
                       jo.filter_smooth_laplacian(jmesh, iterations=iterations, lam=lam),
                       "smooth")


def _damaged(jmesh):
    """The mesh with a NaN vertex, a duplicated vertex, a degenerate and a
    duplicated (rewound) triangle."""
    v = np.asarray(jmesh.vertices).copy()
    t = np.asarray(jmesh.triangles).copy()
    v[3] = np.nan
    v[11] = v[10]
    t[5] = [t[5, 0], t[5, 0], t[5, 1]]
    t[7] = t[6, [1, 0, 2]]
    return dataclasses.replace(jmesh, vertices=jnp.asarray(v), triangles=jnp.asarray(t))


@pytest.mark.parametrize("name", ["remove_nan_vertices", "remove_duplicated_vertices",
                                  "remove_duplicated_triangles", "remove_degenerate_triangles",
                                  "remove_unreferenced_vertices", "cleanup"])
def test_cleanup_filters_match_jax(mesh, name):
    jmesh = _damaged(mesh[0])
    tout = getattr(to, name)(_port_mesh(jmesh))
    jout = getattr(jo, name)(jmesh)
    _assert_mesh_equal(tout, jout, name)
    if name == "cleanup":
        assert not bool(tout.vertex_valid[3]) and not bool(tout.triangle_valid[5])


def test_degenerate_area_filter(mesh):
    tmesh = mesh[1]
    keep = to.remove_degenerate_triangles(tmesh, area_eps=1e-5).triangle_valid
    v, t = tmesh.vertices.double(), tmesh.triangles.long()
    area = 0.5 * torch.linalg.vector_norm(
        torch.linalg.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]]), dim=1)
    assert 0 < int(keep.sum()) < keep.numel()
    assert torch.equal(keep[(area - 1e-5).abs() > 1e-9], (area > 1e-5)[(area - 1e-5).abs() > 1e-9])


def test_vertex_normals_match_jax(mesh):
    jmesh = jo.cleanup(jo.filter_smooth_laplacian(mesh[0], iterations=5))
    tout = to.compute_vertex_normals(_port_mesh(jmesh))
    _assert_mesh_equal(tout, jo.compute_vertex_normals(jmesh), "normals")
    n = tout.vertex_normals[tout.vertex_valid]
    assert torch.allclose(torch.linalg.vector_norm(n, dim=1), torch.ones(len(n)), atol=1e-5)


@pytest.mark.parametrize("quantile", [0.01, 0.3, 0.77])
def test_density_mask_and_highlight_match_jax(mesh, quantile):
    jmesh, tmesh = mesh
    dens = np.random.RandomState(1).rand(tmesh.vertices.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(to.density_mask(torch.tensor(dens), quantile).numpy(),
                                  np.asarray(jo.density_mask(jnp.asarray(dens), quantile)))
    _assert_mesh_equal(to.highlight_sparse_regions(tmesh, torch.tensor(dens), quantile),
                       jo.highlight_sparse_regions(jmesh, jnp.asarray(dens), quantile),
                       "highlight")
    plain = dataclasses.replace(jmesh, vertex_colors=None)
    _assert_mesh_equal(to.highlight_sparse_regions(_port_mesh(plain), torch.tensor(dens)),
                       jo.highlight_sparse_regions(plain, jnp.asarray(dens)), "highlight gray")


def test_ply_files_are_the_jax_writers_bytes(mesh, tmp_path):
    jmesh = jo.compute_vertex_normals(mesh[0])
    tmesh = _port_mesh(jmesh)
    for binary in (True, False):
        jp, tp = tmp_path / f"j{binary}.ply", tmp_path / f"t{binary}.ply"
        assert tio.write_triangle_mesh(str(tp), tmesh, binary=binary) == \
            jio.write_triangle_mesh(str(jp), jmesh, binary=binary)
        assert tp.read_bytes() == jp.read_bytes()
        back = tio.read_triangle_mesh(str(tp))
        verts, tris, cols, nrm = tmesh.to_numpy()
        np.testing.assert_array_equal(back["points"], verts.astype(np.float64))
        np.testing.assert_array_equal(back["triangles"], tris)
        np.testing.assert_array_equal(back["normals"], nrm.astype(np.float64))
        np.testing.assert_array_equal(
            back["colors"], np.clip(np.round(cols * 255.0), 0, 255).astype(np.uint8) / 255.0)


def test_point_cloud_ply_round_trip(vols, tmp_path):
    jv, tv = vols
    jpc = jt.extract_point_cloud(jv, capacity=1 << 13)
    from recon3d_tpu_torch.fusion import tsdf as tt

    tpc = tt.extract_point_cloud(tv, capacity=1 << 13)
    for double in (False, True):
        jp, tp = tmp_path / f"j{double}.ply", tmp_path / f"t{double}.ply"
        assert tio.write_point_cloud(str(tp), tpc, double=double) == \
            jio.write_point_cloud(str(jp), jpc, double=double)
        assert tp.read_bytes() == jp.read_bytes()
        back = tio.read_point_cloud(str(jp), capacity=1 << 14, device="cpu")
        ref = jio.read_point_cloud(str(jp), capacity=1 << 14)
        for name in ("points", "colors", "valid"):
            np.testing.assert_array_equal(getattr(back, name).numpy(),
                                          np.asarray(getattr(ref, name)), err_msg=name)
    with pytest.raises(ValueError, match="not a PLY"):
        (tmp_path / "bad.ply").write_bytes(b"obj\n")
        tio.read_ply(str(tmp_path / "bad.ply"))
