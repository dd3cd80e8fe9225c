"""Port parity for mesh/poisson.py, mesh/saving.py and the shims
mesh_reconstruction.py / mesh_saving.py against the JAX package on the CPU,
on the JAX tests' sphere (tests/test_mesh_ops.py:97: 3000 points on a
sphere of radius 0.5 with their normals, depth 6).

Bars:
- _splat_trilinear: bitwise (each cell's contributions summed in XLA's
  scatter order).
- _poisson_indicator: chi max |diff| <= 1e-5 max |chi| (measured 1.2e-7 of
  0.223); densities rtol 1e-5 plus an absolute floor of 1e-6 max density:
  the FFT blur leaves ~1e-8 of rounding residue (measured up to 3.0e-8 of a
  0.193 maximum) in cells far from any sample, where the JAX package's and
  PyTorch's FFTs round otherwise and no relative bar can hold.
- create_from_point_cloud_poisson: the JAX test's bars (median radius
  within 0.01 of 0.5, 95th percentile of |r - 0.5| under 0.02) and against
  the JAX mesh equal vertex and triangle counts, each vertex matched to a
  JAX vertex within 1e-3 of a cell (measured 1.3e-6 m of 0.0187) one to one,
  their densities within the indicator's bar. The vertex order is not
  compared: the weld's hash order follows quantization keys that an ulp of
  the minimum vertex moves.
- plasma_colormap / color_by_density: atol 1e-6; save_mesh writes the JAX
  package's files byte for byte.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import recon3d_tpu.mesh_reconstruction as jshim_rec
import recon3d_tpu.mesh_saving as jshim_save
from recon3d_tpu.mesh import poisson as jpoisson
from recon3d_tpu.mesh import saving as jsaving
from recon3d_tpu.utils.types import PointCloud as JPointCloud
from recon3d_tpu.utils.types import TriangleMesh as JTriangleMesh
from recon3d_tpu_torch import convert
from recon3d_tpu_torch import mesh_reconstruction, mesh_saving
from recon3d_tpu_torch.config import MeshConfig
from recon3d_tpu_torch.mesh import poisson, saving
from recon3d_tpu_torch.utils.types import PointCloud

R = 64


@pytest.fixture(scope="module")
def sphere():
    rng = np.random.RandomState(0)
    d = rng.randn(3000, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts, nrm = (d * 0.5).astype(np.float32), d.astype(np.float32)
    return (pts, nrm, JPointCloud.from_numpy(pts, normals=nrm),
            PointCloud.from_numpy(pts, normals=nrm, device="cpu"))


@pytest.fixture(scope="module")
def jax_poisson(sphere):
    _, _, jpc, _ = sphere
    return jpoisson.create_from_point_cloud_poisson(jpc, depth=6)


def _grid(pts):
    lo, hi = pts.min(0), pts.max(0)
    span = float((hi - lo).max()) * 1.2
    return np.asarray(lo - 0.1 * span, np.float32), np.float32(span / R)


def test_splat_is_bitwise_jax(sphere):
    pts, nrm, jpc, pc = sphere
    origin, scale = _grid(pts)
    g = (pc.points - torch.as_tensor(origin)) / torch.tensor(scale)
    jg = (jpc.points - jnp.asarray(origin)) / jnp.float32(scale)
    keep = np.arange(len(pts)) % 7 != 0
    out = poisson._splat_trilinear(torch.zeros((R, R, R, 3)), g, pc.normals,
                                   torch.as_tensor(keep))
    ref = jpoisson._splat_trilinear(jnp.zeros((R, R, R, 3)), jg, jpc.normals, jnp.asarray(keep))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    out = poisson._splat_trilinear(torch.zeros((R, R, R)), g, torch.ones(len(pts)), pc.valid)
    ref = jpoisson._splat_trilinear(jnp.zeros((R, R, R)), jg, jnp.ones(len(pts)), jpc.valid)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _dens_close(d, ref):
    np.testing.assert_allclose(d, ref, rtol=1e-5, atol=1e-6 * float(np.abs(ref).max()))


def test_poisson_indicator_matches_jax(sphere):
    pts, _, jpc, pc = sphere
    origin, scale = _grid(pts)
    jchi, jdens = jpoisson._poisson_indicator(jpc.points, jpc.normals, jpc.valid, R,
                                              jnp.asarray(origin), jnp.float32(scale), 1.5)
    chi, dens = poisson._poisson_indicator(pc.points, pc.normals, pc.valid, R,
                                           torch.as_tensor(origin), torch.tensor(scale), 1.5)
    jchi = np.asarray(jchi)
    assert chi.dtype == dens.dtype == torch.float32 and chi.shape == (R, R, R)
    assert np.abs(chi.numpy() - jchi).max() <= 1e-5 * np.abs(jchi).max()
    _dens_close(dens.numpy(), np.asarray(jdens))


def _matched(verts, jverts, cell):
    dist, idx = cKDTree(jverts).query(verts)
    assert dist.max() <= 1e-3 * cell, dist.max()
    np.testing.assert_array_equal(np.sort(idx), np.arange(len(jverts)))
    return idx


def test_sphere_reconstruction_matches_jax(sphere, jax_poisson):
    pts, _, _, pc = sphere
    mesh, dens = poisson.create_from_point_cloud_poisson(pc, depth=6)
    verts, tris, _, _ = mesh.to_numpy()
    r = np.linalg.norm(verts, axis=1)
    assert abs(np.median(r) - 0.5) < 0.01
    assert np.percentile(np.abs(r - 0.5), 95) < 0.02
    assert dens.shape == (mesh.vertices.shape[0],)
    jmesh, jdens = jax_poisson
    jverts, jtris, _, _ = jmesh.to_numpy()
    assert (len(verts), len(tris)) == (len(jverts), len(jtris))
    idx = _matched(verts, jverts, _grid(pts)[1])
    _dens_close(dens.numpy(), np.asarray(jdens)[idx])


def test_poisson_refuses_clouds_without_normals_or_points():
    pc = PointCloud.from_numpy(np.random.RandomState(1).randn(100, 3).astype(np.float32),
                               device="cpu")
    with pytest.raises(ValueError, match="normals"):
        poisson.create_from_point_cloud_poisson(pc, depth=5)
    empty = PointCloud.from_numpy(np.zeros((8, 3), np.float32),
                                  normals=np.ones((8, 3), np.float32), device="cpu")
    empty = PointCloud(points=empty.points, valid=torch.zeros(8, dtype=torch.bool),
                       normals=empty.normals)
    with pytest.raises(ValueError, match="empty point cloud"):
        poisson.create_from_point_cloud_poisson(empty, depth=5)


def test_plasma_and_density_colors_match_jax():
    x = np.linspace(-0.2, 1.2, 301)
    np.testing.assert_allclose(saving.plasma_colormap(x), jsaving.plasma_colormap(x), atol=1e-6)
    rng = np.random.RandomState(2)
    V = 50
    arrays = dict(vertices=rng.randn(V, 3).astype(np.float32),
                  triangles=rng.randint(0, V, (40, 3)).astype(np.int32),
                  vertex_valid=np.ones(V, bool), triangle_valid=np.ones(40, bool))
    dens = rng.rand(V).astype(np.float32)
    mesh, d = convert.poisson_mesh(arrays, dens, device="cpu")
    out = saving.color_by_density(mesh, d)
    ref = jsaving.color_by_density(JTriangleMesh(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                                   jnp.asarray(dens))
    assert out.vertex_colors.dtype == torch.float32
    np.testing.assert_allclose(out.vertex_colors.numpy(), np.asarray(ref.vertex_colors),
                               atol=1e-6)


def test_save_mesh_and_shims_write_the_jax_files(sphere, jax_poisson, tmp_path):
    jmesh, jdens = jax_poisson
    mesh, dens = convert.poisson_mesh({k: np.asarray(getattr(jmesh, k)) for k in (
        "vertices", "triangles", "vertex_valid", "triangle_valid")}, np.asarray(jdens),
        device="cpu")
    paths = saving.save_mesh(mesh, dens, filename=str(tmp_path / "p.ply"))
    jpaths = jsaving.save_mesh(jmesh, jdens, filename=str(tmp_path / "j.ply"))
    assert paths == (str(tmp_path / "p.ply"), str(tmp_path / "p_colored.ply"))
    for p, q in zip(paths, jpaths):
        assert open(p, "rb").read() == open(q, "rb").read()
    assert saving.save_mesh(mesh, filename=str(tmp_path / "n.ply"))[1] is None
    shim = mesh_saving.MeshSaving(str(tmp_path / "s.ply")).save_mesh(mesh, dens)
    jshim = jshim_save.MeshSaving(str(tmp_path / "t.ply")).save_mesh(jmesh, jdens)
    for p, q in zip(shim, jshim):
        assert open(p, "rb").read() == open(q, "rb").read()


def test_mesh_reconstruction_shim_matches_jax(sphere):
    pts, _, jpc, pc = sphere
    cfg = MeshConfig(poisson_depth=6, smoothing_iterations=2)
    mesh, dens = mesh_reconstruction.MeshReconstruction(cfg).reconstruct_mesh(pc)
    jcfg = jshim_rec.MeshConfig(poisson_depth=6, smoothing_iterations=2)
    jmesh, jdens = jshim_rec.MeshReconstruction(jcfg).reconstruct_mesh(jpc)
    assert mesh.vertex_normals is not None and dens.shape == (mesh.vertices.shape[0],)
    verts, tris, _, nrm = mesh.to_numpy()
    jverts, jtris, _, _ = jmesh.to_numpy()
    assert (len(verts), len(tris)) == (len(jverts), len(jtris))
    _matched(verts, jverts, _grid(pts)[1])
    r = np.linalg.norm(verts, axis=1)
    assert abs(np.median(r) - 0.5) < 0.01
    f_mesh, f_dens = mesh_reconstruction.reconstruct_mesh(pc, depth=5)
    assert f_dens.shape == (f_mesh.vertices.shape[0],)
