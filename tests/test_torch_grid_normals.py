"""Port parity for the grid normals path: K7's and K8's plain versions
(recon3d_tpu_torch/ops/grid_knn.py, taken by ops/grid_knn_cuda.py for CPU
tensors), the eigen-solves, estimate_normals on both sides of the
32768-point switch, orientation and the shims, against the JAX package on
the CPU (its Pallas kernels with interpret=True), on seeded numpy inputs.
The whole slice is tests/test_torch_pointcloud_slice.py. Bars (the JAX
package's own, tests/test_grid_knn.py):
  K7: the packed table (through the one layout conversion of
  ops/grid_knn.py's docstring), point_slot and overflow bitwise against
  grid_knn._bin_points_packed, overflow included, and against the Pallas
  pack where its DMA window does not overflow (a direct placement has no
  window);
  K8 moments: count exact, mean and covariance atol 1e-5;
  K8 normals and the eigen-solves: |dot| median > 0.99999 and > 0.999 on
  at least 99 % of points with at least 5 neighbors, on surface-like
  clouds (isolated or collinear neighborhoods have no defined normal).
The JAX package's XLA route materializes (C, C, G^3) intermediates, so the
grid path runs at G <= 32 here; the shims run at their defaults below the
switch (the brute-force path).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu import normal_estimation as jne
from recon3d_tpu import pointcloud_processing as jpp
from recon3d_tpu.camera.fake import SyntheticRGBDCamera as JSyntheticRGBDCamera
from recon3d_tpu.ops import grid_knn as jgk
from recon3d_tpu.ops import grid_knn_pallas as jgkp
from recon3d_tpu.pointcloud import backproject as jbp
from recon3d_tpu.pointcloud import normals as jn
from recon3d_tpu.utils import types as jtypes
from recon3d_tpu_torch import normal_estimation, pointcloud_processing
from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
from recon3d_tpu_torch.ops import grid_knn, grid_knn_cuda
from recon3d_tpu_torch.pointcloud import backproject
from recon3d_tpu_torch.pointcloud import normals as tn
from recon3d_tpu_torch.utils import io as tio
from recon3d_tpu_torch.utils import types
from tests import _grid_tables


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread for this module's many small tensor ops: several test
    workers share one host, and more threads a worker oversubscribe its
    cores (each op's fork / join then waits on descheduled threads)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pk_from_jax(pk, G, C):
    """The JAX (G, 4C, G * gz) packed table in the port's (G^3 * C, 4) layout."""
    gz = jgk._lane_stride(G)
    return np.asarray(pk).reshape(G, 4, C, G, gz)[..., :G].transpose(0, 3, 4, 2, 1).reshape(
        -1, 4)


def _slot_from_jax(ps, G, C):
    """JAX slot ids ((x * G + y) * gz + z) * C + c as the port's, gz -> G."""
    gz = jgk._lane_stride(G)
    ps = np.asarray(ps).astype(np.int64)
    cell, c = ps // C, ps % C
    x, y, z = cell // (G * gz), (cell // gz) % G, cell % gz
    return np.where(ps < 0, -1, ((x * G + y) * G + z) * C + c)


@pytest.mark.parametrize("n,G,C,r", [(5000, 16, 8, 0.05), (20000, 24, 16, 0.04)])
def test_pack_matches_jax_bitwise(n, G, C, r):
    """K7's plain version against the XLA gather and the Pallas one-hot
    pack (test_grid_knn.py:164-184's shapes), invalid points included."""
    rng = np.random.RandomState(13)
    pts = (rng.rand(n, 3) * 0.8).astype(np.float32)
    valid = rng.rand(n) > 0.05
    pk0, ps0, ov0 = jgk._bin_points_packed(jnp.asarray(pts), jnp.asarray(valid), r, G, C)
    pk1, ps1, ov1 = jgkp._bin_points_packed_pallas(jnp.asarray(pts), jnp.asarray(valid), r, G,
                                                   C, interpret=True)
    pk, ps, ov = grid_knn_cuda.bin_points_packed_cuda(torch.tensor(pts), torch.tensor(valid),
                                                      r, G, C)
    assert pk.shape == (G ** 3 * C, 4) and ps.dtype == torch.int32
    for ref_pk, ref_ps, ref_ov in ((pk0, ps0, ov0), (pk1, ps1, ov1)):
        np.testing.assert_array_equal(pk.numpy(), _pk_from_jax(ref_pk, G, C))
        np.testing.assert_array_equal(ps.numpy(), _slot_from_jax(ref_ps, G, C))
        assert float(ov) == float(ref_ov)
    assert (pk[:, 3] == 1).sum() == (ps >= 0).sum() > 0.8 * n


def test_pack_overflow_matches_xla_bitwise():
    """An over-capacity cloud (40k points in 1 cm^3, C = 4): the overflow is
    the capacity overflow of _sort_cells, bitwise with the XLA twin; the
    Pallas pack also loses points past its DMA window, so it reports more."""
    rng = np.random.RandomState(3)
    pts = (rng.rand(40000, 3) * 0.01).astype(np.float32)
    valid = np.ones(40000, bool)
    pk0, ps0, ov0 = jgk._bin_points_packed(jnp.asarray(pts), jnp.asarray(valid), 0.05, 16, 4)
    pk, ps, ov = grid_knn._bin_points_packed(torch.tensor(pts), torch.tensor(valid), 0.05, 16,
                                             4)
    np.testing.assert_array_equal(pk.numpy(), _pk_from_jax(pk0, 16, 4))
    np.testing.assert_array_equal(ps.numpy(), _slot_from_jax(ps0, 16, 4))
    assert float(ov) == float(ov0) > 0.99


@pytest.mark.parametrize("seed,n,scale,G,C,pallas", [(7, 3000, 0.7, 16, 8, True),
                                                     (5, 3000, 0.55, 12, 16, False)])
def test_moments_match_jax(seed, n, scale, G, C, pallas):
    """K8's moments (plain version) against grid_pca_moments and, on the
    first cloud, the Pallas kernel in interpret mode (test_grid_knn.py:
    114-160's clouds)."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * scale).astype(np.float32)
    valid = rng.rand(n) > 0.05
    n0, m0, c0 = jgk.grid_pca_moments(jnp.asarray(pts), jnp.asarray(valid), 0.05, grid_size=G,
                                      cell_capacity=C)
    refs = [(n0, m0, None)]
    if pallas:
        refs.append(jgkp.grid_pca_moments_pallas(jnp.asarray(pts), jnp.asarray(valid), 0.05,
                                                 grid_size=G, cell_capacity=C, interpret=True))
    nt, mt, ct = grid_knn_cuda.grid_pca_moments_cuda(torch.tensor(pts), torch.tensor(valid),
                                                     0.05, grid_size=G, cell_capacity=C)
    c0 = np.asarray(c0)
    want6 = np.stack([c0[:, 0, 0], c0[:, 1, 1], c0[:, 2, 2], c0[:, 0, 1], c0[:, 0, 2],
                      c0[:, 1, 2]], -1)
    refs[0] = (n0, m0, want6)
    for n_ref, m_ref, c_ref in refs:
        np.testing.assert_array_equal(nt.numpy(), np.asarray(n_ref))
        np.testing.assert_allclose(mt.numpy(), np.asarray(m_ref), atol=1e-5)
        np.testing.assert_allclose(ct.numpy(), np.asarray(c_ref), atol=1e-5)
    assert np.asarray(n0).max() > 3
    # the port's XLA twin (N, 3, 3) form
    nx, mx, cx = grid_knn.grid_pca_moments(torch.tensor(pts), torch.tensor(valid), 0.05,
                                           grid_size=G, cell_capacity=C)
    np.testing.assert_array_equal(nx.numpy(), np.asarray(n0))
    np.testing.assert_allclose(mx.numpy(), np.asarray(m0), atol=1e-5)
    np.testing.assert_allclose(cx.numpy(), c0, atol=1e-5)


def _pk_to_jax(pk, G, C):
    """The port's (G^3 * C, 4) table in the JAX kernel's (G, 4C, G * G)
    layout (lane stride gz = G)."""
    return np.ascontiguousarray(pk.reshape(G, G, G, C, 4).transpose(0, 4, 3, 1, 2)).reshape(
        G, 4 * C, G * G)


def _rows_from_jax(out, G, C, ch):
    """A JAX kernel's (G, ch * C, G * G) output as the port's (G^3 * C, ch) rows."""
    return np.asarray(out).reshape(G, ch, C, G, G).transpose(0, 3, 4, 2, 1).reshape(-1, ch)


@pytest.mark.parametrize("G,C,kind", [(4, 8, "holes"), (4, 8, "empty"), (4, 8, "full"),
                                      (5, 1, "holes")])
def test_k8_core_matches_pallas_on_hand_made_tables(G, C, kind):
    """K8's plain version (the wrapper's CPU route) against the JAX kernels
    in interpret mode on hand-made tables: occupied slots between empty
    ones (whose stray coordinates must not count), an all-empty table, a
    full one, C = 1 at an odd G. The coordinates make every sum exact, so
    the moments agree bitwise whatever the order of the sums; the fused
    rows are the port's finish of those moments, the counts and the
    empty-slot rows bitwise, the normals within the bar where the
    neighborhood's two smallest eigenvalues are apart."""
    pk = _grid_tables.table(G, C, kind, seed=G * C)
    r2 = _grid_tables.R2
    jpk = jnp.asarray(_pk_to_jax(pk, G, C))
    jm = _rows_from_jax(jgkp.moments_pallas_core(jpk, r2, G, C, interpret=True), G, C, 10)
    jn = _rows_from_jax(jgkp.normals_pallas_core(jpk, r2, G, C, interpret=True), G, C, 4)
    m = grid_knn_cuda.moments_core(torch.tensor(pk), r2, G, C).numpy()
    n = grid_knn_cuda.normals_core(torch.tensor(pk), r2, G, C).numpy()
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(n[:, 3], jn[:, 3])
    np.testing.assert_array_equal(n, grid_knn.normals_from_moments(torch.tensor(jm)).numpy())
    empty = pk[:, 3] == 0
    np.testing.assert_array_equal(n[empty], jn[empty])
    assert (n[empty] == np.float32([0.0, 0.0, 1.0, 0.0])).all() and (m[empty] == 0).all()
    occ = pk[:, 3].reshape(-1, C)
    if kind == "empty":
        assert empty.all()
        return
    assert m[:, 0].max() >= 5 and (occ.all() if kind == "full" else
                                   (np.diff(occ, axis=1) > 0).any() or C == 1)
    mean = m[:, 1:4].astype(np.float64) / np.maximum(m[:, :1], 1)
    sec = m[:, 4:].astype(np.float64) / np.maximum(m[:, :1], 1)
    iu = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
    cov = np.zeros((len(m), 3, 3))
    for k, (i, j) in enumerate(iu):
        cov[:, i, j] = cov[:, j, i] = sec[:, k] - mean[:, i] * mean[:, j]
    ev = np.linalg.eigvalsh(cov)
    well = (m[:, 0] >= 5) & (ev[:, 1] > 2 * ev[:, 0])
    dots = np.abs((n[well, :3] * jn[well, :3]).sum(1))
    assert well.any() and dots.min() > 0.9999, dots.min()


def test_core_variants_and_readback():
    """The fused core is the moments core's finish; the readback gathers a
    point's row by its slot; a wrong table shape is refused."""
    rng = np.random.RandomState(2)
    pts = torch.tensor((rng.rand(2000, 3) * 0.5).astype(np.float32))
    valid = torch.tensor(rng.rand(2000) > 0.1)
    pk, ps, _ = grid_knn_cuda.bin_points_packed_cuda(pts, valid, 0.05, 12, 8)
    m = grid_knn_cuda.moments_core(pk, 0.0025, 12, 8)
    nrm = grid_knn_cuda.normals_core(pk, 0.0025, 12, 8)
    assert m.shape == (12 ** 3 * 8, 10) and nrm.shape == (12 ** 3 * 8, 4)
    fin = grid_knn.normals_from_moments(m)
    assert torch.equal(nrm[:, 3], fin[:, 3]) and torch.equal(nrm[:, 3], m[:, 0])
    well = m[:, 0] >= 5
    _assert_dots(nrm[well, :3].numpy(), fin[well, :3].numpy(), "fused vs moments' finish")
    assert torch.equal(m[:, 0][pk[:, 3] == 0], torch.zeros(int((pk[:, 3] == 0).sum())))
    chan, has = grid_knn_cuda.packed_chan_readback(m, ps)
    assert torch.equal(has, ps >= 0)
    assert torch.equal(chan(0)[has], m[ps[has].long(), 0])
    with pytest.raises(ValueError, match="packed table"):
        grid_knn_cuda.moments_core(pk[:-1], 0.0025, 12, 8)


def _psd(seed, n=500):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, 3, 3).astype(np.float32) * 0.1
    return A @ A.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)


def _cov6(C):
    return np.stack([C[:, 0, 0], C[:, 1, 1], C[:, 2, 2], C[:, 0, 1], C[:, 0, 2], C[:, 1, 2]],
                    -1)


def _assert_dots(a, b, what, signed=False):
    dots = np.sum(a * b, -1)
    if not signed:
        dots = np.abs(dots)
    assert np.median(dots) > (0.999 if signed else 0.99999), f"{what}: median {np.median(dots)}"
    assert (dots > 0.999).mean() >= 0.99, f"{what}: {(dots > 0.999).mean()} above 0.999"


def test_eigen_solves_match_jax():
    """The trigonometric 3x3 solve and the channelwise Newton solve, each
    against its JAX twin and against each other (test_grid_knn.py:208's
    planar-anisotropy PSD matrices)."""
    C = _psd(3)
    v3 = tn._smallest_eigvec_3x3(torch.tensor(C)).numpy()
    v6 = tn._smallest_eigvec_cov6(torch.tensor(_cov6(C))).numpy()
    _assert_dots(v3, np.asarray(jn._smallest_eigvec_3x3(jnp.asarray(C))), "3x3")
    _assert_dots(v6, np.asarray(jn._smallest_eigvec_cov6(jnp.asarray(_cov6(C)))), "cov6")
    _assert_dots(v3, v6, "3x3 vs cov6")
    assert np.allclose(np.linalg.norm(v6, axis=1), 1.0, atol=1e-5)
    # degenerate (isotropic and zero) covariances fall back to +z
    z = tn._smallest_eigvec_cov6(torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0, 0.0],
                                               [0.0] * 6]))
    assert torch.equal(z, torch.tensor([[0.0, 0.0, 1.0]] * 2))


def _surface(seed, n, noise=0.01):
    """A surface-like cloud (test_grid_knn.py:248-270): planar neighborhoods."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2).astype(np.float32) * 0.7
    z = 0.03 * np.sin(8 * xy[:, 0]) + noise * rng.randn(n).astype(np.float32)
    return np.stack([xy[:, 0], xy[:, 1], z], 1).astype(np.float32), rng.rand(n) > 0.05


def test_fused_grid_normals_match_pallas():
    """K8's fused normals (plain version) through _grid_normals against the
    JAX fused Pallas kernel in interpret mode, on points with >= 5 neighbors."""
    pts, valid = _surface(11, 3000)
    cnt = np.asarray(jgk.grid_pca_moments(jnp.asarray(pts), jnp.asarray(valid), 0.05,
                                          grid_size=16, cell_capacity=16)[0])
    ref = np.asarray(jn._grid_normals_pallas(jnp.asarray(pts), jnp.asarray(valid), 0.05, 16, 16,
                                             interpret=True))
    out = tn._grid_normals(torch.tensor(pts), torch.tensor(valid), 0.05, 16, 16).numpy()
    well = cnt >= 5
    assert well.mean() > 0.8
    _assert_dots(out[well], ref[well], "fused normals")
    np.testing.assert_array_equal(out[cnt == 0], ref[cnt == 0])


def test_estimate_normals_grid_path_matches_jax():
    """estimate_normals above the switch (N = 34000 > 32768): the grid path,
    against the JAX package's CPU route (XLA moments + channelwise solve)."""
    pts, valid = _surface(21, 34000, noise=0.002)
    jpc = jtypes.PointCloud(points=jnp.asarray(pts), valid=jnp.asarray(valid))
    tpc = types.PointCloud(points=torch.tensor(pts), valid=torch.tensor(valid))
    kw = dict(radius=0.03, max_nn=30, grid_size=24, cell_capacity=16)
    ref = np.asarray(jn.estimate_normals(jpc, **kw).normals)
    out = tn.estimate_normals(tpc, **kw).normals.numpy()
    cnt = np.asarray(jgk.grid_pca_moments(jpc.points, jpc.valid, 0.03, grid_size=24,
                                          cell_capacity=16)[0])
    well = cnt >= 5  # ~60 points a cell: the first 16 of each get a slot
    assert well.mean() > 0.2
    _assert_dots(out[well], ref[well], "grid estimate_normals")


def _brute_cloud():
    pts, valid = _surface(31, 6000, noise=0.002)
    return (jtypes.PointCloud(points=jnp.asarray(pts), valid=jnp.asarray(valid)),
            types.PointCloud(points=torch.tensor(pts), valid=torch.tensor(valid)))


def test_estimate_and_orient_normals_brute_force_match_jax():
    """Below the switch: hybrid k-NN PCA normals (max_nn 50, radius 0.05),
    then both orientations; the k-NN graph is bitwise, so the consistent
    orientation's signs agree."""
    jpc, tpc = _brute_cloud()
    je, te = jn.estimate_normals(jpc), tn.estimate_normals(tpc)
    v = np.asarray(jpc.valid)
    _assert_dots(te.normals.numpy()[v], np.asarray(je.normals)[v], "brute-force normals")
    cam = np.array([0.3, 0.2, 1.0], np.float32)
    jc = jn.orient_normals_towards_camera(je, jnp.asarray(cam))
    tc = tn.orient_normals_towards_camera(te, cam)
    _assert_dots(tc.normals.numpy()[v], np.asarray(jc.normals)[v], "towards camera",
                 signed=True)
    assert (np.sum(tc.normals.numpy() * (cam - tpc.points.numpy()), 1)[v] >= 0).all()
    jo = jn.orient_normals_consistent(je, k=10, iterations=100)
    to = tn.orient_normals_consistent(te, k=10, iterations=100)
    _assert_dots(to.normals.numpy()[v], np.asarray(jo.normals)[v], "consistent", signed=True)


def test_shims_at_defaults_below_the_switch(tmp_path):
    """PointCloudProcessing() and NormalEstimation() at their defaults on a
    small RGBD frame (N = 80 * 60 <= 32768: the brute-force path)."""
    color, depth = _frame(80, 60, cx=-10.0)
    K = np.array([[525.0, 0, -10.0], [0, 525.0, 29.5], [0, 0, 1]], np.float32)
    jpc = jbp.pointcloud_from_rgbd(jnp.asarray(color), jnp.asarray(depth),
                                   jtypes.CameraIntrinsics.from_matrix(K))
    tpc = backproject.pointcloud_from_rgbd(torch.tensor(color), torch.tensor(depth),
                                           types.CameraIntrinsics.from_matrix(K))
    jq = jpp.PointCloudProcessingWithTPU().process_point_cloud(jpc)
    tq = pointcloud_processing.PointCloudProcessingWithTPU().process_point_cloud(tpc)
    v = np.asarray(jq.valid)
    np.testing.assert_array_equal(tq.valid.numpy(), v)
    assert 0.5 < v.mean() < 1.0
    jo = jne.NormalEstimation().estimate_normals(jq)
    to = normal_estimation.NormalEstimation().estimate_normals(tq)
    _assert_dots(to.normals.numpy()[v], np.asarray(jo.normals)[v], "NormalEstimation",
                 signed=True)
    fo = normal_estimation.estimate_normals(tq)
    assert torch.equal(fo.normals, to.normals)
    # a path reads the PLY (utils/io.py), as the JAX package's shim does
    path = str(tmp_path / "scan.ply")
    tio.write_point_cloud(path, tpc)
    pq = pointcloud_processing.PointCloudProcessing().process_point_cloud(path, device="cpu")
    jpq = jpp.PointCloudProcessing().process_point_cloud(path)
    pv = np.asarray(jpq.valid)
    np.testing.assert_array_equal(pq.valid.numpy(), pv)
    np.testing.assert_allclose(pq.points.numpy()[pv], np.asarray(jpq.points)[pv], rtol=1e-6,
                               atol=1e-6)


def _frame(W, H, cx):
    """Frame 0 of a SyntheticRGBDCamera window whose principal point lies
    left of the image: the sphere's limb and the plane z = 1.8 behind it."""
    j, t = (cls(W, H, cx=cx) for cls in (JSyntheticRGBDCamera, SyntheticRGBDCamera))
    for cam in (j, t):
        cam.open()
    (cj, dj), (ct, dt) = j.grab(), t.grab()
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(dt, dj)
    return ct, dt
