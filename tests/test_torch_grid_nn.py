"""Port parity for ops/grid_knn.py's neighbor searches (`grid_nearest_neighbor`,
`grid_knn`) and for ICP's grid branch against the JAX package on the CPU.
Bars and the largest differences measured:
  grid_nearest_neighbor / grid_knn: indices equal and squared distances
  rtol 1e-6 (both measured bitwise), on dyadic lattices full of planted
  ties (a tie goes to the earlier candidate in (offset, slot) order, as
  the JAX package's strict running minimum / lax.top_k merge keep it),
  with queries and db points off the grid (BIG, index 0), invalid points
  and cells over capacity; the overflow share equal;
  registration_icp on 8200-point clouds (N * M > 2^26: the grid branch in
  both packages), 3 iterations: transform atol 1e-5 (measured 4.3e-7),
  fitness rtol 1e-6 (equal).
"""
import numpy as np
import pytest
import torch

from recon3d_tpu.ops import grid_knn as jgrid
from recon3d_tpu.registration import icp as jicp
from recon3d_tpu.utils import types as jtypes
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.ops import grid_knn
from recon3d_tpu_torch.registration import icp


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lattice_sets(seed):
    """Query and db points on a 1/64 lattice (exact squared distances, so
    many exact ties), 1 % of each pushed off the far side of the grid and
    5 % invalid."""
    rng = np.random.RandomState(seed)
    q = (rng.randint(0, 64, (3000, 3)) / 64.0).astype(np.float32)
    d = (rng.randint(0, 64, (2500, 3)) / 64.0).astype(np.float32)
    q[:30] += 3.0
    d[:25] += 5.0
    return q, rng.rand(3000) > 0.05, d, rng.rand(2500) > 0.05


def _ties(q, qv, d, dv):
    dd = ((q[:, None, :].astype(np.float64) - d[None]) ** 2).sum(-1)
    dd[:, ~dv] = np.inf
    m = dd.min(1)
    return int(((dd == m[:, None]).sum(1) > 1)[qv].sum())


@pytest.mark.parametrize("radius,G,C", [(0.05, 24, 8), (0.1, 16, 4), (0.04, 32, 2)])
def test_grid_nearest_neighbor_matches_jax(radius, G, C):
    q, qv, d, dv = _lattice_sets(0)
    assert _ties(q, qv, d, dv) > 100
    ji, jd = jgrid.grid_nearest_neighbor(q, qv, d, dv, radius, grid_size=G, cell_capacity=C)
    ti, td = grid_knn.grid_nearest_neighbor(torch.tensor(q), torch.tensor(qv), torch.tensor(d),
                                            torch.tensor(dv), radius, G, C)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    found = np.asarray(jd) < 1e29
    assert found.sum() > 1000 and not found[:30].any()  # the off-grid queries: BIG


def test_grid_nearest_neighbor_random_cloud_matches_jax():
    rng = np.random.RandomState(1)
    q, d = rng.rand(4000, 3).astype(np.float32), rng.rand(3000, 3).astype(np.float32)
    qv, dv = rng.rand(4000) > 0.1, rng.rand(3000) > 0.1
    ji, jd = jgrid.grid_nearest_neighbor(q, qv, d, dv, 0.05, grid_size=24, cell_capacity=8)
    ti, td = grid_knn.grid_nearest_neighbor(torch.tensor(q), torch.tensor(qv), torch.tensor(d),
                                            torch.tensor(dv), 0.05, 24, 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)


@pytest.mark.parametrize("cloud", ["lattice", "random"])
@pytest.mark.parametrize("k,G,C", [(10, 16, 8), (6, 24, 3)])
def test_grid_knn_matches_jax(cloud, k, G, C):
    q, qv, _, _ = _lattice_sets(2)
    if cloud == "random":
        q = np.random.RandomState(3).rand(3000, 3).astype(np.float32)
    a = jgrid.grid_knn(q, qv, 0.1, k=k, grid_size=G, cell_capacity=C)
    b = grid_knn.grid_knn(torch.tensor(q), torch.tensor(qv), 0.1, k, G, C)
    np.testing.assert_array_equal(b.indices.numpy(), np.asarray(a.indices))
    np.testing.assert_allclose(b.sq_dists.numpy(), np.asarray(a.sq_dists), rtol=1e-6)
    assert float(b.overflow_fraction) == float(a.overflow_fraction)


def test_icp_grid_branch_matches_jax():
    """8200 points a side: N * M = 6.7e7 > 2^26, so both packages' ICP
    correspond through the grid 1-NN (cell edge = threshold 0.05, the
    2 m surface inside the 3.2 m grid)."""
    rng = np.random.RandomState(3)
    xy = rng.rand(8200, 2) * 2 - 1
    pts = np.column_stack([xy, 0.3 * np.sin(2.0 * xy[:, 0])
                           + 0.2 * np.cos(3.0 * xy[:, 1])]).astype(np.float32)
    c, s = np.cos(0.04), np.sin(0.04)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    noise = rng.randn(8200, 3).astype(np.float32) * 0.003
    tgt = pts @ R.T + np.float32([0.02, -0.015, 0.01]) + noise
    js, jt = jtypes.PointCloud.from_numpy(pts), jtypes.PointCloud.from_numpy(tgt)
    assert icp.uses_grid(8200, 8200) and not icp.uses_grid(8192, 8192)
    kw = dict(threshold=0.05, max_iterations=3, relative_fitness=0.0, relative_rmse=0.0)
    a = jicp.registration_icp(js, jt, **kw)
    b = icp.registration_icp(*(convert.point_cloud({"points": np.asarray(c.points),
                                                    "valid": np.asarray(c.valid)}, device="cpu")
                               for c in (js, jt)), **kw)
    np.testing.assert_allclose(b.transformation.numpy(), np.asarray(a.transformation), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(b.fitness), float(a.fitness), rtol=1e-6)
    assert float(a.fitness) > 0.9
