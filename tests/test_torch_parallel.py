"""Port parity: the shard mesh (parallel/mesh.py) and frame-parallel depth
(parallel/batch.py), recon3d_tpu_torch against the JAX package on the CPU,
and both multi-device consumers on a gloo process group of two ranks
against the in-process mesh of two shards.

batched_depth is held to JAX's batched_depth on a 4-device frame mesh of
the virtual CPU devices (conftest) at tests/test_parallel.py's own bar:
valid equal, disparity atol 1e-4 (before WLS), the mean rtol 1e-5 (both
run their 'auto' backend, the plain oracle on the CPU). The process group's
transport (P2P relays and halos, all_reduce, all_gather) must give the
in-process transport's result bit for bit. The gloo run bounds its own
wall time: the ranks are joined against a deadline, then terminated.
"""
import time

import jax
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import FakeStereoCamera
from recon3d_tpu.config import StereoMatcherConfig as JMatcher
from recon3d_tpu.config import WLSConfig as JWLS
from recon3d_tpu.parallel import batch as jbatch
from recon3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from recon3d_tpu_torch.config import StereoMatcherConfig, WLSConfig
from recon3d_tpu_torch.depth.matcher import compute_disparity
from recon3d_tpu_torch.parallel import batch
from recon3d_tpu_torch.parallel.mesh import frame_sharding, make_mesh, shard_frames

from . import _torch_gloo_worker as worker

GLOO_DEADLINE_S = 180


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """2 torch threads: the suite runs six workers on a shared host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _frames(n, H=48, W=128):
    cam = FakeStereoCamera(width=W, height=H, focal=80.0, baseline=0.05)
    pairs = [cam.render(k)[:2] for k in range(n)]
    return (np.stack([p[0] for p in pairs]).astype(np.float32),
            np.stack([p[1] for p in pairs]).astype(np.float32))


@pytest.mark.parametrize("with_wls", [False, True], ids=["sgm", "sgm+wls"])
def test_batched_depth_matches_jax(with_wls):
    """Valid masks equal and the mean within rtol 1e-5 of JAX's. The
    disparity is held to JAX's at atol 1e-4 before WLS; after WLS it is held
    to the port's own per-frame compute_disparity bit for bit. The float32
    FGS solve of the two packages differs per frame on these textured
    guides (up to ~2e-3 px on 0.4 % of pixels, batching or not; ROADMAP
    queue 3), which is not the sharding's to answer for."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU devices of the default conftest run")
    ls, rs = _frames(4)
    d_j, v_j, mean_j = jbatch.batched_depth(
        ls, rs, jax_make_mesh(4, ("frame",)),
        JMatcher(num_disparities=16, block_size=3, speckle_window_size=0), JWLS(iterations=2),
        with_wls=with_wls)
    mcfg = StereoMatcherConfig(num_disparities=16, block_size=3, speckle_window_size=0)
    wcfg = WLSConfig(iterations=2)
    d_t, v_t, mean_t = batch.batched_depth(
        torch.tensor(ls), torch.tensor(rs), make_mesh(4, ("frame",), device="cpu"), mcfg, wcfg,
        with_wls=with_wls)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(float(mean_t), float(mean_j), rtol=1e-5)
    d, v = d_t.numpy(), v_t.numpy()
    np.testing.assert_allclose(float(mean_t), d[v].sum() / max(v.sum(), 1), rtol=1e-5)
    if with_wls:
        for k in range(4):
            d1, v1 = compute_disparity(torch.tensor(ls[k]), torch.tensor(rs[k]), mcfg, wcfg)
            assert torch.equal(d_t[k], d1) and torch.equal(v_t[k], v1)
    else:
        np.testing.assert_allclose(d, np.asarray(d_j), atol=1e-4)


def test_gloo_ranks_equal_the_in_process_mesh(tmp_path):
    pair = tuple(a.astype(np.float32) for a in FakeStereoCamera(
        width=128, height=60, focal=90.0, baseline=0.06).render(0)[:2])
    frames = _frames(2)
    ctx = torch.multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=worker.rank_main,
                         args=(r, 2, str(tmp_path / "store"), str(tmp_path), pair, frames))
             for r in range(2)]
    for p in ranks:
        p.start()
    deadline = time.monotonic() + GLOO_DEADLINE_S
    for p in ranks:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in ranks if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(10)
    assert not hung, f"gloo ranks still running after {GLOO_DEADLINE_S} s"
    assert [p.exitcode for p in ranks] == [0, 0]

    local = worker.run_consumers(make_mesh(2, ("frame",), device="cpu"),
                                 tuple(map(torch.tensor, pair)), tuple(map(torch.tensor, frames)))
    assert float(local["valid"].float().mean()) > 0.5
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        for key, want in local.items():
            assert torch.equal(got[key], want), (r, key)


def test_make_mesh_is_one_dimensional_on_the_callers_device():
    mesh = make_mesh(4, ("row",), device="cpu")
    assert (mesh.n, mesh.axis_name, mesh.local, mesh.device) == (4, "row", (0, 1, 2, 3),
                                                                   torch.device("cpu"))
    assert make_mesh(device="cpu").n == 1
    with pytest.raises(ValueError, match="1-D"):
        make_mesh(4, ("frame", "row"), device="cpu")


def test_frame_sharding_and_shard_frames():
    mesh = make_mesh(2, ("frame",), device="cpu")
    assert frame_sharding(mesh, 6) == {0: slice(0, 3), 1: slice(3, 6)}
    x = torch.arange(24.0).reshape(6, 4)
    parts = shard_frames(mesh, (x, x + 2))
    assert torch.equal(parts[1][0], x[3:]) and torch.equal(parts[0][1], x[:3] + 2)
    with pytest.raises(ValueError, match="sizes"):
        shard_frames(mesh, (x, x[:4]))
    with pytest.raises(ValueError, match="split"):
        frame_sharding(mesh, 5)
    with pytest.raises(ValueError, match="axis"):
        frame_sharding(mesh, 6, axis="row")


def test_in_process_collectives():
    mesh = make_mesh(3, ("row",), device="cpu")
    xs = {k: torch.full((2,), float(k + 1)) for k in range(3)}
    moved = mesh.ppermute(xs, [(0, 1), (1, 2)])
    assert set(moved) == {1, 2} and torch.equal(moved[2], xs[1])
    assert torch.equal(mesh.psum(xs), torch.full((2,), 6.0))
    assert [float(t[0]) for t in mesh.all_gather(xs)] == [1.0, 2.0, 3.0]
    mesh.send(xs[0], 0, 1)
    assert mesh.recv(0, 1, (2,)) is xs[0]


def test_two_dimensional_mesh_views_are_the_one_dimensional_meshes():
    """make_mesh(shape=(2, 2)) over ("frame", "row"), as the JAX package's
    2-D layouts (__graft_entry__.py:77-82): batched_depth over its frame
    axis and the row-sharded SGM over its row axis, each bitwise its 1-D
    mesh's result. A process group's mesh stays 1-D."""
    from recon3d_tpu_torch.depth import sgm_sharded
    from recon3d_tpu_torch.parallel.mesh import MeshGrid, axis_view

    grid = make_mesh(4, ("frame", "row"), device="cpu", shape=(2, 2))
    assert isinstance(grid, MeshGrid) and grid.n == 4
    assert axis_view(grid, "row").n == 2 and axis_view(grid, "frame").axis_name == "frame"
    ls, rs = _frames(4)
    mcfg = StereoMatcherConfig(num_disparities=16, block_size=3, speckle_window_size=0)
    wcfg = WLSConfig(iterations=2)
    one = batch.batched_depth(torch.tensor(ls), torch.tensor(rs),
                              make_mesh(2, ("frame",), device="cpu"), mcfg, wcfg, with_wls=False)
    two = batch.batched_depth(torch.tensor(ls), torch.tensor(rs), grid, mcfg, wcfg,
                              with_wls=False)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    assert frame_sharding(grid, 4) == {0: slice(0, 2), 1: slice(2, 4)}
    kw = dict(num_disparities=16, block_size=3, num_directions=4)
    pair = (torch.tensor(ls[0]), torch.tensor(rs[0]))
    d1, v1 = sgm_sharded.sgm_disparity_cuda_rowsharded(
        *pair, make_mesh(2, ("row",), device="cpu"), **kw)
    d2, v2 = sgm_sharded.sgm_disparity_cuda_rowsharded(*pair, grid, **kw)
    assert torch.equal(d1, d2) and torch.equal(v1, v2)
    with pytest.raises(ValueError, match="axes"):
        axis_view(grid, "pair")
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh(3, ("frame", "row"), device="cpu", shape=(2, 2))
    with pytest.raises(ValueError, match="process group's mesh is 1-D"):
        make_mesh(None, ("frame", "row"), device="cpu", shape=(2, 2), group=object())
