"""Port parity: the sharded streaming consumer (parallel/fusion.py),
recon3d_tpu_torch against the JAX package on the CPU.

Inputs: SyntheticRGBDCamera frames at 96x80 into a 48^3 volume (JAX's
tests/test_parallel.py:314-420 flow), the JAX side on a frame mesh of the
8 virtual CPU devices (conftest), the port on an in-process mesh of 8
shards and on a gloo group of two ranks. Bars: weights exact, tsdf and
color within 1e-5, poses within 1e-5 (both sides against each other and
against the port's own sequential integrate, with weight_max = 2 crossed
mid-batch); the gloo transport bitwise the in-process one; the caller's
volume left intact.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import SyntheticRGBDCamera
from recon3d_tpu.fusion import tsdf as jtsdf
from recon3d_tpu.parallel import fusion as jfusion
from recon3d_tpu.parallel.mesh import make_mesh as jax_make_mesh
from recon3d_tpu.utils.types import CameraIntrinsics as JIntr
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.fusion import tsdf
from recon3d_tpu_torch.parallel import fusion
from recon3d_tpu_torch.parallel.mesh import make_mesh
from recon3d_tpu_torch.registration.odometry import compute_rgbd_odometry
from recon3d_tpu_torch.utils.types import RGBDImage

from . import _torch_gloo_worker as worker

N = 8
W_MAX = 2.0
GLOO_DEADLINE_S = 180


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """2 torch threads: the suite runs six workers on a shared host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _frames(n):
    cam = SyntheticRGBDCamera(width=96, height=80, fx=80.0, fy=80.0, n_frames=n)
    cam.open()
    frames = [cam.grab() for _ in range(n)]
    cam.close()
    return np.stack([c for c, _ in frames]), np.stack([d for _, d in frames])


def _jintr():
    return JIntr(fx=jnp.float32(80.0), fy=jnp.float32(80.0), cx=jnp.float32(96 / 2 - 0.5),
                 cy=jnp.float32(80 / 2 - 0.5))


INTR = convert.camera_intrinsics(80.0, 80.0, 96 / 2 - 0.5, 80 / 2 - 0.5)
VOL = dict(voxel_size=0.02, sdf_trunc=0.1, origin=(-0.5, -0.5, 0.5))


def _exts(n):
    exts = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    exts[:, 0, 3] = 0.002 * np.arange(n, dtype=np.float32)
    return exts


def _need_devices():
    if len(jax.devices()) < N:
        pytest.skip("needs the 8 virtual CPU devices of the default conftest run")


def _assert_volumes(got, want_tsdf, want_weight, want_color=None):
    np.testing.assert_array_equal(got.weight.numpy(), want_weight)
    np.testing.assert_allclose(got.tsdf.numpy(), want_tsdf, atol=1e-5)
    if want_color is not None:
        np.testing.assert_allclose(got.color.numpy(), want_color, atol=1e-5)


@pytest.fixture(scope="module")
def exact_case():
    """The weight-cap crossing case: 8 frames at fixed poses, weight_max 2."""
    colors, depths = _frames(N)
    exts = _exts(N)
    jvol = jfusion.integrate_frames_exact(
        jtsdf.make_volume(48, with_color=True, **VOL), jnp.asarray(depths), jnp.asarray(exts),
        _jintr(), jax_make_mesh(N, ("frame",)), colors=jnp.asarray(colors), weight_max=W_MAX)
    return colors, depths, exts, {k: np.asarray(getattr(jvol, k))
                                  for k in ("tsdf", "weight", "color")}


def test_integrate_frames_exact_matches_jax_and_sequential(exact_case):
    _need_devices()
    colors, depths, exts, j = exact_case
    vol0 = tsdf.make_volume(48, with_color=True, device="cpu", **VOL)
    before = vol0.tsdf.clone()
    got = fusion.integrate_frames_exact(vol0, torch.tensor(depths), torch.tensor(exts), INTR,
                                        make_mesh(N, ("frame",), device="cpu"),
                                        colors=torch.tensor(colors), weight_max=W_MAX)
    assert torch.equal(vol0.tsdf, before) and not vol0.weight.any(), "the caller's volume changed"
    _assert_volumes(got, j["tsdf"], j["weight"], j["color"])

    seq = tsdf.make_volume(48, with_color=True, device="cpu", **VOL)
    for b in range(N):
        seq = tsdf.integrate(seq, torch.tensor(depths[b]), INTR, torch.tensor(exts[b]),
                             color=torch.tensor(colors[b]), weight_max=W_MAX)
    assert int((seq.weight >= W_MAX).sum()) > 100, "the cap was never crossed"
    _assert_volumes(got, seq.tsdf.numpy(), seq.weight.numpy(), seq.color.numpy())


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["1d-4", "2d-2x2"])
def test_shard_count_and_grid_keep_the_result(exact_case, shape):
    """Another shard count (and the frame axis of a 2-D grid) composes the
    same maps to within the 1e-5 bar, weights exact."""
    colors, depths, exts, j = exact_case
    names = ("frame",) if len(shape) == 1 else ("frame", "row")
    got = fusion.integrate_frames_exact(
        tsdf.make_volume(48, with_color=True, device="cpu", **VOL), torch.tensor(depths),
        torch.tensor(exts), INTR, make_mesh(None, names, device="cpu", shape=shape),
        colors=torch.tensor(colors), weight_max=W_MAX)
    _assert_volumes(got, j["tsdf"], j["weight"], j["color"])


def test_fused_frames_sharded_matches_jax():
    _need_devices()
    colors, depths = _frames(N + 1)
    kc, kd = colors[0], depths[0]
    jvol, jw, jok = jfusion.fused_frames_sharded(
        jtsdf.make_volume(48, with_color=False, **VOL), kc, kd, jnp.asarray(colors[1:]),
        jnp.asarray(depths[1:]), _jintr(), jax_make_mesh(N, ("frame",)), odo_levels=2)
    vol, wfc, ok = fusion.fused_frames_sharded(
        tsdf.make_volume(48, with_color=False, device="cpu", **VOL), torch.tensor(kc),
        torch.tensor(kd), torch.tensor(colors[1:]), torch.tensor(depths[1:]), INTR,
        make_mesh(N, ("frame",), device="cpu"), odo_levels=2)
    assert bool(ok.all()) and np.asarray(jok).all()
    np.testing.assert_allclose(wfc.numpy(), np.asarray(jw), atol=1e-5)
    _assert_volumes(vol, np.asarray(jvol.tsdf), np.asarray(jvol.weight))

    # the port's own sequential chain: odometry against the keyframe, then
    # integrate at the inverse of each world pose
    key = RGBDImage(color=torch.tensor(kc), depth=torch.tensor(kd))
    seq = tsdf.make_volume(48, with_color=False, device="cpu", **VOL)
    for b in range(N):
        res = compute_rgbd_odometry(key, RGBDImage(color=torch.tensor(colors[b + 1]),
                                                   depth=torch.tensor(depths[b + 1])),
                                    INTR, levels=2)
        w = torch.linalg.inv(res.transformation)
        assert torch.equal(w, wfc[b])
        seq = tsdf.integrate(seq, torch.tensor(depths[b + 1]), INTR, torch.linalg.inv(w))
    _assert_volumes(vol, seq.tsdf.numpy(), seq.weight.numpy())


def test_gloo_ranks_equal_the_in_process_mesh(tmp_path, exact_case):
    colors, depths, exts, _ = exact_case
    ctx = torch.multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=worker.fusion_rank_main,
                         args=(r, 2, str(tmp_path / "store"), str(tmp_path), colors, depths,
                               exts, W_MAX))
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
    local = worker.run_fusion(make_mesh(2, ("frame",), device="cpu"), colors, depths, exts,
                              W_MAX)
    for r in range(2):
        got = torch.load(tmp_path / f"fusion_rank{r}.pt")
        for key, want in local.items():
            assert torch.equal(got[key], want), (r, key)
