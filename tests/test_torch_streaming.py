"""Port parity for pipeline/streaming.py:StreamingFusion against the JAX
package's on the CPU, at tests/test_pipelines.py's _small_cfg size: 160x120
SyntheticRGBDCamera frames (fx = fy = 130, step 0.01), a 96^3 volume (voxel
0.015, sdf_trunc 0.06, depth_trunc 2.5), origin (-0.72, -0.72, 0.3), keyframe
tracking, one frame at a time through _fuse_one.

Cross-package bars (the JAX step is one jitted program, so XLA rounds its
odometry otherwise than the port's eager one): trajectory atol 1e-4
(measured 3.6e-7 over 6 frames); tsdf, weight and color within 1e-4 on all
but at most 0.1 % of the voxels (measured: tsdf max 4.0e-6 with no voxel
past 1e-4, weight equal, color 39 of 2,654,208 channels past 1e-4, up to
0.12: a voxel whose projection crosses a pixel edge under a 1e-7 pose
difference reads another pixel). The test counts and bounds that remainder.
With a filter chain the JAX side runs DepthFilterBank(temporal=False): under
its jit the temporal state is frozen (test_torch_filters.py), the port's
follows the eager bank. A checkpoint written by either package resumes in the
other within the same bars of the JAX package's uninterrupted run; the
auto-fit origin is bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu import config as jconfig
from recon3d_tpu.camera.fake import SyntheticRGBDCamera
from recon3d_tpu.depth.filters import DepthFilterBank as JDepthFilterBank
from recon3d_tpu.pipeline.streaming import StreamingFusion as JStreamingFusion
from recon3d_tpu.utils.types import CameraIntrinsics as JIntrinsics
from recon3d_tpu_torch import config
from recon3d_tpu_torch.depth.filters import DepthFilterBank
from recon3d_tpu_torch.pipeline.streaming import StreamingFusion
from recon3d_tpu_torch.utils.types import CameraIntrinsics

KW = dict(resolution=96, volume_origin=(-0.72, -0.72, 0.3))
N = 6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(pkg, out):
    return pkg.ScannerConfig(
        stream=pkg.StreamConfig(width=160, height=120, depth_trunc=2.5),
        fusion=pkg.FusionConfig(voxel_size=0.015, sdf_trunc=0.06, grid_resolution=96,
                                depth_trunc=2.5),
        output_dir=str(out))


def _jintr():
    return JIntrinsics(fx=jnp.float32(130.0), fy=jnp.float32(130.0), cx=jnp.float32(79.5),
                       cy=jnp.float32(59.5))


INTR = CameraIntrinsics(130.0, 130.0, 79.5, 59.5)


def _cam(n=N, step=0.01):
    return SyntheticRGBDCamera(width=160, height=120, fx=130.0, fy=130.0, n_frames=n, step=step)


@pytest.fixture(scope="module")
def frames():
    cam = _cam()
    cam.open()
    return [cam.grab() for _ in range(N)]


@pytest.fixture(scope="module")
def jax_run(frames, tmp_path_factory):
    """The JAX package's uninterrupted run, and its checkpoint at frame 3."""
    out = tmp_path_factory.mktemp("jax_run")
    cfg = _cfg(jconfig, out)
    sf = JStreamingFusion(None, _jintr(), cfg, **KW)
    ckpt = None
    for k, (c, d) in enumerate(frames):
        sf._fuse_one(jnp.asarray(c), jnp.asarray(d), cfg.fusion)
        if k == 2:
            ckpt = sf.save_checkpoint(str(out / "jax_ckpt.npz"))
    return sf, ckpt


def _port(tmp_path, **kw):
    cfg = _cfg(config, tmp_path)
    return StreamingFusion(None, INTR, cfg, device="cpu", **{**KW, **kw}), cfg.fusion


def _close_to_jax(sf, jsf, n=N):
    """The cross-package bars; returns the measured numbers."""
    assert len(sf.trajectory) == len(jsf.trajectory) == n
    traj = max(float(np.abs(p.numpy() - np.asarray(q)).max())
               for p, q in zip(sf.trajectory, jsf.trajectory))
    assert traj <= 1e-4, traj
    out = {"trajectory": traj}
    for name in ("tsdf", "weight", "color"):
        diff = np.abs(getattr(sf.volume, name).numpy() - np.asarray(getattr(jsf.volume, name)))
        past = int((diff > 1e-4).sum())
        assert past <= 1e-3 * diff.size, (name, past, diff.size)
        out[name] = (float(diff.max()), past)
    np.testing.assert_array_equal(sf.volume.origin.numpy(), np.asarray(jsf.volume.origin))
    return out


def test_fuse_one_matches_jax(frames, jax_run, tmp_path):
    jsf, _ = jax_run
    sf, fc = _port(tmp_path)
    for c, d in frames:
        sf._fuse_one(c, d, fc)
    assert sf.frames_integrated == N and sf.odometry_failures == jsf.odometry_failures == 0
    _close_to_jax(sf, jsf)
    np.testing.assert_allclose(sf.world_from_cam, np.asarray(jsf.world_from_cam), atol=1e-4)
    # the trajectory tracks the truth: world_from_cam(k) ~ inv(true_pose(k))
    cam = _cam()
    for k in range(1, 4):
        err = np.linalg.norm(sf.trajectory[k].numpy()[:3, 3]
                             - np.linalg.inv(cam.true_pose(k))[:3, 3])
        assert err < 0.01, f"frame {k} drift {err * 1000:.1f} mm"


def test_filtered_stream_matches_jax_without_temporal(frames, tmp_path):
    jcfg = _cfg(jconfig, tmp_path)
    jsf = JStreamingFusion(None, _jintr(), jcfg,
                           depth_filters=JDepthFilterBank(temporal=False), **KW)
    sf, fc = _port(tmp_path, depth_filters=DepthFilterBank(temporal=False))
    for c, d in frames[:4]:
        jsf._fuse_one(jnp.asarray(c), jnp.asarray(d), jcfg.fusion)
        sf._fuse_one(c, d, fc)
    _close_to_jax(sf, jsf, 4)
    np.testing.assert_array_equal(sf._state.key_depth.numpy(), np.asarray(jsf._state.key_depth))


def test_jax_checkpoint_resumes_in_the_port(frames, jax_run, tmp_path):
    jsf, ckpt = jax_run
    sf, fc = _port(tmp_path)
    sf.restore_checkpoint(ckpt)
    assert sf.frames_integrated == 3 and sf._state.key_color.dtype == torch.uint8
    assert sf._state.failures.dtype == torch.int32 and sf._state.last_success.dtype == torch.bool
    for c, d in frames[3:]:
        sf._fuse_one(c, d, fc)
    _close_to_jax(sf, jsf)


def test_port_checkpoint_resumes_in_jax(frames, jax_run, tmp_path):
    jsf, jckpt = jax_run
    sf, fc = _port(tmp_path)
    for c, d in frames[:3]:
        sf._fuse_one(c, d, fc)
    path = sf.save_checkpoint(str(tmp_path / "port_ckpt.npz"))
    with np.load(path) as mine, np.load(jckpt) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for k in theirs.files:
            assert mine[k].dtype == theirs[k].dtype and mine[k].shape == theirs[k].shape, k
    jcfg = _cfg(jconfig, tmp_path)
    resumed = JStreamingFusion(None, _jintr(), jcfg, **KW).restore_checkpoint(path)
    for c, d in frames[3:]:
        resumed._fuse_one(jnp.asarray(c), jnp.asarray(d), jcfg.fusion)
    for p, q in zip(resumed.trajectory, jsf.trajectory):
        np.testing.assert_allclose(np.asarray(p), np.asarray(q), rtol=0, atol=1e-4)
    diff = np.abs(np.asarray(resumed.volume.tsdf) - np.asarray(jsf.volume.tsdf))
    assert (diff > 1e-4).sum() <= 1e-3 * diff.size


def test_auto_fit_origin_matches_jax(frames, tmp_path):
    c, d = frames[0]
    jcfg = _cfg(jconfig, tmp_path)
    jsf = JStreamingFusion(None, _jintr(), jcfg, resolution=96)
    jsf._fit_origin(jnp.asarray(d), jcfg.fusion)
    sf, fc = _port(tmp_path, volume_origin=None)
    sf._fuse_one(c, d, fc)
    np.testing.assert_array_equal(sf.volume.origin.numpy(), np.asarray(jsf.volume.origin))
    assert float(sf.volume.weight.sum()) > 0


def test_live_mesher_equals_the_full_extract(frames, tmp_path):
    """extract_mesh_live after 3 frames and after 2 more (a real incremental
    refresh): the same vertex and face sets as extract_triangle_mesh."""
    from recon3d_tpu_torch.fusion import marching
    from tests.test_torch_incremental import _same_sets

    sf, fc = _port(tmp_path, live_mesher=True)
    for c, d in frames[:3]:
        sf._fuse_one(c, d, fc)
    _same_sets(sf.mesher.mesh(sf.volume), marching.extract_triangle_mesh(sf.volume), "3 frames")
    for c, d in frames[3:5]:
        sf._fuse_one(c, d, fc)
    assert int(sf.mesher.cache.dirty.sum()) > 0
    live = sf.extract_mesh_live()
    assert int(live.triangle_valid.sum()) > 500
    _same_sets(sf.mesher.mesh(sf.volume), marching.extract_triangle_mesh(sf.volume), "5 frames")
    with pytest.raises(RuntimeError, match="live_mesher=True"):
        _port(tmp_path)[0].extract_mesh_live()
