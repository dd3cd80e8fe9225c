"""Port parity for the whole depth slice: rectified gray pair ->
compute_disparity (SGM-4 + speckle + WLS) -> backproject_disparity with
color, recon3d_tpu_torch against the JAX package on the CPU.

The JAX side runs backend="pallas" (its kernels in interpret mode off the
TPU); the port runs its kernel path, whose wrappers take their plain
PyTorch versions for CPU tensors. Both sides are built through
recon3d_tpu_torch.convert from the same JAX configs and Q. Bars:
  valid masks equal; dense (WLS) disparity rtol 1e-4, atol 1e-3, the WLS
  bar of tests/test_wls_pallas.py:36, since WLS is the last stage;
  backprojection of one disparity: points within 1e-5 of the cloud's
  extent, valid equal; the slice's points within the disparity bar carried
  through z = f * b / d (relative 1e-4 + 1e-3 / d).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import FakeStereoCamera as JFakeStereoCamera
from recon3d_tpu.config import StereoMatcherConfig as JMatcher
from recon3d_tpu.config import WLSConfig as JWLS
from recon3d_tpu.depth import matcher as jmatcher
from recon3d_tpu.ops import image as jimage
from recon3d_tpu.pointcloud import backproject as jbp
from recon3d_tpu.utils.types import CameraIntrinsics as JIntrinsics
from recon3d_tpu_torch import config, convert
from recon3d_tpu_torch.camera.fake import FakeStereoCamera
from recon3d_tpu_torch.depth import matcher
from recon3d_tpu_torch.ops import image
from recon3d_tpu_torch.pointcloud import backproject

FOCAL, BASELINE = 80.0, 0.05


def _scene(H, W):
    gl, gr, dt, _ = JFakeStereoCamera(width=W, height=H, focal=FOCAL, baseline=BASELINE).render(1)
    color = np.random.RandomState(2).randint(0, 256, (H, W, 3)).astype(np.uint8)
    Q = np.zeros((4, 4), np.float32)
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3], Q[1, 3], Q[2, 3], Q[3, 2] = -W / 2.0, -H / 2.0, FOCAL, 1.0 / BASELINE
    return gl.astype(np.float32), gr.astype(np.float32), dt, color, Q


def _state(mcfg, wcfg, Q, K=None):
    return convert.convert_state(dataclasses.asdict(mcfg), dataclasses.asdict(wcfg), Q, K,
                                 device="cpu")


def _extent_close(p, ref, valid, rel=1e-5):
    scale = np.abs(ref[valid]).max()
    assert np.abs(p - ref)[valid].max() <= rel * scale


def test_convert_state_maps_configs_and_backends():
    Q = np.eye(4, dtype=np.float32)
    K = np.array([[500.0, 0, 320.0], [0, 505.0, 240.0], [0, 0, 1]], np.float32)
    for jb, tb in (("pallas", "cuda"), ("xla", "torch"), ("auto", "auto")):
        st = _state(JMatcher.tuned(backend=jb), JWLS(lam=4000.0), Q, K)
        assert st.matcher == config.StereoMatcherConfig.tuned(backend=tb)
        assert st.wls == config.WLSConfig(lam=4000.0)
    assert st.matcher.p1() == JMatcher.tuned().p1() and st.matcher.p2() == 96 * 25
    assert torch.equal(st.Q, torch.eye(4)) and st.Q.device.type == "cpu"
    assert (st.intrinsics.fx, st.intrinsics.fy, st.intrinsics.cx) == (500.0, 505.0, 320.0)
    with pytest.raises(ValueError):
        convert.convert_state(dataclasses.asdict(JMatcher()), {}, np.eye(3))


def test_config_adjust_matches():
    for key in "qawsx":
        t = config.StereoMatcherConfig().adjust(key)
        j = JMatcher().adjust(key)
        assert (t.block_size, t.num_disparities) == (j.block_size, j.num_disparities)
    for key in "edrf":
        t, j = config.WLSConfig().adjust(key), JWLS().adjust(key)
        assert (t.lam, t.sigma_color) == (j.lam, j.sigma_color)


def test_fake_camera_copy_renders_the_same_scene():
    a = JFakeStereoCamera(width=96, height=64, focal=FOCAL, baseline=BASELINE).render(2)
    b = FakeStereoCamera(width=96, height=64, focal=FOCAL, baseline=BASELINE).render(2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_image_ops_match():
    rng = np.random.RandomState(3)
    rgb = (rng.rand(12, 16, 3) * 255).astype(np.float32)
    for order in ("rgb", "bgr"):
        np.testing.assert_allclose(image.rgb_to_gray(torch.tensor(rgb), order).numpy(),
                                   np.asarray(jimage.rgb_to_gray(jnp.asarray(rgb), order)),
                                   rtol=1e-6)
    x = rng.rand(12, 16).astype(np.float32) * 7 - 2
    n = image.normalize_minmax(torch.tensor(x), 0.0, 1.0)
    np.testing.assert_allclose(n.numpy(), np.asarray(jimage.normalize_minmax(jnp.asarray(x), 0.0, 1.0)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(image.colormap_jet(n).numpy(),
                               np.asarray(jimage.colormap_jet(jnp.asarray(n.numpy()))), atol=1e-6)


@pytest.mark.parametrize("standard_q", [True, False])
def test_backproject_disparity_matches(standard_q):
    H, W = 24, 40
    _, _, dt, color, Q = _scene(H, W)
    disp = dt.copy()
    disp[::7, ::5] = -1.0  # invalid pixels
    ref = jbp.backproject_disparity(jnp.asarray(disp), jnp.asarray(Q), color=jnp.asarray(color),
                                    assume_standard_q=standard_q)
    out = backproject.backproject_disparity(torch.tensor(disp), torch.tensor(Q),
                                            color=torch.tensor(color),
                                            assume_standard_q=standard_q)
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), v)
    assert v.any()
    _extent_close(out.points.numpy(), np.asarray(ref.points), v)
    np.testing.assert_allclose(out.colors.numpy(), np.asarray(ref.colors), rtol=1e-7)


def test_backproject_depth_and_depth_from_disparity_match():
    H, W = 24, 40
    _, _, dt, color, Q = _scene(H, W)
    z_ref = np.asarray(jmatcher.disparity_to_depth(jnp.asarray(dt), jnp.asarray(Q)))
    z = matcher.disparity_to_depth(torch.tensor(dt), torch.tensor(Q)).numpy()
    np.testing.assert_allclose(z, z_ref, rtol=1e-6)
    K = np.array([[FOCAL, 0, W / 2 - 0.5], [0, FOCAL, H / 2 - 0.5], [0, 0, 1]], np.float32)
    ref = jbp.backproject_depth(jnp.asarray(z_ref), JIntrinsics.from_matrix(K),
                                color=jnp.asarray(color), stride=2)
    intr = _state(JMatcher(), JWLS(), Q, K).intrinsics
    out = backproject.backproject_depth(torch.tensor(z_ref), intr, color=torch.tensor(color),
                                        stride=2)
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), v)
    _extent_close(out.points.numpy(), np.asarray(ref.points), v)
    np.testing.assert_allclose(out.colors.numpy(), np.asarray(ref.colors), rtol=1e-7)


@pytest.mark.parametrize("H,W,D", [(64, 128, 16), (40, 192, 32)])
def test_slice_matches_jax(H, W, D):
    """compute_disparity (tuned sgm4 + WLS) -> backproject_disparity with
    color, kernel path against the JAX Pallas path."""
    gl, gr, _, color, Q = _scene(H, W)
    mcfg, wcfg = JMatcher.tuned(num_disparities=D, backend="pallas"), JWLS()
    d_j, v_j = jmatcher.compute_disparity(jnp.asarray(gl), jnp.asarray(gr), mcfg, wcfg, True)
    pc_j = jbp.backproject_disparity(d_j, jnp.asarray(Q), color=jnp.asarray(color),
                                     assume_standard_q=True)
    d_j, v_j = np.asarray(d_j), np.asarray(v_j)

    st = _state(mcfg, wcfg, Q)
    assert st.matcher.backend == "cuda"
    d_t, v_t = matcher.compute_disparity(torch.tensor(gl), torch.tensor(gr), st.matcher,
                                         st.wls, True)
    pc_t = backproject.backproject_disparity(d_t, st.Q, color=torch.tensor(color),
                                             assume_standard_q=True)

    np.testing.assert_array_equal(v_t.numpy(), v_j)
    assert v_j.mean() > 0.5
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-4, atol=1e-3)
    pv = np.asarray(pc_j.valid)
    np.testing.assert_array_equal(pc_t.valid.numpy(), pv)
    pj, pt = np.asarray(pc_j.points), pc_t.points.numpy()
    dj = np.abs(d_j.reshape(-1, 1))[pv]
    bound = np.abs(pj[pv]) * (1e-4 + 1e-3 / dj)
    assert (np.abs(pt - pj)[pv] <= bound).all()
    np.testing.assert_allclose(pc_t.colors.numpy(), np.asarray(pc_j.colors), rtol=1e-7)
    # the backprojection alone, fed the JAX disparity, holds the 1e-5 bar
    pc_x = backproject.backproject_disparity(torch.tensor(d_j), st.Q, color=torch.tensor(color),
                                             assume_standard_q=True)
    _extent_close(pc_x.points.numpy(), pj, pv)


def test_torch_backend_matches_xla_backend():
    """backend 'torch' (the plain oracle, exact speckle labeling) against the
    JAX package's XLA backend, SGM stage: the WLS oracles are compared on
    tests/test_wls_pallas.py's bounded-contrast guide in test_torch_wls.py
    (on a full-contrast guide the floored edge weights make both solves
    ill-conditioned, and their rounding orders differ)."""
    H, W = 40, 96
    gl, gr, _, _, _ = _scene(H, W)
    mcfg = JMatcher(num_disparities=16, block_size=3, backend="xla", speckle_window_size=20)
    d_j, v_j = jmatcher.compute_disparity(jnp.asarray(gl), jnp.asarray(gr), mcfg, JWLS(), False)
    st = _state(mcfg, JWLS(), np.eye(4, dtype=np.float32))
    assert st.matcher.backend == "torch"
    d_t, v_t = matcher.compute_disparity(torch.tensor(gl), torch.tensor(gr), st.matcher,
                                         st.wls, False)
    d_j, v_j = np.asarray(d_j), np.asarray(v_j)
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    assert v_j.any() and np.abs(d_t.numpy() - d_j)[v_j].max() < 1e-4


def test_stereo_matcher_object_runs_on_the_cpu():
    H, W = 32, 128
    gl, gr, _, _, Q = _scene(H, W)
    m = matcher.StereoMatcher(config.StereoMatcherConfig(num_disparities=16, block_size=3),
                              Q=Q, device="cpu")
    m.adjust("w")
    assert m.config.num_disparities == 32
    disp, depth = m.compute(gl, gr)
    assert disp.shape == (H, W) and depth.shape == (H, W)
    assert torch.isfinite(depth).all() and (depth[disp > 0] > 0).all()


def test_auto_backend_resolves_by_device():
    """'auto' is the kernel path for CUDA tensors and the plain oracle for
    CPU tensors, as JAX's 'auto' is Pallas on a TPU and XLA elsewhere."""
    for dev, want in (("cuda", True), ("cpu", False)):
        assert matcher.uses_kernel_path("auto", torch.device(dev)) is want
        assert matcher.uses_kernel_path("cuda", torch.device(dev)) is True
        assert matcher.uses_kernel_path("torch", torch.device(dev)) is False
    with pytest.raises(ValueError, match="unknown backend"):
        matcher.uses_kernel_path("pallas", torch.device("cpu"))


def test_default_config_matches_jax_default():
    """The default StereoMatcherConfig() on CPU tensors against the JAX
    package's default on its CPU: both resolve 'auto' to their oracle (float
    cost, exact speckle labeling). SGM stage, at the SGM bar (valid equal,
    |delta| < 1e-4): the default WLS guide here is full-contrast, where both
    FGS oracles are ill-conditioned (test_torch_backend_matches_xla_backend)."""
    H, W = 48, 224
    gl, gr, _, _, _ = _scene(H, W)
    d_j, v_j = jmatcher.compute_disparity(jnp.asarray(gl), jnp.asarray(gr), JMatcher(), JWLS(),
                                          False)
    st = _state(JMatcher(), JWLS(), np.eye(4, dtype=np.float32))
    assert st.matcher == config.StereoMatcherConfig() and st.matcher.backend == "auto"
    d_t, v_t = matcher.compute_disparity(torch.tensor(gl), torch.tensor(gr), st.matcher, st.wls,
                                         False)
    d_j, v_j = np.asarray(d_j), np.asarray(v_j)
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    assert v_j.mean() > 0.3
    assert np.abs(d_t.numpy() - d_j)[v_j].max() < 1e-4
    np.testing.assert_array_equal(d_t.numpy()[~v_j], d_j[~v_j])
