"""Port parity for depth/filters.py against the JAX package's EAGER calls on
the CPU (each JAX filter is itself jitted), on 160x120 SyntheticRGBDCamera
depth frames with seeded noise and dropouts. Bars and the largest
differences measured:
  decimation, _fill_left, _fill_nearest, hole filling, temporal: exact
  (bitwise, measured 0);
  spatial_filter: exact (asked atol 1e-6; measured 0 at alpha 0.5, 0.37 and
  0.8): the port rounds alpha * col + (1 - alpha) * prev as XLA's CPU code
  contracts it, fma(alpha, col, (1 - alpha) * prev); the temporal blend
  likewise;
  DepthFilterBank over 4 frames, the temporal state carried: exact; a
  numpy frame goes to the bank's device (the card unless told otherwise).
The JAX bank under `jax.jit` freezes its temporal state at trace time (a
reference-side behaviour): `test_bank_under_jax_jit_freezes_the_temporal_state`
records it.
"""
import jax
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import SyntheticRGBDCamera
from recon3d_tpu.depth import filters as jfilters
from recon3d_tpu_torch.depth import filters


@pytest.fixture(scope="module")
def frames():
    cam = SyntheticRGBDCamera(width=160, height=120, fx=130.0, fy=130.0, n_frames=4, step=0.01)
    cam.open()
    rng = np.random.RandomState(0)
    out = []
    for _ in range(4):
        _, d = cam.grab()
        d = d + rng.randn(*d.shape).astype(np.float32) * 0.005
        d[rng.rand(*d.shape) < 0.1] = 0.0
        out.append(d.astype(np.float32))
    return out


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("magnitude", [1, 2, 3])
def test_decimation_matches_jax(frames, magnitude):
    _eq(filters.decimation_filter(torch.tensor(frames[0]), magnitude),
        jfilters.decimation_filter(frames[0], magnitude=magnitude))


@pytest.mark.parametrize("alpha,delta,iterations", [(0.5, 0.02, 2), (0.37, 0.02, 1),
                                                    (0.8, 0.05, 2)])
def test_spatial_filter_matches_jax(frames, alpha, delta, iterations):
    _eq(filters.spatial_filter(torch.tensor(frames[1]), alpha, delta, iterations),
        jfilters.spatial_filter(frames[1], alpha, delta, iterations=iterations))


@pytest.mark.parametrize("mode", ["left", "nearest"])
def test_hole_filling_matches_jax(frames, mode):
    d = frames[2].copy()
    d[:, :7] = 0.0  # rows that start invalid stay 0 under 'left'
    _eq(filters.hole_filling_filter(torch.tensor(d), mode),
        jfilters.hole_filling_filter(d, mode=mode))
    _eq(filters._fill_left(torch.tensor(d)), jax.jit(jfilters._fill_left)(d))
    _eq(filters._fill_nearest(torch.tensor(d), 3), jfilters._fill_nearest(d, 3))
    with pytest.raises(ValueError, match="unknown hole-filling mode"):
        filters.hole_filling_filter(torch.tensor(d), "median")


@pytest.mark.parametrize("persistence", [3, 0])
def test_temporal_filter_matches_jax_over_frames(frames, persistence):
    js = jfilters.make_temporal_state(frames[0].shape)
    ps = filters.make_temporal_state(frames[0].shape, device="cpu")
    for d in frames:
        jo, js = jfilters.temporal_filter(d, js, 0.4, 0.02, persistence=persistence)
        po, ps = filters.temporal_filter(torch.tensor(d), ps, 0.4, 0.02, persistence)
        _eq(po, jo)
        _eq(ps.history, js.history)
        _eq(ps.age, js.age)
        assert ps.age.dtype == torch.int32


@pytest.mark.parametrize("kw", [{}, {"decimation": 2, "hole_fill": "nearest"},
                                {"spatial": False, "temporal_alpha": 0.3}])
def test_filter_bank_matches_jax_eager(frames, kw):
    jb, pb = jfilters.DepthFilterBank(**kw), filters.DepthFilterBank(**kw)
    for d in frames:
        _eq(pb(torch.tensor(d)), jb(d))
    _eq(pb._state.history, jb._state.history)
    pb.reset()
    assert pb._state is None


def test_filter_bank_puts_numpy_frames_on_its_device(frames):
    """A frame that is not a tensor goes to the bank's `device`, as the JAX
    bank's jnp.asarray puts it on the accelerator; the default is the card,
    and without one that raises instead of filtering on the host. A tensor
    is filtered where it lies. Bar: exact against the tensor-fed bank."""
    host = filters.DepthFilterBank(decimation=2, device="cpu")
    fed = filters.DepthFilterBank(decimation=2)
    for d in frames:
        got = host(d)
        assert got.device.type == "cpu" and got.dtype == torch.float32
        _eq(got, fed(torch.tensor(d)).numpy())
    assert host._state.history.device.type == "cpu"
    assert filters.DepthFilterBank().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            filters.DepthFilterBank()(frames[0])


def test_bank_under_jax_jit_freezes_the_temporal_state():
    """Under jax.jit the JAX bank's temporal state is the value it had when
    the call was traced: a dropout is not filled from history (0 where the
    eager bank reads 1.0), an in-range change is not blended (1.01 where
    eager reads 0.4 * 1.01 + 0.6 * 1.0 = 1.004), and the bank is left
    holding a tracer. The JAX streaming step calls its filters inside jit
    (streaming.py:335-336), so there the temporal stage only zeroes invalid
    pixels; the port's step is not traced and follows the eager bank."""
    first = np.ones((4, 4), np.float32)
    second = first.copy()
    second[0, 0] = 0.0    # a dropout
    second[1, 1] = 1.01   # an in-range change
    kw = dict(spatial=False, hole_fill=None)

    jitted = jfilters.DepthFilterBank(**kw)
    f = jax.jit(lambda d: jitted(d))
    f(first)
    frozen = np.asarray(f(second))
    assert frozen[0, 0] == 0.0 and frozen[1, 1] == np.float32(1.01)
    assert isinstance(jitted._state.history, jax.core.Tracer)

    eager = jfilters.DepthFilterBank(**kw)
    eager(first)
    ref = np.asarray(eager(second))
    assert ref[0, 0] == 1.0 and abs(ref[1, 1] - 1.004) < 1e-6

    port = filters.DepthFilterBank(**kw)
    port(torch.tensor(first))
    _eq(port(torch.tensor(second)), ref)
