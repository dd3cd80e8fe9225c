"""Port parity: WLS / Fast Global Smoother (recon3d_tpu_torch.depth.wls and
wls_cuda) against the JAX package on the CPU.

The JAX Pallas solver runs in interpret mode; the port's kernel wrapper
(tridiag_solve, kernel K6) runs its plain PyTorch version on CPU tensors.
The smoother's settings come from the JAX WLSConfig and, for the port,
its carry-over through recon3d_tpu_torch.convert.
Bar: rtol 1e-4, atol 1e-3, the JAX package's own Pallas-vs-XLA bar
(tests/test_wls_pallas.py:36): the Thomas recurrences round in another
order (reciprocal-multiply vs divide), nothing more.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.config import StereoMatcherConfig, WLSConfig
from recon3d_tpu.depth import wls as jwls
from recon3d_tpu.depth import wls_pallas
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.depth import wls as twls
from recon3d_tpu_torch.depth import wls_cuda

TOL = dict(rtol=1e-4, atol=1e-3)


def _settings(iterations):
    """(lam, sigma_color, iterations) of the JAX config and of the port's."""
    jw = WLSConfig(iterations=iterations)
    tw = convert.convert_state(dataclasses.asdict(StereoMatcherConfig()),
                               dataclasses.asdict(jw), np.eye(4), device="cpu").wls
    return ((jw.lam, jw.sigma_color, jw.iterations), (tw.lam, tw.sigma_color, tw.iterations))


def _fixture(H=40, W=56, seed=0):
    """Bounded-contrast guide, as tests/test_wls_pallas.py builds it."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    guide = 2.0 * xx + 1.5 * yy + rng.rand(H, W).astype(np.float32) * 10
    data = (rng.rand(H, W) * 64).astype(np.float32)
    conf = (rng.rand(H, W) > 0.3).astype(np.float32)
    return data, guide, conf


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("color", [False, True])
def test_edge_weights_match(axis, color):
    rng = np.random.RandomState(1)
    guide = rng.rand(24, 32, 3) * 20 if color else rng.rand(24, 32) * 20
    guide = guide.astype(np.float32)
    ref = np.asarray(jwls._edge_weights(jnp.asarray(guide), axis, 1.5))
    out = twls._edge_weights(torch.tensor(guide), axis, 1.5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)
    assert out.shape == guide.shape[:2]


def test_lambda_schedule_is_f32_of_the_jax_schedule():
    lam, T = 8000.0, 3
    ref = [np.float32(lam) * np.float32(1.5 * 4 ** (T - t - 1) / (4 ** T - 1)) for t in range(T)]
    assert twls.lambda_schedule(lam, T) == [float(v) for v in ref]


@pytest.mark.parametrize("axis", [0, 1])
def test_tridiag_solve_matches_pallas_solve(axis):
    """K6 plain version against wls_pallas._solve (one solve along dim 0;
    the horizontal solve is the transposed plane)."""
    data, guide, conf = _fixture(H=40, W=56, seed=2)
    w = np.asarray(jwls._edge_weights(jnp.asarray(guide), axis, 1.5))
    lt = 500.0
    if axis == 0:
        ref = np.asarray(wls_pallas._solve(jnp.asarray(w), jnp.asarray(conf), jnp.asarray(data),
                                           lt, True))
    else:
        ref = np.asarray(wls_pallas._solve(jnp.asarray(w.T), jnp.asarray(conf.T),
                                           jnp.asarray(data.T), lt, True)).T
    out = wls_cuda._solve(torch.tensor(w), torch.tensor(conf), torch.tensor(data), lt, axis)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_fast_global_smoother_cuda_matches_pallas():
    data, guide, conf = _fixture()
    js, ts = _settings(3)
    ref = np.asarray(wls_pallas.fast_global_smoother_pallas(
        jnp.asarray(data), jnp.asarray(guide), jnp.asarray(conf), *js, interpret=True))
    out = wls_cuda.fast_global_smoother_cuda(torch.tensor(data), torch.tensor(guide),
                                             torch.tensor(conf), *ts)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_fast_global_smoother_oracle_matches_xla():
    data, guide, conf = _fixture(seed=1)
    js, ts = _settings(3)
    ref = np.asarray(jwls.fast_global_smoother(jnp.asarray(data), jnp.asarray(guide),
                                               jnp.asarray(conf), *js))
    out = twls.fast_global_smoother(torch.tensor(data), torch.tensor(guide),
                                    torch.tensor(conf), *ts)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("iterations", [2, 3])
def test_wls_refine_twins(iterations):
    data, guide, conf = _fixture(seed=3)
    valid = conf > 0.5
    js, ts = _settings(iterations)
    ref = np.asarray(wls_pallas.wls_refine_pallas(
        jnp.asarray(data), jnp.asarray(valid), jnp.asarray(guide), *js, interpret=True))
    out = wls_cuda.wls_refine_cuda(torch.tensor(data), torch.tensor(valid),
                                   torch.tensor(guide), *ts)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    ref_xla = np.asarray(jwls.wls_refine(jnp.asarray(data), jnp.asarray(valid),
                                         jnp.asarray(guide), *js))
    oracle = twls.wls_refine(torch.tensor(data), torch.tensor(valid), torch.tensor(guide),
                             *ts)
    np.testing.assert_allclose(oracle.numpy(), ref_xla, **TOL)


def test_hole_filling_diffuses():
    data, guide, _ = _fixture(seed=5)
    conf = np.ones((40, 56), np.float32)
    conf[15:25, 20:30] = 0.0
    data[15:25, 20:30] = 0.0
    out = wls_cuda.fast_global_smoother_cuda(torch.tensor(data), torch.tensor(guide),
                                             torch.tensor(conf), iterations=3).numpy()
    hole = out[17:23, 22:28]
    assert np.isfinite(hole).all()
    assert (np.abs(hole) > 1e-3).mean() > 0.9, "hole did not in-fill"


def test_tridiag_solve_checks_arguments():
    plane = torch.ones((8, 8))
    with pytest.raises(ValueError):
        wls_cuda.tridiag_solve(plane, plane, plane, plane, axis=2)
    with pytest.raises(ValueError):
        wls_cuda.tridiag_solve(plane, plane, plane, plane.to("meta"), axis=0)
    with pytest.raises(ValueError):
        wls_cuda.tridiag_solve(plane, plane[:4], plane, plane, axis=0)
