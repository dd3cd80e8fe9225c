"""Port parity for calib/model.py and calib/lm.py against the JAX package on
the CPU. The JAX side runs under jax.enable_x64() where the port gets
float64 tensors, as calibration runs. Bars: pixels atol 1e-10, rotations
atol 1e-12 (float64); float32 rtol 1e-6; Jacobians (torch.func.jacfwd
against jax.jacfwd) rtol 1e-9. Also the two repairs of the model: pad_dist
keeps its input's dtype, and the sensor tilt is selected without a host
read, so jacfwd runs through project_points with dist differentiated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.calib import lm as jlm
from recon3d_tpu.calib import model as jmodel
from recon3d_tpu_torch.calib import lm, model

DIST14 = np.array([0.1, -0.05, 0.001, 0.002, 0.01, 0.02, -0.01, 0.005,
                   1e-4, -2e-4, 1e-4, 2e-4, 0.001, -0.002])
K = np.array([[600.0, 0.0, 320.0], [0.0, 610.0, 240.0], [0.0, 0.0, 1.0]])


def _dist(n, tilt=True):
    d = DIST14[:n].copy()
    if n == 14 and not tilt:
        d[12:] = 0.0
    return d


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_pad_dist_keeps_its_dtype():
    for dtype in (torch.float64, torch.float32):
        out = model.pad_dist(torch.arange(5, dtype=dtype))
        assert out.dtype == dtype and out.shape == (14,)
    assert model.pad_dist(np.arange(5.0)).dtype == torch.float64
    with jax.enable_x64():
        ref = np.asarray(jmodel.pad_dist(jnp.asarray(DIST14[:8])))
    assert ref.dtype == np.float64
    np.testing.assert_array_equal(model.pad_dist(DIST14[:8]).numpy(), ref)


def _rvecs():
    rng = np.random.RandomState(2)
    out = [rng.randn(3) / np.linalg.norm(rng.randn(3)) * rng.uniform(0, np.pi - 1e-3)
           for _ in range(20)]
    axis = np.array([1.0, 2.0, -0.5]) / np.linalg.norm([1.0, 2.0, -0.5])
    return out + [axis * 1e-13, axis * (np.pi - 1e-8), np.zeros(3) + 1e-14]


@pytest.mark.parametrize("case", ["generic", "small", "near_pi"])
def test_rodrigues_and_inverse_match(case):
    rvecs = {"generic": _rvecs()[:20], "small": _rvecs()[20:21] + _rvecs()[22:],
             "near_pi": _rvecs()[21:22]}[case]
    with jax.enable_x64():
        Rs = [np.asarray(jmodel.rodrigues(jnp.asarray(r))) for r in rvecs]
        back = [np.asarray(jmodel.inv_rodrigues(jnp.asarray(R))) for R in Rs]
    out = model.rodrigues(_t(np.stack(rvecs))).numpy()
    np.testing.assert_allclose(out, np.stack(Rs), atol=1e-12, rtol=0)
    inv = model.inv_rodrigues(_t(np.stack(Rs))).numpy()
    np.testing.assert_allclose(inv, np.stack(back), atol=1e-12, rtol=0)
    for r, R in zip(rvecs, Rs):  # a single vector as the JAX package takes it
        np.testing.assert_allclose(model.rodrigues(_t(r)).numpy(), R, atol=1e-12, rtol=0)


@pytest.mark.parametrize("n_dist", [4, 5, 8, 12, 14])
def test_project_points_match(n_dist):
    rng = np.random.RandomState(0)
    rvec, tvec = rng.randn(3) * 0.4, np.array([0.1, -0.2, 2.5])
    obj = rng.randn(100, 3) * 0.3
    dist = _dist(n_dist)
    with jax.enable_x64():
        ref = np.asarray(jmodel.project_points(jnp.asarray(obj), rvec, tvec, K, dist))
    out = model.project_points(_t(obj), _t(rvec), _t(tvec), K, _t(dist)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-10, rtol=0)
    # float32, as the JAX package computes with 64-bit floats off
    ref32 = np.asarray(jmodel.project_points(jnp.asarray(obj, jnp.float32), rvec, tvec, K, dist))
    out32 = model.project_points(_t(obj, torch.float32), _t(rvec, torch.float32),
                                 _t(tvec, torch.float32), K, _t(dist, torch.float32)).numpy()
    assert out32.dtype == np.float32
    np.testing.assert_allclose(out32, ref32, rtol=1e-6)
    # no distortion at all
    with jax.enable_x64():
        ref0 = np.asarray(jmodel.project_points(jnp.asarray(obj), rvec, tvec, K))
    np.testing.assert_allclose(model.project_points(_t(obj), _t(rvec), _t(tvec), K).numpy(),
                               ref0, atol=1e-10, rtol=0)


def test_project_points_batched_views_match_one_by_one():
    rng = np.random.RandomState(5)
    obj = rng.randn(4, 30, 3) * 0.2 + [0, 0, 2.0]
    rv, tv = rng.randn(4, 3) * 0.3, rng.randn(4, 3) * 0.1
    out = model.project_points(_t(obj), _t(rv), _t(tv), K, _t(DIST14[:5])).numpy()
    for v in range(4):
        one = model.project_points(_t(obj[v]), _t(rv[v]), _t(tv[v]), K, _t(DIST14[:5])).numpy()
        np.testing.assert_allclose(out[v], one, atol=1e-12, rtol=0)


@pytest.mark.parametrize("n_dist,tilt", [(5, False), (14, False), (14, True)])
def test_undistort_points_match(n_dist, tilt):
    rng = np.random.RandomState(1)
    pix = rng.rand(200, 2) * [640, 480]
    dist = _dist(n_dist, tilt)
    R = np.asarray(model.rodrigues(_t([0.01, -0.02, 0.005])))
    P = np.array([[580.0, 0, 300.0, 0], [0, 580.0, 250.0, 0], [0, 0, 1.0, 0]])
    with jax.enable_x64():
        ref = np.asarray(jmodel.undistort_points(jnp.asarray(pix), K, dist, iters=20))
        ref_rp = np.asarray(jmodel.undistort_points(jnp.asarray(pix), K, dist, R=R, P=P))
        ref_d = np.asarray(jmodel.distort_normalized(jnp.asarray(ref), dist))
    out = model.undistort_points(_t(pix), K, _t(dist), iters=20).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-10, rtol=0)
    np.testing.assert_allclose(model.undistort_points(_t(pix), K, _t(dist), R=R, P=P).numpy(),
                               ref_rp, atol=1e-10, rtol=0)
    np.testing.assert_allclose(model.distort_normalized(_t(ref), _t(dist)).numpy(), ref_d,
                               atol=1e-12, rtol=0)


def test_reprojection_errors_match():
    rng = np.random.RandomState(3)
    obj = rng.randn(60, 3) * 0.2
    rvec, tvec = rng.randn(3) * 0.2, np.array([0.0, 0.1, 1.5])
    with jax.enable_x64():
        px = np.asarray(jmodel.project_points(jnp.asarray(obj), rvec, tvec, K, DIST14[:5]))
        img = px + rng.randn(*px.shape) * 0.3
        ref = [float(v) for v in jmodel.reprojection_errors(jnp.asarray(obj), jnp.asarray(img),
                                                            rvec, tvec, K, DIST14[:5])]
    out = model.reprojection_errors(_t(obj), _t(img), _t(rvec), _t(tvec), K, _t(DIST14[:5]))
    np.testing.assert_allclose([float(v) for v in out], ref, rtol=1e-12)


@pytest.mark.parametrize("n_dist,tilt", [(5, False), (14, False), (14, True)])
def test_jacfwd_runs_through_project_points_with_dist(n_dist, tilt):
    """The parameter vector carries dist, as mono calibration's does: the
    tilt is selected without reading a tensor value on the host. Where the
    tilt is zero the derivative in tau is zero, as under JAX's lax.cond."""
    rng = np.random.RandomState(4)
    obj = rng.randn(20, 3) * 0.2
    rvec, tvec = rng.randn(3) * 0.3, np.array([0.05, -0.02, 1.2])
    x0 = np.concatenate([rvec, tvec, _dist(n_dist, tilt)])

    def port(x):
        return model.project_points(_t(obj), x[:3], x[3:6], K, x[6:]).reshape(-1)

    def jaxf(x):
        return jmodel.project_points(jnp.asarray(obj), x[:3], x[3:6], K, x[6:]).ravel()

    J = torch.func.jacfwd(port)(_t(x0)).numpy()
    with jax.enable_x64():
        Jref = np.asarray(jax.jacfwd(jaxf)(jnp.asarray(x0)))
    assert J.shape == Jref.shape == (40, 6 + n_dist)
    np.testing.assert_allclose(J, Jref, rtol=1e-9, atol=1e-9 * np.abs(Jref).max())
    if n_dist == 14 and not tilt:
        assert not J[:, -2:].any()


def _curve():
    rng = np.random.RandomState(6)
    t = np.linspace(0, 2, 40)
    y = 2.5 * np.exp(-1.3 * t) + 0.4 + rng.randn(40) * 0.01
    return t, y


@pytest.mark.parametrize("mask", [None, [True, False, True]])
def test_levenberg_marquardt_and_gauss_newton_match(mask):
    t, y = _curve()
    x0 = np.array([1.0, -0.5, 0.0])
    with jax.enable_x64():
        jres = jlm.levenberg_marquardt(
            lambda x: x[0] * jnp.exp(x[1] * jnp.asarray(t)) + x[2] - jnp.asarray(y),
            jnp.asarray(x0), mask=None if mask is None else jnp.asarray(mask))
        jgn = np.asarray(jlm.gauss_newton(
            lambda x: x[0] * jnp.exp(x[1] * jnp.asarray(t)) + x[2] - jnp.asarray(y),
            jnp.asarray([2.0, -1.0, 0.3]), iterations=8))
    res = lm.levenberg_marquardt(lambda x: x[0] * torch.exp(x[1] * _t(t)) + x[2] - _t(y),
                                 _t(x0), mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(res.cost), float(jres.cost), rtol=1e-9)
    np.testing.assert_allclose(float(res.rms), float(jres.rms), rtol=1e-9)
    if mask is not None:
        assert res.x[1] == x0[1]
    gn = lm.gauss_newton(lambda x: x[0] * torch.exp(x[1] * _t(t)) + x[2] - _t(y),
                         _t([2.0, -1.0, 0.3]), iterations=8)
    np.testing.assert_allclose(gn.numpy(), jgn, rtol=1e-9)


def test_numpy_inputs_go_to_the_card_unless_told():
    """The calibration entry points (calibrate_camera, solve_pnp,
    stereo_calibrate, stereo_rectify, corner_subpix) run where their
    tensors are, numpy inputs on the card, or on `device`."""
    assert model._device_of(np.zeros(3), [1.0]) == torch.device("cuda")
    assert model._device_of(np.zeros(3), torch.zeros(2)) == torch.device("cpu")
    assert model._device_of(torch.zeros(2), device="cuda:0") == torch.device("cuda", 0)
