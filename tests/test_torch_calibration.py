"""Port parity for calib/mono.py and calib/stereo.py (stereo_calibrate,
stereo_rectify) against the JAX package on the CPU, on seeded 9x6 board
views of a distorted stereo rig (tests/_calib_data.py: 5 views, 0.05 px
noise). The JAX side runs once per module under jax.enable_x64(); the
port gets float64 tensors. Each stage is fed the JAX package's inputs
(stereo_calibrate the JAX intrinsics, through convert.calibration_result).

Bars: DLT homographies and Zhang's K rtol 1e-9; calibrate_camera (each fix
flag), solve_pnp and stereo_calibrate: parameters within 1e-6 relative, R
within 1e-8, rms within 1e-8 relative; stereo_rectify in float64 rtol 1e-9
(alpha -1, 0, 0.5, 1; zero_disparity both ways; a vertical rig), in
float32 (the JAX package with 64-bit floats off) rtol 2e-6. The LM stops on
a relative cost change below 1e-12, so where it stops is decided by
rounding: the parameters and rms are held, and the iteration counts are
reported by the phase on the card, not compared here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.calib import mono as jmono
from recon3d_tpu.calib import stereo as jstereo
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.calib import mono, stereo
from tests import _calib_data as cd

V = 5
FLAGS = {"none": {}, "fix_principal_point": {"fix_principal_point": True},
         "fix_aspect_ratio": {"fix_aspect_ratio": True},
         "zero_tangent_dist": {"zero_tangent_dist": True}}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


@pytest.fixture(scope="module")
def views():
    return cd.stereo_views(V, seed=0)


@pytest.fixture(scope="module")
def jax_mono(views):
    objs, left, _ = views
    with jax.enable_x64():
        out = {name: _np(jmono.calibrate_camera(jnp.asarray(objs), jnp.asarray(left), cd.SIZE,
                                                **kw))
               for name, kw in FLAGS.items()}
        Hs = np.asarray(jax.vmap(jmono.find_homography_dlt)(jnp.asarray(objs[..., :2]),
                                                            jnp.asarray(left)))
        out["Hs"] = Hs
        out["K_zhang"] = np.asarray(jmono._zhang_intrinsics(jnp.asarray(Hs)))
        rv, tv = jax.vmap(jmono._extrinsics_from_homography, in_axes=(0, None))(
            jnp.asarray(Hs), jnp.asarray(out["K_zhang"]))
        out["ext"] = (np.asarray(rv), np.asarray(tv))
        out["pnp"] = [np.asarray(a) for a in jmono.solve_pnp(jnp.asarray(objs[0]),
                                                             jnp.asarray(left[0]), cd.K1, cd.D1)]
        out["pnp_nodist"] = [np.asarray(a) for a in jmono.solve_pnp(
            jnp.asarray(objs[1]), jnp.asarray(left[1]), cd.K1)]
    return out


@pytest.fixture(scope="module")
def jax_stereo(views, jax_mono):
    objs, left, right = views
    with jax.enable_x64():
        jr = jmono.calibrate_camera(jnp.asarray(objs), jnp.asarray(right), cd.SIZE)
        jl = jax_mono["none"]
        res = jstereo.stereo_calibrate(jnp.asarray(objs), jnp.asarray(left), jnp.asarray(right),
                                       jl["K"], jl["dist"], jr.K, jr.dist)
    return _np(jr), _np(res)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _close(out, ref, what):
    """Parameters within 1e-6 relative (of the array's magnitude)."""
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=1e-6 * max(np.abs(ref).max(), 1e-12), err_msg=what)


def test_homography_zhang_and_extrinsics_match(views, jax_mono):
    objs, left, _ = views
    Hs = mono.find_homography_dlt(_t(objs[..., :2]), _t(left))
    np.testing.assert_allclose(Hs.numpy(), jax_mono["Hs"], rtol=1e-9, atol=1e-12)
    K = mono._zhang_intrinsics(_t(jax_mono["Hs"]))
    np.testing.assert_allclose(K.numpy(), jax_mono["K_zhang"], rtol=1e-9, atol=1e-12)
    rv, tv = mono._extrinsics_from_homography(_t(jax_mono["Hs"]), _t(jax_mono["K_zhang"]))
    np.testing.assert_allclose(rv.numpy(), jax_mono["ext"][0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(tv.numpy(), jax_mono["ext"][1], rtol=0, atol=1e-9)
    # one view as the JAX package takes it (no batch axis)
    np.testing.assert_allclose(mono.find_homography_dlt(_t(objs[0, :, :2]), _t(left[0])).numpy(),
                               jax_mono["Hs"][0], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("flag", list(FLAGS))
def test_calibrate_camera_matches(views, jax_mono, flag):
    objs, left, _ = views
    ref = jax_mono[flag]
    res = mono.calibrate_camera(_t(objs), _t(left), cd.SIZE, **FLAGS[flag])
    for k in ("K", "dist", "tvecs", "per_view_errors"):
        _close(getattr(res, k), ref[k], f"{flag}: {k}")
    np.testing.assert_allclose(res.rvecs.numpy(), ref["rvecs"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(res.rms), float(ref["rms"]), rtol=1e-8)
    if flag == "fix_principal_point":
        np.testing.assert_allclose(res.K[:2, 2].numpy(), jax_mono["K_zhang"][:2, 2], rtol=1e-9)
    if flag == "zero_tangent_dist":
        np.testing.assert_array_equal(res.dist[2:4].numpy(), 0.0)


def test_solve_pnp_matches(views, jax_mono):
    objs, left, _ = views
    rv, tv = mono.solve_pnp(_t(objs[0]), _t(left[0]), cd.K1, cd.D1)
    np.testing.assert_allclose(rv.numpy(), jax_mono["pnp"][0], rtol=0, atol=1e-8)
    _close(tv, jax_mono["pnp"][1], "tvec")
    rv, tv = mono.solve_pnp(_t(objs[1]), _t(left[1]), cd.K1)
    np.testing.assert_allclose(rv.numpy(), jax_mono["pnp_nodist"][0], rtol=0, atol=1e-8)
    _close(tv, jax_mono["pnp_nodist"][1], "tvec without distortion")


def test_stereo_calibrate_matches(views, jax_mono, jax_stereo):
    objs, left, right = views
    jr, ref = jax_stereo
    cl = convert.calibration_result(jax_mono["none"], device="cpu")
    cr = convert.calibration_result(jr, device="cpu")
    assert cl.K.dtype == torch.float64
    res = stereo.stereo_calibrate(_t(objs), _t(left), _t(right), cl.K, cl.dist, cr.K, cr.dist)
    np.testing.assert_allclose(res.R.numpy(), ref["R"], rtol=0, atol=1e-8)
    for k in ("T", "E", "F", "per_view_errors"):
        _close(getattr(res, k), ref[k], k)
    np.testing.assert_allclose(float(res.rms), float(ref["rms"]), rtol=1e-8)
    back = convert.stereo_calibration_result(ref, device="cpu")
    assert back._fields == res._fields and torch.equal(back.R, torch.as_tensor(ref["R"]))


def _rectify_cases():
    cases = [(a, z, "horizontal") for a in (-1.0, 0.0, 0.5, 1.0) for z in (True, False)]
    return cases + [(-1.0, True, "vertical"), (0.5, False, "vertical")]


@pytest.mark.parametrize("alpha,zero_disparity,rig", _rectify_cases())
def test_stereo_rectify_matches_float64(jax_stereo, alpha, zero_disparity, rig):
    jr, sres = jax_stereo
    R, T = sres["R"], sres["T"]
    if rig == "vertical":  # the baseline along y: idx = 1
        T = np.array([0.002, -0.07, 0.001])
    args = (cd.K1, cd.D1, jr["K"], jr["dist"], cd.SIZE, R, T)
    with jax.enable_x64():
        ref = _np(jstereo.stereo_rectify(*args, zero_disparity=zero_disparity, alpha=alpha))
    out = stereo.stereo_rectify(*args, zero_disparity=zero_disparity, alpha=alpha, device="cpu")
    for k, v in out._asdict().items():
        assert v.dtype == torch.float64
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=1e-9, atol=1e-9 * np.abs(ref[k]).max(),
                                   err_msg=k)
    back = convert.rectify_result(ref, device="cpu")
    assert back._fields == out._fields


@pytest.mark.parametrize("rig", ["horizontal", "vertical"])
def test_stereo_rectify_matches_float32(jax_stereo, rig):
    """64-bit floats off in the JAX package: the NPZ's arrays become float32
    (the depth path's raw-schema rectification). XLA's float32 sin / cos /
    arccos are its own approximations, so within a few ulps."""
    jr, sres = jax_stereo
    T = sres["T"] if rig == "horizontal" else np.array([0.002, -0.07, 0.001])
    f32 = [np.asarray(a, np.float32) for a in (cd.K1, cd.D1, jr["K"], jr["dist"], sres["R"], T)]
    ref = _np(jstereo.stereo_rectify(*f32[:4], cd.SIZE, *f32[4:]))
    out = stereo.stereo_rectify(*f32[:4], cd.SIZE, *f32[4:], device="cpu")
    for k, v in out._asdict().items():
        assert v.dtype == torch.float32 and ref[k].dtype == np.float32
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=2e-6, atol=2e-6 * np.abs(ref[k]).max(),
                                   err_msg=k)
