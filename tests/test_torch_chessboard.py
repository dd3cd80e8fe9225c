"""Port parity for calib/chessboard.py and the image ops it uses
(ops/image.py: histogram_equalize, sobel, resize_bilinear) against the JAX
package on the CPU. Bars: histogram_equalize exact (integer counts, both
roundings half to even); sobel atol 1e-4 (the port sums the taps exactly
and rounds once, XLA's convolution in an order of its own: measured 9.2e-5
on 0-255 noise); resize_bilinear atol 1e-5 (bitwise: both round each
operation, as the JAX function runs outside jit); corner_subpix within
1e-3 px of the JAX package's on a rendered board (tests/_calib_data.py).

The built-in detector finds no board in either package: it scores saddles
as sxy^2 - sxx * syy of Gaussian-weighted gradient products, which is <= 0
everywhere (Cauchy-Schwarz), so its threshold 0.2 * max keeps only rounding
noise (on test_calib_gui.py's clean board the response's maximum is
4.66e-10 against a minimum of -5.93e9 in the JAX package), and fewer than
9 x 6 candidates survive the non-maximum suppression. The port keeps that
behaviour; without OpenCV, detector="opencv" takes the same path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.calib import chessboard as jcb
from recon3d_tpu.ops import image as jim
from recon3d_tpu_torch.calib import chessboard as cb
from recon3d_tpu_torch.ops import image as im
from tests import _calib_data as cd
from tests.test_calib_gui import _chessboard_image


def _noise(shape=(48, 64), seed=0):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(np.float32)


@pytest.fixture(scope="module")
def board():
    """A perspective view of the board at 640x480: (gray, true corners)."""
    rvec, tvec = np.array([0.3, -0.25, 0.05]), np.array([-0.1, -0.06, 0.45])
    gray = cd.render_board(cd.K1, cd.D1, rvec, tvec)
    return gray, cd.project(cd.obj_points(), rvec, tvec, cd.K1, cd.D1)


@pytest.mark.parametrize("kind", ["noise", "board", "constant", "narrow"])
def test_histogram_equalize_exact(kind, board):
    g = {"noise": _noise(), "board": board[0].astype(np.float32),
         "constant": np.full((20, 30), 77.0, np.float32),
         "narrow": 100.0 + _noise(seed=1) / 40.0}[kind]
    ref = np.asarray(jim.histogram_equalize(jnp.asarray(g)))
    out = im.histogram_equalize(torch.as_tensor(g))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("kind", ["noise", "board"])
def test_sobel_matches(kind, board):
    g = _noise() if kind == "noise" else board[0].astype(np.float32)
    for o, r in zip(im.sobel(torch.as_tensor(g)), jim.sobel(jnp.asarray(g))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-4)


@pytest.mark.parametrize("out_hw", [(30, 50), (70, 90), (48, 64), (17, 128)])
def test_resize_bilinear_matches(out_hw):
    g = _noise()
    ref = np.asarray(jim.resize_bilinear(jnp.asarray(g), out_hw))
    out = im.resize_bilinear(torch.as_tensor(g), out_hw).numpy()
    assert out.shape == out_hw
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_preprocess_matches(board):
    g = board[0].astype(np.float32)
    ref = np.asarray(jcb.preprocess(jnp.asarray(g)))
    np.testing.assert_allclose(cb.preprocess(torch.as_tensor(g)).numpy(), ref, rtol=0, atol=1e-4)


def test_corner_subpix_matches(board):
    gray, truth = board
    init = (truth + np.random.RandomState(3).uniform(-0.75, 0.75, truth.shape)).astype(np.float32)
    ref = np.asarray(jcb.corner_subpix(jnp.asarray(gray, jnp.float32), jnp.asarray(init)))
    out = cb.corner_subpix(torch.as_tensor(gray).to(torch.float32), torch.as_tensor(init))
    assert out.dtype == torch.float32 and out.shape == init.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)
    err = np.linalg.norm(out.numpy() - truth, axis=-1)
    assert np.median(err) < 0.1 < np.median(np.linalg.norm(init - truth, axis=-1))


def test_native_detector_finds_no_board(board):
    gui = _chessboard_image()
    for img in (gui, gui[..., 0], board[0]):
        assert jcb.find_chessboard_corners(img, cd.PATTERN, detector="native") == (False, None)
        for detector in ("native", "opencv"):
            assert cb.find_chessboard_corners(img, cd.PATTERN, detector=detector,
                                              device="cpu") == (False, None)
    # the cause: the saddle response is <= 0 up to rounding
    g = im.gaussian_blur(torch.as_tensor(gui[..., 0], dtype=torch.float32), 5, 1.5)
    gx, gy = im.sobel(g)
    sxx, syy, sxy = (im.gaussian_blur(a, 7, 2.0) for a in (gx * gx, gy * gy, gx * gy))
    resp = sxy * sxy - sxx * syy
    assert float(resp.max()) <= 1e-6 * float(-resp.min())


def test_chessboard_object_points_equal():
    np.testing.assert_array_equal(cb.chessboard_object_points((9, 6), 0.04),
                                  jcb.chessboard_object_points((9, 6), 0.04))
