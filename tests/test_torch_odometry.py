"""Port parity for ops/image.py's odometry ops (`gaussian_blur`,
`central_gradients`, `pyramid`, `sweep_bilinear_stack`) and
registration/odometry.py against the JAX package on the CPU, on seeded
images and SyntheticRGBDCamera frames (160x120 and 320x240). Bars and the
largest differences measured:
  image ops: atol 1e-5 (blur and pyramid 1.2e-7: the taps summed in
  another order; gradients bitwise; the sweep 1.2e-7);
  compute_rgbd_odometry, "gather" and "sweep": transform atol 1e-4
  (measured 1.2e-7), success equal, inlier_fraction rtol 1e-5 (measured
  6.4e-8: one pixel's share at 160x120 is 5.2e-5, so no pixel flips),
  information rtol 1e-4 of its largest entry (measured 8.8e-7); "auto"
  is "gather" in the port (the card gathers); the sweep runs with a
  12-pixel bound (12 / 6 / 4 a level) to keep the JAX package's unrolled
  sweep's compile short.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu.camera.fake import SyntheticRGBDCamera as JSyntheticRGBDCamera
from recon3d_tpu.ops import image as jimage
from recon3d_tpu.registration.odometry import compute_rgbd_odometry as jodometry
from recon3d_tpu.utils import types as jtypes
from recon3d_tpu_torch import convert
from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
from recon3d_tpu_torch.ops import image
from recon3d_tpu_torch.registration.odometry import compute_rgbd_odometry


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, ref, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("shape,ksize,sigma", [((120, 160), 5, 1.0), ((40, 50, 3), 5, 0.0),
                                               ((31, 17), 7, 1.5)])
def test_gaussian_blur_matches_jax(shape, ksize, sigma):
    img = np.random.RandomState(0).rand(*shape).astype(np.float32)
    _close(image.gaussian_blur(torch.tensor(img), ksize, sigma),
           jimage.gaussian_blur(img, ksize, sigma))


def test_central_gradients_and_pyramid_match_jax():
    img = np.random.RandomState(1).rand(120, 160).astype(np.float32)
    for got, ref in zip(image.central_gradients(torch.tensor(img)),
                        jax.jit(jimage.central_gradients)(img)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    levels = image.pyramid(torch.tensor(img), 3)
    refs = jimage.pyramid(img, 3)
    assert [tuple(t.shape) for t in levels] == [r.shape for r in refs]
    for got, ref in zip(levels, refs):
        _close(got, ref)


@pytest.mark.parametrize("bound", [3, 6])
def test_sweep_bilinear_stack_matches_jax(bound):
    rng = np.random.RandomState(2)
    stack = rng.rand(6, 60, 80).astype(np.float32)
    yy, xx = np.mgrid[0:60, 0:80].astype(np.float32)
    x = xx + rng.randn(60, 80).astype(np.float32) * 3 + 2
    y = yy + rng.randn(60, 80).astype(np.float32) * 2 - 1
    ref = jax.jit(jimage.sweep_bilinear_stack, static_argnums=(3, 4))(stack, x, y, bound, bound)
    _close(image.sweep_bilinear_stack(torch.tensor(stack), torch.tensor(x), torch.tensor(y),
                                      bound, bound), ref)


def test_synthetic_camera_frames_match_jax():
    a = JSyntheticRGBDCamera(width=160, height=120, fx=130.0, fy=130.0, step=0.02)
    b = SyntheticRGBDCamera(width=160, height=120, fx=130.0, fy=130.0, step=0.02)
    a.open()
    b.open()
    for _ in range(2):
        for x, y in zip(a.grab(), b.grab()):
            np.testing.assert_array_equal(x, y)


def _frames(w, h, f):
    cam = SyntheticRGBDCamera(width=w, height=h, fx=f, fy=f, n_frames=4, step=0.02)
    cam.open()
    return cam, cam.grab(), cam.grab()


@pytest.mark.parametrize("size,warp", [((160, 120, 130.0), "gather"), ((320, 240, 260.0), "gather"),
                                       ((160, 120, 130.0), "sweep")])
def test_rgbd_odometry_matches_jax(size, warp):
    w, h, f = size
    cam, (c0, d0), (c1, d1) = _frames(w, h, f)
    cx, cy = w / 2 - 0.5, h / 2 - 0.5
    jintr = jtypes.CameraIntrinsics(fx=jnp.float32(f), fy=jnp.float32(f), cx=jnp.float32(cx),
                                    cy=jnp.float32(cy))
    kw = dict(warp=warp, sweep_bound=12)
    a = jodometry(jtypes.RGBDImage(color=jnp.asarray(c0), depth=jnp.asarray(d0)),
                  jtypes.RGBDImage(color=jnp.asarray(c1), depth=jnp.asarray(d1)), jintr, **kw)
    b = compute_rgbd_odometry(convert.rgbd_image(c0, d0, device="cpu"),
                              convert.rgbd_image(c1, d1, device="cpu"),
                              convert.camera_intrinsics(f, f, cx, cy), **kw)
    _close(b.transformation, a.transformation, atol=1e-4)
    assert bool(b.success) == bool(a.success)
    np.testing.assert_allclose(float(b.inlier_fraction), float(a.inlier_fraction), rtol=1e-5)
    info = np.asarray(a.information)
    np.testing.assert_allclose(b.information.numpy(), info, rtol=0, atol=1e-4 * np.abs(info).max())
    if w != 320:
        return
    # and the truth at the JAX test's size (tests/test_registration.py:330-347)
    T_true = cam.true_pose(1) @ np.linalg.inv(cam.true_pose(0))
    T = b.transformation.numpy()
    assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < 0.005
    assert np.abs(T[:3, :3] - T_true[:3, :3]).max() < 0.01


def test_odometry_auto_is_gather_and_rejects_unknown_warp():
    _, (c0, d0), (c1, d1) = _frames(160, 120, 130.0)
    src, tgt = (convert.rgbd_image(c, d, device="cpu") for c, d in ((c0, d0), (c1, d1)))
    intr = convert.camera_intrinsics(130.0, 130.0, 79.5, 59.5)
    a = compute_rgbd_odometry(src, tgt, intr, warp="auto")
    b = compute_rgbd_odometry(src, tgt, intr, warp="gather")
    assert torch.equal(a.transformation, b.transformation)
    same = compute_rgbd_odometry(src, src, intr)
    np.testing.assert_allclose(same.transformation.numpy(), np.eye(4), atol=1e-4)
    with pytest.raises(ValueError):
        compute_rgbd_odometry(src, tgt, intr, warp="remap")
