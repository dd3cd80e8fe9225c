"""Port parity for the package and camera exports, the cameras of
camera/fake.py (FakeStereoCamera as a Camera, FakeRGBDCamera's PNG replay),
CameraIntrinsics.matrix / from_json and tilt_matrix's default dtype, against
the JAX package on the CPU.

Bars: every comparison is exact. FakeRGBDCamera replays PNG pairs the test
writes with the port's writers (160x120, depth in millimeters), and its
frames equal the JAX class's on the same directory bit for bit, with
prefetch on and off.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recon3d_tpu
import recon3d_tpu.camera as jcamera
import recon3d_tpu.depth as jdepth
from recon3d_tpu.calib import model as jmodel
from recon3d_tpu.camera.fake import FakeRGBDCamera as JFakeRGBDCamera
from recon3d_tpu.camera.fake import FakeStereoCamera as JFakeStereoCamera
from recon3d_tpu.utils.types import CameraIntrinsics as JIntrinsics
import recon3d_tpu_torch
import recon3d_tpu_torch.camera as camera
import recon3d_tpu_torch.depth as depth
from recon3d_tpu_torch.calib import model
from recon3d_tpu_torch.camera import (Camera, FakeRGBDCamera, FakeStereoCamera,
                                      SyntheticRGBDCamera, ThreadedCamera)
from recon3d_tpu_torch.utils import io
from recon3d_tpu_torch.utils.types import CameraIntrinsics

N = 5


def _public(module):
    return {n for n in vars(module) if not n.startswith("_") and n not in (
        "annotations", "jax", "jnp", "np")}


@pytest.mark.parametrize("pair", [(recon3d_tpu, recon3d_tpu_torch), (jcamera, camera),
                                  (jdepth, depth)], ids=["package", "camera", "depth"])
def test_every_jax_export_has_its_port_name(pair):
    jmod, mod = pair
    names = {n for n in _public(jmod) if not isinstance(getattr(jmod, n), type(jmod))}
    missing = sorted(n for n in names if not hasattr(mod, n))
    assert not missing, missing
    if jmod is recon3d_tpu:
        assert recon3d_tpu_torch.__version__ == recon3d_tpu.__version__


def test_fake_stereo_camera_is_a_camera_and_grabs_its_renders():
    cam, jcam = FakeStereoCamera(96, 64, n_frames=3), JFakeStereoCamera(96, 64, n_frames=3)
    assert isinstance(cam, Camera)
    cam.open()
    jcam.open()
    for k in range(3):
        gl, gr = cam.grab()
        jl, jr = jcam.grab()
        rl, rr, _, _ = cam.render(k)
        np.testing.assert_array_equal(gl, rl)
        np.testing.assert_array_equal(gr, rr)
        np.testing.assert_array_equal(gl, jl)
        np.testing.assert_array_equal(gr, jr)
    assert cam.grab() is None and jcam.grab() is None
    cam.open()
    np.testing.assert_array_equal(cam.grab()[0], cam.render(0)[0])


def test_threaded_camera_drives_the_stereo_camera():
    cam = FakeStereoCamera(96, 64, n_frames=2)
    renders = [cam.render(k)[:2] for k in range(2)]
    tc = ThreadedCamera(cam, max_retries=2, timeout_s=0.02).start()
    try:
        ok, frame = False, None
        for _ in range(500):
            ok, frame = tc.read()
            if ok and tc.frames_grabbed >= 2:
                break
            import time

            time.sleep(0.01)
    finally:
        tc.stop()
    assert ok and tc.frames_grabbed == 2
    assert any(all(np.array_equal(a, b) for a, b in zip(frame, r)) for r in renders)


def test_tilt_matrix_defaults_to_float64():
    t = model.tilt_matrix(0.01, -0.005)
    assert t.dtype == torch.float64
    assert model.tilt_matrix(0.01, -0.005, dtype=torch.float32).dtype == torch.float32
    import jax

    with jax.enable_x64():
        ref = np.asarray(jmodel.tilt_matrix(0.01, -0.005))
    assert ref.dtype == np.float64
    np.testing.assert_allclose(t.numpy(), ref, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("keys", [("ppx", "ppy"), ("cx", "cy")])
def test_intrinsics_matrix_and_from_json_equal_jax(tmp_path, keys):
    path = tmp_path / "camera_intrinsic.json"
    d = {"fx": 616.63, "fy": 616.31, keys[0]: 312.58, keys[1]: 242.22, "width": 640}
    path.write_text(json.dumps(d))
    intr, jintr = CameraIntrinsics.from_json(str(path)), JIntrinsics.from_json(str(path))
    assert (intr.fx, intr.fy, intr.cx, intr.cy) == tuple(
        float(np.asarray(v)) for v in (jintr.fx, jintr.fy, jintr.cx, jintr.cy))
    K = intr.matrix(device="cpu")
    assert K.dtype == torch.float32
    np.testing.assert_array_equal(K.numpy(), np.asarray(jintr.matrix()))
    j2 = JIntrinsics(fx=jnp.float32(130.0), fy=jnp.float32(131.5), cx=jnp.float32(79.5),
                     cy=jnp.float32(59.25))
    np.testing.assert_array_equal(CameraIntrinsics(130.0, 131.5, 79.5, 59.25).matrix(
        device="cpu").numpy(), np.asarray(j2.matrix()))
    assert CameraIntrinsics.from_matrix(K) == intr


@pytest.fixture(scope="module")
def scan_dir(tmp_path_factory):
    """N PNG pairs written by the port's writers, plus a color frame with no
    depth (index N), which both cameras skip."""
    out = tmp_path_factory.mktemp("scan")
    cam = SyntheticRGBDCamera(160, 120, fx=130.0, fy=130.0, n_frames=N + 1)
    cam.open()
    frames = [cam.grab() for _ in range(N + 1)]
    for k, (c, d) in enumerate(frames):
        io.write_color(str(out / f"color_{k:05d}.png"), c)
        if k < N:
            io.write_depth(str(out / f"depth_{k:05d}.png"), d, 1000.0)
    return str(out), frames[:N]


def _replay(cam, n):
    cam.open()
    return [cam.grab() for _ in range(n)]


@pytest.mark.parametrize("prefetch", [True, False])
def test_fake_rgbd_replays_like_jax(scan_dir, prefetch):
    directory, frames = scan_dir
    cam = FakeRGBDCamera(directory, prefetch=prefetch)
    got = _replay(cam, N + 1)
    ref = _replay(JFakeRGBDCamera(directory, prefetch=prefetch), N + 1)
    assert len(cam) == N and got[N] is None and ref[N] is None
    for (c, d), (jc, jd), (c0, d0) in zip(got[:N], ref[:N], frames):
        assert c.dtype == np.uint8 and d.dtype == np.float32
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(c, c0)
        # the writer truncates meters x 1000 to u16: within a millimeter
        raw = np.clip(d0.astype(np.float64) * 1000.0, 0, 65535).astype(np.uint16)
        np.testing.assert_array_equal(d, raw.astype(np.float32) / 1000.0)
    if prefetch:
        assert cam.wait_prefetched(timeout=60.0)
    raw_cam = FakeRGBDCamera(directory, prefetch=prefetch)
    raw_cam.open()
    assert raw_cam.grab_raw()[1].dtype == np.uint16


def test_fake_rgbd_prefetch_on_and_off_agree_and_loop(scan_dir):
    directory, _ = scan_dir
    on = _replay(FakeRGBDCamera(directory, prefetch=True, loop=True), 2 * N + 1)
    off = _replay(FakeRGBDCamera(directory, prefetch=False, loop=True), 2 * N + 1)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for k in range(N + 1):  # the loop wraps to frame 0
        np.testing.assert_array_equal(on[k][1], on[k % N][1])
        np.testing.assert_array_equal(on[k + N][1], on[k % N][1])


def test_fake_rgbd_raises_decode_errors_and_empty_dirs(tmp_path):
    with pytest.raises(FileNotFoundError):
        FakeRGBDCamera(str(tmp_path)).open()
    c = np.zeros((24, 32, 3), np.uint8)
    for k in range(3):
        io.write_color(str(tmp_path / f"color_{k:05d}.png"), c)
        io.write_depth(str(tmp_path / f"depth_{k:05d}.png"), np.ones((24, 32), np.float32))
    (tmp_path / "depth_00002.png").write_bytes(b"\x89PNG\r\n\x1a\n broken")
    for prefetch in (True, False):
        cam = FakeRGBDCamera(str(tmp_path), prefetch=prefetch)
        cam.open()
        if prefetch:
            with pytest.raises(ValueError):
                cam.wait_prefetched(timeout=60.0)
        with pytest.raises(ValueError):
            for _ in range(3):
                cam.grab()
