"""StreamingFusion's threads, batching and checkpoints within the port, on the
CPU: the mirrors of tests/test_pipelines.py:100-253 and 420-555 at its
_small_cfg size (160x120 frames, fx = fy = 130, a 96^3 volume, voxel 0.015).
Within one package every comparison is bitwise (torch.equal): a backlog
runs the per-frame step in a loop, a checkpoint round-trips float32 and the
state's dtypes exactly, and the threaded stream's uploads carry the frames'
bits. The JAX package holds its batched runs to 1e-5 / 1e-4 only (XLA fuses
the scanned step otherwise); the port holds them bitwise."""
import time

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
from recon3d_tpu_torch.config import FusionConfig, ScannerConfig, StreamConfig
from recon3d_tpu_torch.depth.filters import DepthFilterBank
from recon3d_tpu_torch.pipeline.streaming import StreamingFusion
from recon3d_tpu_torch.utils.types import CameraIntrinsics

INTR = CameraIntrinsics(130.0, 130.0, 79.5, 59.5)
KW = dict(resolution=96, volume_origin=(-0.72, -0.72, 0.3), device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(tmp_path):
    return ScannerConfig(stream=StreamConfig(width=160, height=120, depth_trunc=2.5),
                         fusion=FusionConfig(voxel_size=0.015, sdf_trunc=0.06,
                                             grid_resolution=96, depth_trunc=2.5),
                         output_dir=str(tmp_path))


def _cam(n=4, step=0.015):
    return SyntheticRGBDCamera(width=160, height=120, fx=130.0, fy=130.0, n_frames=n, step=step)


def _frames(n, step):
    cam = _cam(n, step)
    cam.open()
    return [cam.grab() for _ in range(n)]


def _wait(sf, timeout=120):
    deadline = time.time() + timeout
    while any(t.is_alive() for t in sf._threads) and time.time() < deadline:
        time.sleep(0.05)


def _equal(a, b):
    assert len(a.trajectory) == len(b.trajectory)
    for p, q in zip(a.trajectory, b.trajectory):
        assert torch.equal(p, q)
    for name in ("tsdf", "weight", "color"):
        assert torch.equal(getattr(a.volume, name), getattr(b.volume, name)), name
    for p, q in zip(a._state, b._state):
        assert torch.equal(p, q)


def _sequential(frames, cfg, **kw):
    sf = StreamingFusion(None, INTR, cfg, consume_batch=1, **{**KW, **kw})
    for c, d in frames:
        sf._fuse_one(c, d, cfg.fusion)
    return sf


def test_threaded_stream_tracks_truth_and_equals_sequential(tmp_path):
    cam, cfg = _cam(5, step=0.01), _cfg(tmp_path)
    sf = StreamingFusion(cam, INTR, cfg, live_mesher=True, **KW).start()
    _wait(sf)
    sf.stop()
    assert sf.frames_captured == sf.frames_integrated == 5
    assert sf.odometry_failures == 0 and sf._host_failures == 0
    for k in range(1, 4):
        err = np.linalg.norm(sf.trajectory[k].numpy()[:3, 3]
                             - np.linalg.inv(cam.true_pose(k))[:3, 3])
        assert err < 0.01, f"frame {k} drift {err * 1000:.1f} mm"
    _equal(sf, _sequential(_frames(5, 0.01), cfg, live_mesher=True))
    verts, tris, _, _ = sf.extract_mesh().to_numpy()
    assert len(tris) > 500


def test_warmup_leaves_the_scan_untouched(tmp_path):
    cfg = _cfg(tmp_path)
    bank = DepthFilterBank()
    sf = StreamingFusion(_cam(5, step=0.01), INTR, cfg, consume_batch=2, live_mesher=True,
                         depth_filters=bank, **KW)
    c, d = _frames(1, 0.01)[0]
    sf.warmup(c, d)
    assert sf._state is None and sf.frames_integrated == 0 and not sf.trajectory
    assert float(sf.volume.weight.sum()) == 0.0 and bank._state is None
    assert bool(sf.mesher.cache.dirty.all()) and int(sf.mesher.cache.vcnt.sum()) == 0
    assert not sf.timer.totals
    sf.start()
    _wait(sf)
    sf.stop()
    assert sf.frames_integrated == 5 and sf.odometry_failures == 0
    _equal(sf, _sequential(_frames(5, 0.01), cfg, depth_filters=DepthFilterBank()))


def test_camera_crash_stops_stream_cleanly(tmp_path):
    cam = _cam(8, step=0.01)
    orig, calls = cam.grab, {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("sensor died")
        return orig()

    cam.grab = flaky
    sf = StreamingFusion(cam, INTR, _cfg(tmp_path), **KW).start()
    _wait(sf)
    # the crash ends the stream by itself: both threads exit before stop()
    assert not any(t.is_alive() for t in sf._threads)
    sf.stop()
    assert sf.frames_integrated == 2


def test_start_max_frames_caps_integration(tmp_path):
    sf = StreamingFusion(_cam(12, step=0.005), INTR, _cfg(tmp_path), consume_batch=3, **KW)
    sf.start(max_frames=4)
    _wait(sf)
    sf.stop()
    assert sf.frames_integrated == sf.frames_captured == 4


def test_checkpoint_resume_is_bitwise(tmp_path):
    frames, cfg = _frames(5, 0.01), _cfg(tmp_path)
    a = _sequential(frames, cfg)
    b = _sequential(frames[:3], cfg)
    ck = b.save_checkpoint(str(tmp_path / "scan_ckpt.npz"))
    r = StreamingFusion(None, INTR, cfg, **KW).restore_checkpoint(ck)
    assert r.frames_integrated == 3
    for c, d in frames[3:]:
        r._fuse_one(c, d, cfg.fusion)
    assert r.frames_integrated == 5
    _equal(r, a)
    assert int(r.extract_mesh().vertex_valid.sum()) > 0


@pytest.mark.parametrize("consume_batch,n,expect", [(4, 6, [4]), ("auto", 8, [8])])
def test_batched_fuse_is_bitwise_sequential(tmp_path, consume_batch, n, expect):
    """A backlog through _fuse_frames against _fuse_one a frame: bitwise.
    consume_batch=4 drains 4 frames a round; "auto" with the default queue
    of 10 drains 8, the largest power of two it holds."""
    frames, cfg = _frames(n, 0.008), _cfg(tmp_path)
    seq = _sequential(frames, cfg, live_mesher=True)
    bat = StreamingFusion(None, INTR, cfg, consume_batch=consume_batch, live_mesher=True, **KW)
    assert [bat._consume_batch] == expect
    bat._fuse_frames(frames, cfg.fusion)
    assert bat.frames_integrated == seq.frames_integrated == n
    _equal(bat, seq)
    assert torch.equal(bat.mesher.cache.dirty, seq.mesher.cache.dirty)


def test_start_stop_churn_never_wedges(tmp_path):
    cfg = _cfg(tmp_path)
    for cycle in range(3):
        sf = StreamingFusion(_cam(6, step=0.005), INTR, cfg, **KW)
        sf.start()
        # cycle 0 stops at once (racing the first frame); later ones let a
        # few frames through
        deadline = time.time() + 120
        while cycle > 0 and sf.frames_integrated < 2 and time.time() < deadline:
            time.sleep(0.05)
        sf.stop()
        for t in sf._threads:
            assert not t.is_alive(), f"cycle {cycle}: thread wedged"
    assert sf.frames_integrated >= 2
    assert int(sf.extract_mesh().vertex_valid.sum()) >= 0


def test_bad_arguments_raise(tmp_path):
    with pytest.raises(ValueError, match="unknown tracking mode"):
        StreamingFusion(None, INTR, _cfg(tmp_path), tracking="icp", **KW)

    class RawCam:
        depth_scale = 0.001  # a meters-per-unit multiplier, not a divisor

        def grab_raw(self):
            return None

    with pytest.raises(ValueError, match="units per meter"):
        StreamingFusion(RawCam(), INTR, _cfg(tmp_path), **KW)
