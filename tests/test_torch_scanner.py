"""Port parity for pipeline/scanner.py:StreamingScanner against the JAX
package on the CPU, at tests/test_pipelines.py's _small_cfg but for the
frames and the ICP iterations, cut to keep the module's JAX and port scans
short: 3 SyntheticRGBDCamera frames of 160x120 (fx = fy = 130, step
0.015), capture voxel 0.02, a 2^14-point combined buffer, ICP threshold
0.06 (10 iterations), Poisson depth 5.

The JAX test's assertions hold (tests/test_pipelines.py:50-66: at least 2
frames, more than 500 accumulated points, every finalize path written,
more than 200 triangles). Against the JAX scanner on the same frames: the
same per-frame gate decisions and rejections, the same combined count and
validity, points atol 1e-4 (measured 5.7e-6: the jitted JAX ICP rounds
otherwise than the port's eager one).
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recon3d_tpu import config as jconfig
from recon3d_tpu.camera.fake import SyntheticRGBDCamera as JSyntheticRGBDCamera
from recon3d_tpu.pipeline.scanner import StreamingScanner as JStreamingScanner
from recon3d_tpu.utils.types import CameraIntrinsics as JIntrinsics
from recon3d_tpu_torch import config
from recon3d_tpu_torch.camera.base import Camera
from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
from recon3d_tpu_torch.pipeline.scanner import StreamingScanner
from recon3d_tpu_torch.utils.types import CameraIntrinsics

from .test_torch_offline import _small_cfg

N = 3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _scan_cfg(pkg, out):
    cfg = _small_cfg(pkg, out)
    return dataclasses.replace(
        cfg, registration=dataclasses.replace(cfg.registration, icp_max_iterations=10))


def _scan(cls, cam_cls, intr, cfg):
    cam = cam_cls(width=160, height=120, fx=130.0, fy=130.0, n_frames=N, step=0.015)
    cam.open()
    kw = {} if cls is JStreamingScanner else {"device": "cpu"}
    sc = cls(cam, intr, cfg, **kw)
    sc.start(max_frames=N)
    sc._thread.join(timeout=300)
    sc.stop()
    return sc


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    jintr = JIntrinsics(fx=jnp.float32(130.0), fy=jnp.float32(130.0), cx=jnp.float32(79.5),
                        cy=jnp.float32(59.5))
    jsc = _scan(JStreamingScanner, JSyntheticRGBDCamera, jintr,
                _scan_cfg(jconfig, tmp_path_factory.mktemp("jax_scan")))
    out = tmp_path_factory.mktemp("scan")
    sc = _scan(StreamingScanner, SyntheticRGBDCamera, CameraIntrinsics(130.0, 130.0, 79.5, 59.5),
               _scan_cfg(config, out))
    return jsc, sc, out


def test_scan_accumulate_finalize(scans):
    _, sc, out = scans
    assert sc.frames >= 2
    assert int(sc.combined.count()) > 500
    mesh, dens, paths = sc.finalize(output_prefix=str(out / "scan"))
    assert len(paths) == 3
    for p in paths:
        assert os.path.exists(p)
    verts, tris, _, _ = mesh.to_numpy()
    assert len(tris) > 200
    assert dens.shape == (mesh.vertices.shape[0],)
    assert set(sc.timer.totals) >= {"accumulate", "process", "normals", "poisson", "save"}


def test_gate_and_combined_cloud_match_jax(scans):
    jsc, sc, _ = scans
    assert sc.frames == jsc.frames == N
    assert sc.frames_rejected == jsc.frames_rejected
    gates = [(n, bool(g)) for n, g, _, _ in sc._gate_record()]
    jgates = [(n, bool(np.asarray(g))) for n, g, _, _ in jsc._gate_log]
    assert gates == jgates and len(gates) == N - 1
    valid = sc.combined.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jsc.combined.valid))
    assert int(sc.combined.count()) == int(jsc.combined.count())
    np.testing.assert_allclose(sc.combined.points.numpy()[valid],
                               np.asarray(jsc.combined.points)[valid], atol=1e-4)
    np.testing.assert_allclose(sc.combined.colors.numpy()[valid],
                               np.asarray(jsc.combined.colors)[valid], atol=1e-6)


def test_empty_first_clouds_and_a_rejected_frame_are_gated(tmp_path):
    """An all-invalid first frame does not seed the map; a frame that fails
    the gate leaves the combined cloud as it was and is counted."""
    cam = SyntheticRGBDCamera(width=160, height=120, fx=130.0, fy=130.0, n_frames=3,
                              step=0.015)
    frames = [cam.grab() for _ in range(3)]
    blank = (frames[0][0], np.zeros_like(frames[0][1]))
    far = (frames[2][0], frames[2][1] + 0.5)  # the scene pushed 0.5 m away

    class Feed(Camera):
        loop = False

        def __init__(self, items):
            self.items = list(items)

        def open(self):
            pass

        def grab(self):
            return self.items.pop(0) if self.items else None

    def scan(items):
        sc = StreamingScanner(None, CameraIntrinsics(130.0, 130.0, 79.5, 59.5),
                              _scan_cfg(config, tmp_path), device="cpu")
        sc.camera = Feed(items)  # a non-looping replay: three empty reads end the scan
        sc.start(max_frames=10)
        sc._thread.join(timeout=300)
        sc.stop()
        return sc

    sc = scan([blank, frames[0], frames[1], far])
    assert sc.frames == 3 and sc.frames_rejected == 1
    assert [g for _, g, _, _ in sc._gate_record()] == [True, False]
    ref = scan([frames[0], frames[1]])
    assert ref.frames == 2 and ref.frames_rejected == 0
    for name in ("points", "valid", "colors"):
        assert torch.equal(getattr(sc.combined, name), getattr(ref.combined, name)), name
