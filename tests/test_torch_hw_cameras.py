"""Port parity: the hardware camera drivers (camera/realsense.py,
camera/ipcam.py, camera/jetson.py) against the JAX package's, with the
hardware replaced by stand-ins.

- RealSense: a stand-in `pyrealsense2` module in sys.modules feeds both
  packages' drivers the same seeded frames; the grabbed arrays are held
  bitwise, and the stand-in records the same calls (streams, the
  hardware-reset retry, the filter chain).
- IP camera: a patched `_get` records every control endpoint path (held
  letter for letter to the JAX driver's) and serves a JPEG, decoded to the
  same pixels; without PIL, grab raises ImportError naming it.
- Jetson / USB: the GStreamer pipeline strings equal the JAX package's; a
  stand-in `gst-launch-1.0` on PATH writes seeded BGR frames, read back
  bitwise; a missing or failing gst-launch-1.0 makes open() raise.
"""
import io
import os
import stat
import sys
import types

import numpy as np
import pytest

from recon3d_tpu.camera import ipcam as jipcam
from recon3d_tpu.camera import jetson as jjetson
from recon3d_tpu.camera import realsense as jrealsense
from recon3d_tpu_torch.camera import ipcam, jetson, realsense
from recon3d_tpu_torch.camera.base import Camera


def _stand_in_rs(log, fail_first_start=False, seed=0, h=6, w=8):
    """A pyrealsense2 stand-in: seeded z16 depth and rgb8 color frames."""
    rng = np.random.RandomState(seed)
    rs = types.ModuleType("pyrealsense2")
    rs.stream = types.SimpleNamespace(depth="depth", color="color")
    rs.format = types.SimpleNamespace(z16="z16", rgb8="rgb8")
    starts = []

    class Frame:
        def __init__(self, data):
            self.data = data

        def get_data(self):
            return self.data

        def __bool__(self):
            return True

    class Frames:
        def __init__(self):
            self.depth = Frame(rng.randint(0, 4000, (h, w)).astype(np.uint16))
            self.color = Frame(rng.randint(0, 255, (h, w, 3)).astype(np.uint8))

        def get_depth_frame(self):
            return self.depth

        def get_color_frame(self):
            return self.color

    class Config:
        def enable_stream(self, *a):
            log.append(("enable_stream",) + a)

    class Profile:
        def get_device(self):
            return types.SimpleNamespace(first_depth_sensor=lambda: types.SimpleNamespace(
                get_depth_scale=lambda: 0.001))

        def get_stream(self, s):
            intr = types.SimpleNamespace(fx=600.0, fy=601.0, ppx=3.5, ppy=2.5, width=w, height=h)
            return types.SimpleNamespace(as_video_stream_profile=lambda: types.SimpleNamespace(
                get_intrinsics=lambda: intr))

    class Pipeline:
        def start(self, cfg):
            starts.append(cfg)
            log.append(("start",))
            if fail_first_start and len(starts) == 1:
                raise RuntimeError("device busy")
            return Profile()

        def wait_for_frames(self, timeout_ms):
            return Frames()

        def stop(self):
            log.append(("stop",))

    class Device:
        def hardware_reset(self):
            log.append(("hardware_reset",))

    class Filter:
        def __init__(self, name):
            self.name = name

        def process(self, f):
            log.append(("filter", self.name))
            return Frame(f.get_data() + 1)

    rs.config = Config
    rs.pipeline = Pipeline
    rs.context = lambda: types.SimpleNamespace(query_devices=lambda: [Device()])
    rs.align = lambda s: types.SimpleNamespace(process=lambda fr: fr)
    for name in ("decimation_filter", "spatial_filter", "temporal_filter",
                 "hole_filling_filter"):
        setattr(rs, name, lambda name=name: Filter(name))
    return rs


@pytest.mark.parametrize("fail_first_start", [False, True], ids=["start", "reset-retry"])
@pytest.mark.parametrize("use_filters", [True, False])
def test_realsense_frames_are_bitwise_the_jax_drivers(monkeypatch, fail_first_start,
                                                      use_filters):
    monkeypatch.setattr("time.sleep", lambda s: None)  # the reset's 2 s wait
    out = {}
    for name, mod in (("jax", jrealsense), ("torch", realsense)):
        log = []
        monkeypatch.setitem(sys.modules, "pyrealsense2", _stand_in_rs(log, fail_first_start))
        cam = mod.RealSenseCamera(use_filters=use_filters)
        cam.open()
        frames = [cam.grab() for _ in range(3)]
        cam.close()
        out[name] = (frames, log, cam.intrinsics, cam.depth_scale)
    (jf, jlog, jintr, jscale), (tf, tlog, tintr, tscale) = out["jax"], out["torch"]
    assert tlog == jlog and tintr == jintr and tscale == jscale == 0.001
    assert ("hardware_reset",) in tlog if fail_first_start else ("hardware_reset",) not in tlog
    assert (("filter", "hole_filling_filter") in tlog) == use_filters
    assert isinstance(realsense.RealSenseCamera(), Camera)
    for (c, d), (jc, jd) in zip(tf, jf):
        assert c.dtype == np.uint8 and d.dtype == np.float32
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(d, jd)


def _jpeg(seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (12, 16, 3)).astype(np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


def _drive_ipcam(cls):
    paths = []
    cam = cls("http://phone.local:8080/")
    cam._get = lambda p: paths.append(p) or (b'{"light": 3}' if p.endswith(".json")
                                             else _jpeg())
    cam.open()
    (img,) = cam.grab()
    cam.set_quality(70.6)
    cam.set_zoom(2)
    cam.set_exposure(-3)
    cam.set_iso(400)
    cam.set_shutter(0.01)
    cam.set_focus_distance(1.5)
    cam.set_flash(True)
    cam.set_flash(False)
    cam.switch_camera(True)
    cam.switch_camera(False)
    return cam, paths, img, cam.sensor_data()


def test_ipcam_endpoints_and_frames_are_the_jax_drivers():
    jcam, jpaths, jimg, jdata = _drive_ipcam(jipcam.IPCamera)
    cam, paths, img, data = _drive_ipcam(ipcam.IPCamera)
    assert cam.url == jcam.url == "http://phone.local:8080"
    assert paths == jpaths and "/settings/quality?set=70" in paths and "/enabletorch" in paths
    np.testing.assert_array_equal(img, jimg)
    assert img.shape == (12, 16, 3) and data == jdata == {"light": 3}


def test_ipcam_without_pil_names_it(monkeypatch):
    cam = ipcam.IPCamera("http://x")
    cam._get = lambda p: _jpeg()
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        cam.grab()


def _stand_in_gst(tmp_path, frames, fail=False):
    """A gst-launch-1.0 on PATH: records its arguments and writes `frames`
    (raw bytes, back to back) to stdout, or exits 1 at once."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    data = tmp_path / "frames.bin"
    data.write_bytes(b"".join(f.tobytes() for f in frames))
    exe = bindir / "gst-launch-1.0"
    exe.write_text(
        f"#!{sys.executable}\nimport sys\n"
        f"open({str(tmp_path / 'argv.txt')!r}, 'w').write('\\n'.join(sys.argv[1:]))\n"
        + ("sys.stderr.write('no element nvarguscamerasrc')\nsys.exit(1)\n" if fail else
           f"sys.stdout.buffer.write(open({str(data)!r}, 'rb').read())\n"))
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    return bindir


def test_gstreamer_pipeline_strings_match():
    for kw in ({}, dict(sensor_id=1, capture_width=1280, capture_height=720, display_width=640,
                        display_height=360, framerate=60, flip_method=2)):
        assert jetson.gstreamer_pipeline(**kw) == jjetson.gstreamer_pipeline(**kw)
    assert jetson.JetsonCSICamera().pipeline == jjetson.JetsonCSICamera().pipeline


@pytest.mark.parametrize("kind", ["csi", "usb"])
def test_gst_capture_reads_the_stand_ins_frames(tmp_path, monkeypatch, kind):
    rng = np.random.RandomState(1)
    if kind == "csi":
        cam = jetson.JetsonCSICamera(display_width=16, display_height=12)
    else:
        cam = jetson.USBCamera(index=2, width=16, height=12)
    frames = [rng.randint(0, 255, (12, 16, 3)).astype(np.uint8) for _ in range(3)]
    monkeypatch.setenv("PATH", str(_stand_in_gst(tmp_path, frames)) + os.pathsep
                       + os.environ["PATH"])
    cam.open()
    got = [cam.grab() for _ in range(4)]
    cam.close()
    for (g,), want in zip(got[:3], frames):
        np.testing.assert_array_equal(g, want)
    assert got[3] is None  # the stream ended, as cv2's read() returning False
    argv = (tmp_path / "argv.txt").read_text().splitlines()
    assert argv[0] == "-q" and argv[-3:] == ["!", "fdsink", "fd=1"] and "appsink" not in argv
    if kind == "csi":
        assert " ".join(argv[1:-3]) == cam.pipeline.rsplit("!", 1)[0].strip()
    else:
        assert "device=/dev/video2" in argv and "format=(string)BGR," in argv
    assert cam.grab() is None  # closed


def test_gst_capture_open_failures(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match="gst-launch-1.0 not found"):
        jetson.USBCamera().open()
    monkeypatch.setenv("PATH", str(_stand_in_gst(tmp_path, [], fail=True)))
    with pytest.raises(RuntimeError, match="failed to open CSI camera.*nvarguscamerasrc"):
        jetson.JetsonCSICamera().open()
