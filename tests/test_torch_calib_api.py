"""Port parity for calib/api.py, calib/report.py, calib/npz.py (inspect,
describe) and calib/gui.py (CalibrationSession, headless) against the JAX
package on the CPU. Neither package detects a board without OpenCV (see
tests/test_torch_chessboard.py), so both APIs get the same corners
(tests/_calib_data.py: 4 views, 0.05 px noise) in place of their detection.
Bars: the StereoParams within 1e-6 relative, the rms within 1e-8 relative,
the saved NPZs' keys equal, the report equal line for line at a fixed
timestamp but for the header's package name; the folder mode and the
session (PNG frames the test writes itself) give the API's result.
"""
import numpy as np
import pytest

from recon3d_tpu.calib import api as japi
from recon3d_tpu.calib import npz as jnpz
from recon3d_tpu.calib import report as jreport
from recon3d_tpu_torch.calib import api, gui, npz, report
from recon3d_tpu_torch.utils import io
from tests import _calib_data as cd
from tests.test_calib_gui import _StillCamera

V = 4
FIELDS = ("mtx1", "dist1", "mtx2", "dist2", "R", "T", "E", "F", "R1", "R2", "P1", "P2", "Q")


def _frames(V):
    """Distinct gray frames of the calibration size (their pixels are not
    read: the corners stand in for the detection)."""
    W, H = cd.SIZE
    return [np.full((H, W), 10 * k, np.uint8) for k in range(V)]


def _stand_in(corners, frames):
    left, right = corners

    def detect(il, ir, pattern_size, detector="opencv", device=None):
        assert len(il) == len(frames)
        for a, b in zip(il, frames):
            np.testing.assert_array_equal(np.asarray(a)[..., 0] if np.ndim(a) == 3 else a, b)
        return [left[v] for v in range(V)], [right[v] for v in range(V)], list(range(V))

    return detect


@pytest.fixture(scope="module")
def corners():
    _, left, right = cd.stereo_views(V, seed=1)
    return left, right


@pytest.fixture(scope="module")
def jax_run(corners, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    frames = _frames(V)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "detect_corner_pairs", _stand_in(corners, frames))
        params, info = japi.stereo_calibrate_camera(
            frames, frames, pattern_size=cd.PATTERN, square_size=cd.SQUARE,
            save_path=str(out / "rig.npz"), report_path=str(out / "report.txt"))
    return params, info, out


@pytest.fixture(scope="module")
def port_run(corners, tmp_path_factory):
    out = tmp_path_factory.mktemp("port")
    frames = _frames(V)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api, "detect_corner_pairs", _stand_in(corners, frames))
        params, info = api.stereo_calibrate_camera(
            frames, frames, pattern_size=cd.PATTERN, square_size=cd.SQUARE,
            save_path=str(out / "rig.npz"), report_path=str(out / "report.txt"), device="cpu")
    return params, info, out


def _same_params(a, b, what):
    for k in FIELDS:
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.shape == y.shape, (what, k)
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6 * np.abs(y).max(),
                                   err_msg=f"{what}: {k}")


def test_stereo_calibrate_camera_matches(jax_run, port_run):
    jp, ji, _ = jax_run
    tp, ti, _ = port_run
    _same_params(tp, jp, "api")
    for k in ("rms_left", "rms_right", "rms_stereo", "mean_error_left", "mean_error_right"):
        assert ti[k] == pytest.approx(ji[k], rel=1e-8), k
    np.testing.assert_allclose(ti["per_view_errors"], ji["per_view_errors"], rtol=1e-6)
    assert ti["pairs_used"] == ji["pairs_used"] and ti["image_size"] == ji["image_size"]


def test_saved_npz_and_its_dumps_match(jax_run, port_run):
    _, _, jdir = jax_run
    _, _, tdir = port_run
    jpath, tpath = str(jdir / "rig.npz"), str(tdir / "rig.npz")
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(FIELDS)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    assert npz.inspect(tpath) == jnpz.inspect(tpath)
    assert npz.describe(jpath) == jnpz.describe(jpath)
    _same_params(npz.StereoParams.load(tpath), jnpz.StereoParams.load(jpath), "npz")


def test_report_matches_line_for_line(jax_run, port_run, tmp_path):
    jp, ji, jdir = jax_run
    _, _, tdir = port_run
    kw = dict(per_view_errors=ji["per_view_errors"], square_size=cd.SQUARE,
              pattern_size=cd.PATTERN, timestamp="2026-01-02 03:04:05")
    args = (cd.SIZE, V, ji["mean_error_left"], ji["mean_error_right"])
    ref = jreport.write_stereo_report(str(tmp_path / "j.txt"), jp, *args, **kw).splitlines()
    out = report.write_stereo_report(str(tmp_path / "t.txt"), npz.StereoParams(
        **{k: getattr(jp, k) for k in FIELDS}), *args, **kw).splitlines()
    assert out[1] == "STEREO CALIBRATION REPORT (recon3d_tpu_torch)"
    assert ref[1] == "STEREO CALIBRATION REPORT (recon3d_tpu)"
    assert out[:1] + out[2:] == ref[:1] + ref[2:]
    assert (tmp_path / "t.txt").read_text().splitlines() == out
    # the APIs' own reports: the same lines, the timestamp and header aside
    a = (jdir / "report.txt").read_text().splitlines()
    b = (tdir / "report.txt").read_text().splitlines()
    assert len(a) == len(b) and a[4:] == b[4:]
    assert report.format_matrix("M", np.eye(2)) == jreport.format_matrix("M", np.eye(2))


def test_calibrate_from_folder_gives_the_api_result(port_run, corners, tmp_path, monkeypatch):
    frames = _frames(V)
    for k, f in enumerate(frames):
        io.write_color(str(tmp_path / f"left_{k:03d}.png"), np.repeat(f[..., None], 3, -1))
        io.write_color(str(tmp_path / f"right_{k:03d}.png"), np.repeat(f[..., None], 3, -1))
    monkeypatch.setattr(api, "detect_corner_pairs", _stand_in(corners, frames))
    params, _ = api.calibrate_from_folder(str(tmp_path), pattern_size=cd.PATTERN,
                                          square_size=cd.SQUARE, device="cpu")
    _same_params(params, port_run[0], "folder")
    with pytest.raises(FileNotFoundError, match="unpaired"):
        api.calibrate_from_folder(str(tmp_path / "empty"), device="cpu")


def test_calibration_session_capture_save_load_and_calibrate(port_run, corners, tmp_path,
                                                             monkeypatch):
    frames = [np.repeat(f[..., None], 3, -1) for f in _frames(V)]

    class _Seq:
        def __init__(self):
            self.k = -1

        def read(self):
            self.k += 1
            return True, frames[self.k % V]

    s = gui.CalibrationSession(_Seq(), _Seq(), pattern_size=cd.PATTERN,
                               square_size=cd.SQUARE, output_dir=str(tmp_path / "cap"),
                               save_images=True, device="cpu")
    assert s.run_calibration() == (None, None) and "need" in s.status
    for _ in range(V):
        assert s.capture_pair()
    assert s.status == f"{V} pairs captured"
    for k in range(V):
        for side in ("left", "right"):
            path = str(tmp_path / "cap" / f"{side}_{k:03d}.png")
            np.testing.assert_array_equal(io.read_color(path), frames[k])
    s2 = gui.CalibrationSession(_StillCamera(None), _StillCamera(None), pattern_size=cd.PATTERN,
                                square_size=cd.SQUARE, output_dir=str(tmp_path / "out"),
                                device="cpu")
    assert not s2.capture_pair() and s2.status == "no frame"
    assert s2.load_folder(str(tmp_path / "cap")) == V and len(s2.pairs) == V
    monkeypatch.setattr(api, "detect_corner_pairs", _stand_in(corners, _frames(V)))
    params, info = s2.run_calibration()
    _same_params(params, port_run[0], "session")
    assert (tmp_path / "out" / "stereo_rig_stereo.npz").exists()
    assert (tmp_path / "out" / "stereo_rig_calibration_report.txt").exists()
    assert s2.status.startswith("done: rms L/R")
    g = gui.CalibrationGUI(s2)
    assert g.session is s2
    W, H = cd.SIZE
    header = b"P6 %d %d 255\n" % (W, H)
    ppm = gui._ppm(frames[0])
    assert ppm.startswith(header) and len(ppm) == len(header) + H * W * 3
