"""Port parity: the command-line interface (recon3d_tpu_torch/cli.py)
against the JAX package's cli.main on the same arguments, on the CPU
(`--device cpu` on the port's side), at small sizes.

- help, the unknown flag (exit 2 naming it), inspect (the same text),
  doctor (the same rows but the backend's; exit 0 with --device cpu, 1
  without a card), calibrate's failures (the same exception types);
- depth at 256x96 on a distorted rig: the written PNGs bitwise the JAX
  package's with the WLS refine off in both (the depth path's bar: FGS
  fails in float32 on these textured guides in both packages, ROADMAP
  queue 3), and with it on, bitwise the port's own DepthPipeline frames;
- scan / offline on 1 synthetic frame and fuse on 2: the PLYs they print,
  at the bars of test_torch_scanner.py (the combined cloud: count equal,
  points atol 1e-4), test_torch_offline.py (mesh vertices: median distance
  to JAX's under a voxel) and test_torch_streaming.py (the fused mesh:
  vertex count equal, vertices within 1e-4 at the median); fuse runs with
  --checkpoint, then --resume for 2 more frames (the port's bitwise its
  uninterrupted 4-frame run). The pair registration behind scan and
  offline is held to the JAX package by those files.
"""
import contextlib
import glob
import io as _io
import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from recon3d_tpu import cli as jcli
from recon3d_tpu.depth.pipeline import DepthPipeline as JDepthPipeline
from recon3d_tpu_torch import cli
from recon3d_tpu_torch.depth.pipeline import DepthPipeline
from recon3d_tpu_torch.utils import io, native

from .test_torch_pipeline import _port_params, _rig

SMALL = ["--stream.width", "160", "--stream.height", "120",
         "--processing.capture_voxel_size", "0.02", "--processing.voxel_size", "0.02",
         "--processing.capacity", str(1 << 14), "--processing.outlier_nb_neighbors", "10",
         "--processing.radius_nb_points", "4", "--processing.radius", "0.05",
         "--registration.voxel_size", "0.03", "--registration.icp_threshold", "0.06",
         "--registration.icp_max_iterations", "10",
         "--registration.ransac_max_iterations", "4096", "--mesh.poisson_depth", "5",
         "--mesh.smoothing_iterations", "2"]
FUSE = ["--fusion.grid_resolution", "64", "--fusion.voxel_size", "0.03",
        "--fusion.sdf_trunc", "0.12"]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """2 torch threads: the suite runs six workers on a shared host."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _run(main, argv):
    """(exit code, stdout, stderr) of a main() call; SystemExit's code too."""
    out, err = _io.StringIO(), _io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rig") / "rig.npz")
    _port_params(_rig()).save(path)
    return path


def test_help_lists_the_same_commands_and_unknown_flags_exit_2():
    _, out_t, _ = _run(cli.main, ["--help"])
    _, out_j, _ = _run(jcli.main, ["--help"])
    cmds = "{scan,offline,fuse,calibrate,depth,inspect,doctor}"
    assert cmds in out_t and cmds in out_j
    for flag, argv in (("--bogus_flag", ["scan", "--bogus_flag", "1"]),
                       ("--nope", ["depth", "--npz", "x", "--nope"])):
        rc_t, _, err_t = _run(cli.main, argv)
        rc_j, _, err_j = _run(jcli.main, argv)
        assert rc_t == rc_j == 2
        assert flag in err_t and flag in err_j


def test_inspect_prints_the_same_text(rig):
    rc_t, out_t, _ = _run(cli.main, ["inspect", "--npz", rig])
    rc_j, out_j, _ = _run(jcli.main, ["inspect", "--npz", rig])
    assert rc_t == rc_j == 0 and out_t == out_j and "Baseline" in out_t


def test_doctor_rows_and_exit_codes():
    rc, out, _ = _run(cli.main, ["doctor", "--device", "cpu"])
    assert rc == 0
    rc_j, out_j, _ = _run(jcli.main, ["doctor"])
    rows = {ln[9:38].strip(): ln for ln in out.splitlines()[1:] if ln.startswith("  [")}
    rows_j = {ln[9:38].strip(): ln for ln in out_j.splitlines()[1:] if ln.startswith("  [")}
    assert set(rows) == {"torch", "torch device", "kernel library", "native frameio (C++)",
                         "golden replay fixtures"}
    # the rows both packages check alike; the others are their backends'
    assert rows["golden replay fixtures"] == rows_j["golden replay fixtures"]
    assert rows["native frameio (C++)"].startswith("  [ok  ]")
    if not torch.cuda.is_available():
        rc, out, _ = _run(cli.main, ["doctor"])
        assert rc == 1 and "[FAIL] torch device" in out and "no CUDA card" in out
        rc, _, err = _run(cli.main, ["scan", "--frames", "1"])
        assert rc == 1 and "no CUDA card" in err and "--device cpu" in err


def test_calibrate_fails_as_the_jax_package_does(tmp_path):
    """An empty folder, and pairs without a detectable board: the same
    exception from both mains."""
    empty = tmp_path / "empty"
    empty.mkdir()
    for main, extra in ((cli.main, CPU), (jcli.main, [])):
        with pytest.raises(FileNotFoundError, match="unpaired"):
            main(["calibrate", "--folder", str(empty)] + extra)
    noise = tmp_path / "noise"
    rng = np.random.RandomState(0)
    for k in range(3):
        for side in ("left", "right"):
            io.write_color(str(noise / f"{side}_{k}.png"),
                           rng.randint(0, 255, (60, 80, 3)).astype(np.uint8))
    for main, extra in ((cli.main, CPU), (jcli.main, [])):
        with pytest.raises(RuntimeError, match="good pairs"):
            main(["calibrate", "--folder", str(noise), "--out", str(tmp_path / "o.npz"),
                  "--report", str(tmp_path / "r.txt")] + extra)


def _pngs(d):
    return [native.png_read(p) for p in sorted(glob.glob(os.path.join(d, "disp_*.png")))]


def test_depth_writes_the_jax_packages_frames(rig, tmp_path, monkeypatch):
    argv = ["depth", "--npz", rig, "--width", "256", "--height", "96", "--frames", "2"]
    # the port's CLI writes its pipeline's frames, WLS included
    rc, out, _ = _run(cli.main, argv + ["--out", str(tmp_path / "wls")] + CPU)
    assert rc == 0 and "processed 2 frames" in out
    from recon3d_tpu_torch.camera.fake import FakeStereoCamera

    pipe = DepthPipeline.from_npz(rig, (256, 96), device="cpu")
    cam = FakeStereoCamera(width=256, height=96, focal=float(pipe.params.P1[0, 0]),
                           baseline=abs(pipe.params.baseline) or 0.06, n_frames=2)
    cam.open()
    for png in _pngs(tmp_path / "wls"):
        left, right = cam.grab()
        vis = pipe.process(left, right)[2]
        np.testing.assert_array_equal(png, np.asarray((vis * 255).numpy(), np.uint8))

    # against the JAX package's CLI with the WLS refine off in both
    for cls in (DepthPipeline, JDepthPipeline):
        orig = cls.from_npz.__func__

        def no_wls(c, *a, _orig=orig, **kw):
            p = _orig(c, *a, **kw)
            p.with_wls = False
            return p

        monkeypatch.setattr(cls, "from_npz", classmethod(no_wls))
    assert _run(cli.main, argv + ["--out", str(tmp_path / "t")] + CPU)[0] == 0
    assert _run(jcli.main, argv + ["--out", str(tmp_path / "j")])[0] == 0
    got, want = _pngs(tmp_path / "t"), _pngs(tmp_path / "j")
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _ply(path):
    return io.read_ply(path)


def test_scan_matches_jax(tmp_path):
    argv = ["scan", "--camera", "synthetic", "--frames", "1"] + SMALL
    rc_t, out_t, _ = _run(cli.main, argv + ["--output_dir", str(tmp_path / "t")] + CPU)
    rc_j, out_j, _ = _run(jcli.main, argv + ["--output_dir", str(tmp_path / "j")])
    assert rc_t == rc_j == 0 and "scan complete: 1 frames" in out_t
    raw_t = _ply(tmp_path / "t" / "captured_data_on_the_fly.ply")["points"]
    raw_j = _ply(tmp_path / "j" / "captured_data_on_the_fly.ply")["points"]
    assert len(raw_t) == len(raw_j) > 500
    np.testing.assert_allclose(raw_t, raw_j, atol=1e-4)
    for name in ("captured_data_on_the_fly_mesh.ply", "captured_data_on_the_fly_mesh_colored.ply"):
        d = _ply(tmp_path / "t" / name)
        assert len(d["triangles"]) > 200 and np.isfinite(d["points"]).all()


def test_offline_matches_jax(tmp_path):
    argv = ["offline", "--camera", "synthetic", "--frames", "1", "--fusion.grid_resolution", "96",
            "--fusion.voxel_size", "0.015", "--fusion.sdf_trunc", "0.06"] + SMALL
    rc_t, out_t, _ = _run(cli.main, argv + ["--output_dir", str(tmp_path / "t")] + CPU)
    rc_j, out_j, _ = _run(jcli.main, argv + ["--output_dir", str(tmp_path / "j")])
    assert rc_t == rc_j == 0
    path_t, path_j = out_t.split("-> ")[-1].strip(), out_j.split("-> ")[-1].strip()
    v_t, v_j = _ply(path_t)["points"], _ply(path_j)["points"]
    assert len(v_t) > 500
    dist, _ = cKDTree(v_j).query(v_t)
    assert np.median(dist) < 0.015  # a voxel
    assert abs(len(v_t) - len(v_j)) <= 0.01 * len(v_j)


def test_fuse_checkpoint_and_resume(tmp_path):
    """fuse --checkpoint against the JAX CLI (the fused mesh at
    test_torch_streaming.py's bars); the port's --resume for 2 more frames
    equals its uninterrupted 4-frame run. (The JAX CLI's resume stops
    waiting at once, its target counting the restored frames, so how many
    new frames it fuses depends on its threads' timing: not compared.)"""
    argv = ["fuse", "--camera", "synthetic"] + FUSE
    meshes = {}
    for tag, main, extra in (("t", cli.main, CPU), ("j", jcli.main, [])):
        ck = str(tmp_path / f"{tag}_ckpt.npz")
        rc, text, _ = _run(main, argv + ["--frames", "2", "--checkpoint", ck,
                                         "--output_dir", str(tmp_path / tag / "a")] + extra)
        assert rc == 0 and "fused 2 frames (0 odometry failures)" in text and os.path.exists(ck)
        meshes[tag] = _ply(tmp_path / tag / "a" / "fused_mesh.ply")["points"]
    rc, text, _ = _run(cli.main, argv + ["--frames", "2", "--resume", str(tmp_path / "t_ckpt.npz"),
                                         "--output_dir", str(tmp_path / "t" / "b")] + CPU)
    assert rc == 0 and "resumed at frame 2" in text and "fused 4 frames" in text, text
    assert len(meshes["t"]) == len(meshes["j"]) > 1000
    dist, _ = cKDTree(meshes["j"]).query(meshes["t"])
    assert np.median(dist) < 1e-4, np.median(dist)

    rc, text, _ = _run(cli.main, argv + ["--frames", "4", "--output_dir",
                                         str(tmp_path / "t" / "c")] + CPU)
    assert rc == 0 and "fused 4 frames" in text
    whole = _ply(tmp_path / "t" / "c" / "fused_mesh.ply")
    resumed = _ply(tmp_path / "t" / "b" / "fused_mesh.ply")
    assert len(whole["points"]) > len(meshes["t"])
    np.testing.assert_array_equal(resumed["points"], whole["points"])
    np.testing.assert_array_equal(resumed["triangles"], whole["triangles"])


def test_make_camera_and_intrinsics_follow_the_jax_package():
    from recon3d_tpu_torch.camera.realsense import RealSenseCamera

    for camera in ("synthetic", "replay", "realsense"):
        args = cli._parser().parse_args(["scan", "--camera", camera])
        i_t = cli._intrinsics(args)
        i_j = jcli._intrinsics(args)
        assert (i_t.fx, i_t.fy, i_t.cx, i_t.cy) == tuple(
            float(np.float32(v)) for v in (i_j.fx, i_j.fy, i_j.cx, i_j.cy))
    args = cli._parser().parse_args(["scan", "--camera", "realsense"])
    assert isinstance(cli._make_camera(args), RealSenseCamera)


@pytest.mark.parametrize("argv", [
    [],
    ["--voxel_size", "0.008", "--sdf_trunc", "0.04", "--fps", "15",
     "--downsample_voxel_size", "0.005", "--output_dir", "/tmp/xyz"],
    ["--matcher.num_disparities", "64", "--wls.lam", "4000"],
    ["--visualize", "yes", "--fusion.color", "false", "--registration.method", "gicp",
     "--stream.depth_scale", "4000"],
], ids=["defaults", "reference-aliases", "nested", "bools-strings"])
def test_parse_scanner_config_matches_jax(argv):
    """JAX tests/test_config.py:27-46's argv (and more) through both packages:
    equal dataclasses.asdict."""
    import dataclasses

    from recon3d_tpu.config import parse_scanner_config as jparse
    from recon3d_tpu_torch.config import ScannerConfig, parse_scanner_config

    cfg, jcfg = parse_scanner_config(argv), jparse(argv)
    assert isinstance(cfg, ScannerConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if "--voxel_size" in argv:
        assert cfg.fusion.voxel_size == 0.008 and cfg.stream.fps == 15
        assert cfg.processing.voxel_size == 0.005 and cfg.output_dir == "/tmp/xyz"
