"""Command-line interface (twin of recon3d_tpu/cli.py).

Covers the reference's executable surfaces: the streaming scan (main.py),
the offline fragment pipeline with mini1.py:535-556's argparse flags, the
real-time fusion variant (check90.py), the stereo calibration workflow
(calib3_2.py batch mode), the live depth pipeline (depth4.py), the NPZ
inspection utilities (readPar.py / inspect_calibration_file.py) and an
environment check.

    python -m recon3d_tpu_torch.cli scan      --frames 30 --camera synthetic
    python -m recon3d_tpu_torch.cli offline   --frames 16 --camera replay --replay_dir ...
    python -m recon3d_tpu_torch.cli fuse      --frames 30 --camera synthetic
    python -m recon3d_tpu_torch.cli calibrate --folder imgs/ --pattern 9x6 --square 0.025
    python -m recon3d_tpu_torch.cli depth     --npz rig.npz --width 960 --height 540
    python -m recon3d_tpu_torch.cli inspect   --npz rig.npz
    python -m recon3d_tpu_torch.cli doctor

Every command but inspect runs on --device (default "cuda", the card);
without a card the command exits 1 and says so, unless given --device cpu,
which runs it on the host (the plain PyTorch versions of the kernels).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from recon3d_tpu_torch.config import ScannerConfig, add_dataclass_args, dataclass_from_args

# the reference capture's replay frames: the JAX CLI's --replay_dir default
GOLDEN_DIR = os.path.join(os.sep, "root", "reference", "test", "output")


def _make_camera(args):
    from recon3d_tpu_torch.camera.fake import FakeRGBDCamera, SyntheticRGBDCamera

    if args.camera == "synthetic":
        return SyntheticRGBDCamera(n_frames=args.frames)
    if args.camera == "replay":
        return FakeRGBDCamera(args.replay_dir, loop=False)
    if args.camera == "realsense":
        from recon3d_tpu_torch.camera.realsense import RealSenseCamera

        return RealSenseCamera()
    raise SystemExit(f"unknown camera backend {args.camera}")


def _intrinsics(args):
    from recon3d_tpu_torch.utils.types import CameraIntrinsics

    if args.intrinsics:
        return CameraIntrinsics.from_json(args.intrinsics)
    if args.camera == "synthetic":
        vals = (525.0, 525.0, 319.5, 239.5)
    else:  # D415 defaults (test/dataset/realsense/camera_intrinsic.json)
        vals = (616.6349, 616.309, 312.5787, 242.2195)
    return CameraIntrinsics(*(float(np.float32(v)) for v in vals))


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: 'cuda' (the card, default) or 'cpu'")


def _add_common(p):
    p.add_argument("--camera", default="synthetic", choices=["synthetic", "replay", "realsense"])
    p.add_argument("--replay_dir", default=GOLDEN_DIR)
    p.add_argument("--intrinsics", default=None, help="intrinsics JSON path")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--depth_filters", action="store_true",
                   help="apply the decimation-free spatial/temporal/hole-fill "
                        "chain (check90.py:99-103) on-device before fusion")
    _add_device(p)
    add_dataclass_args(p, ScannerConfig)


def _device(name: str):
    """The torch device a command runs on, or None (with the reason on
    stderr) when it names a CUDA card and there is none."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"recon3d_tpu_torch: no CUDA card for --device {name} "
              "(torch.cuda.is_available() is false); --device cpu runs on the host",
              file=sys.stderr)
        return None
    return dev


def _cmd_doctor(device: str) -> int:
    """Environment diagnostics: what will and won't work here, in one
    screen. Exit 0 when the requested device is usable, 1 otherwise."""
    import glob

    import torch

    from recon3d_tpu_torch import kernels
    from recon3d_tpu_torch.utils import native

    def row(name, ok, detail=""):
        mark = "ok " if ok else ("-- " if ok is None else "FAIL")
        print(f"  [{mark:4}] {name:28} {detail}")
        return bool(ok)

    print("recon3d_tpu_torch doctor")
    row("torch", True, f"{torch.__version__} (CUDA {torch.version.cuda})")
    dev = torch.device(device)
    if dev.type == "cuda":
        if torch.cuda.is_available():
            usable = row("torch device", True, f"cuda x{torch.cuda.device_count()} "
                                               f"({torch.cuda.get_device_name(0)})")
        else:
            usable = row("torch device", False, f"{device}: no CUDA card "
                                                 "(torch.cuda.is_available() is false)")
            print("         hint: --device cpu runs everything on the host "
                  "(the kernels' plain PyTorch versions)")
    else:
        usable = row("torch device", True, f"{device} (host; the kernels' plain versions)")
    lib = kernels.BUILD_DIR / kernels.LIB_NAME
    row("kernel library", lib.exists() or None,
        str(lib) if lib.exists() else "not built: nvcc builds it on the first card launch")
    try:
        native.load_library()
        row("native frameio (C++)", True, "libframeio.so loaded")
    except (OSError, RuntimeError) as e:
        row("native frameio (C++)", False, f"{type(e).__name__}: {e}")
    n_png = len(glob.glob(os.path.join(GOLDEN_DIR, "color_*.png")))
    row("golden replay fixtures", n_png > 0 or None,
        f"{GOLDEN_DIR} ({n_png} frames)" if n_png else "absent: use synthetic")
    return 0 if usable else 1


def _parser():
    parser = argparse.ArgumentParser(prog="recon3d_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    for name in ("scan", "offline", "fuse"):
        sp = sub.add_parser(name)
        _add_common(sp)
        if name == "fuse":
            sp.add_argument("--resume", default=None, metavar="CKPT",
                            help="resume fusion from a save_checkpoint NPZ")
            sp.add_argument("--consume_batch", default="auto",
                            type=lambda v: v if v == "auto" else int(v),
                            help="fuse queue backlogs of up to N frames in one "
                                 "step. Default 'auto' adapts N to the backlog; "
                                 "1 disables batching")
            sp.add_argument("--checkpoint", default=None, metavar="CKPT",
                            help="write a volume+tracking checkpoint here "
                                 "after the run (resumable with --resume)")

    cp = sub.add_parser("calibrate")
    cp.add_argument("--folder", required=True)
    cp.add_argument("--pattern", default="9x6")
    cp.add_argument("--square", type=float, default=1.0)
    cp.add_argument("--out", default="stereo_calibration.npz")
    cp.add_argument("--report", default="calibration_report.txt")
    _add_device(cp)

    dp = sub.add_parser("depth")
    dp.add_argument("--npz", required=True)
    dp.add_argument("--width", type=int, default=960)
    dp.add_argument("--height", type=int, default=540)
    dp.add_argument("--frames", type=int, default=10)
    dp.add_argument("--out", default="depth_out")
    _add_device(dp)

    ip = sub.add_parser("inspect")
    ip.add_argument("--npz", required=True)

    _add_device(sub.add_parser("doctor"))
    return parser


def _fuse(args, cfg, cam, intr, dev) -> int:
    from recon3d_tpu_torch.pipeline.streaming import StreamingFusion
    from recon3d_tpu_torch.utils import io

    bank = None
    if args.depth_filters:
        from recon3d_tpu_torch.depth.filters import DepthFilterBank

        bank = DepthFilterBank(decimation=0, hole_fill="left", device=str(dev))
    sf = StreamingFusion(cam, intr, cfg, resolution=cfg.fusion.grid_resolution,
                         depth_filters=bank, consume_batch=args.consume_batch, device=dev)
    skip = 0
    if args.resume:
        sf.restore_checkpoint(args.resume)
        print(f"resumed at frame {sf.frames_integrated} from {args.resume}")
        # replay / synthetic streams restart at frame 0 on open: skip the
        # already-integrated prefix so resumed fusion continues the scan
        # instead of re-registering old frames against the restored
        # keyframe (a live camera's stream has moved on by itself)
        if args.camera in ("replay", "synthetic"):
            skip = sf.frames_integrated
            if args.camera == "synthetic":
                # the synthetic stream is n_frames long; extend it so the
                # skipped prefix + the requested new frames fit
                from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera

                sf.camera = SyntheticRGBDCamera(n_frames=skip + args.frames)
    sf.start(skip_frames=skip, max_frames=args.frames)
    # wait for the threads, with two escapes so a wedged fusion thread (e.g.
    # a device hang) can't block the CLI forever: the frame target being
    # reached, and a no-progress stall deadline. The target counts the new
    # frames: a resumed run's count starts at the restored frames (the JAX
    # CLI compares the total with --frames, so a resumed run stops waiting
    # at once and fuses as many new frames as reach the volume first)
    target = None if args.frames is None else sf.frames_integrated + args.frames
    last_n, last_t = -1, time.monotonic()
    while any(t.is_alive() for t in sf._threads):
        n = sf.frames_integrated
        if target is not None and n >= target:
            break
        if n != last_n:
            last_n, last_t = n, time.monotonic()
        elif time.monotonic() - last_t > 600.0:
            print("fusion made no progress for 600 s; stopping", file=sys.stderr)
            break
        time.sleep(0.25)
    sf.stop()
    if args.checkpoint:
        print(f"checkpoint -> {sf.save_checkpoint(args.checkpoint)}")
    mesh = sf.extract_mesh()
    os.makedirs(cfg.output_dir, exist_ok=True)
    out = os.path.join(cfg.output_dir, "fused_mesh.ply")
    io.write_triangle_mesh(out, mesh)
    print(f"fused {sf.frames_integrated} frames "
          f"({sf.odometry_failures} odometry failures) -> {out}")
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    if args.cmd == "doctor":
        return _cmd_doctor(args.device)

    if args.cmd == "inspect":
        from recon3d_tpu_torch.calib import npz as _npz

        print(_npz.describe(args.npz))
        return 0

    dev = _device(args.device)
    if dev is None:
        return 1

    if args.cmd == "calibrate":
        from recon3d_tpu_torch.calib.api import calibrate_from_folder

        nx, ny = (int(v) for v in args.pattern.split("x"))
        params, info = calibrate_from_folder(
            args.folder, pattern_size=(nx, ny), square_size=args.square,
            save_path=args.out, report_path=args.report, device=dev)
        print(f"calibrated {len(info['pairs_used'])} pairs; "
              f"rms L/R {info['rms_left']:.4f}/{info['rms_right']:.4f}; "
              f"baseline {params.baseline:.4f}; saved {args.out}")
        return 0

    if args.cmd == "depth":
        from recon3d_tpu_torch.camera.fake import FakeStereoCamera
        from recon3d_tpu_torch.depth.pipeline import DepthPipeline
        from recon3d_tpu_torch.utils import io

        pipe = DepthPipeline.from_npz(args.npz, (args.width, args.height), device=dev)
        cam = FakeStereoCamera(width=args.width, height=args.height,
                               focal=float(np.asarray(pipe.params.P1)[0, 0]),
                               baseline=abs(pipe.params.baseline) or 0.06,
                               n_frames=args.frames)
        cam.open()
        os.makedirs(args.out, exist_ok=True)
        n = 0
        while True:
            f = cam.grab()
            if f is None:
                break
            disp, depth, vis = pipe.process(f[0], f[1])
            io.write_color(os.path.join(args.out, f"disp_{n:04d}.png"),
                           np.asarray((vis * 255).cpu().numpy(), np.uint8))
            n += 1
        print(f"processed {n} frames -> {args.out}")
        return 0

    cfg = dataclass_from_args(ScannerConfig, args)
    cam = _make_camera(args)
    intr = _intrinsics(args)

    if args.cmd == "scan":
        from recon3d_tpu_torch.pipeline.scanner import StreamingScanner

        cam.open()
        sc = StreamingScanner(cam, intr, cfg, device=dev)
        sc.start(max_frames=args.frames)
        sc._thread.join()
        sc.stop()
        mesh, dens, paths = sc.finalize(
            output_prefix=f"{cfg.output_dir}/captured_data_on_the_fly")
        print(f"scan complete: {sc.frames} frames -> {paths}")
        return 0

    if args.cmd == "offline":
        from recon3d_tpu_torch.pipeline.offline import Scanner3D

        path = Scanner3D(cam, intr, cfg, device=dev).run(n_frames=args.frames)
        print(f"offline pipeline complete -> {path}")
        return 0

    if args.cmd == "fuse":
        return _fuse(args, cfg, cam, intr, dev)
    return 1


if __name__ == "__main__":
    sys.exit(main())
