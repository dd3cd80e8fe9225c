#!/usr/bin/env python3
"""Drive recon3d_tpu_torch's depth slice on one NVIDIA H100 and hold every
kernel of the slice to its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

The frame is the bench scene at full size: the synthetic sphere-over-plane
rectified pair at 1920x1080, tuned SGM-4 (D = 128, block 5, P2 = 96 * 25),
box-count speckle, WLS refine, disparity -> depth and a colored point cloud.
Phases, one JSON line each:
  device   card name, nvidia-smi name / power limit, CUDA of torch, nvcc;
  build    seconds to build the kernels (cold when build/kernels/ is empty);
  slice    one frame through the public entry points with every launch
           counter at 0 before it (the counts it leaves prove the frame ran
           every kernel), then fps (median of 10 frames after 2 warm-ups),
           peak memory, RMSE against the same frame built from the plain
           versions on the card and RMSE against the analytic disparity;
  kernels  each kernel against its plain version on the frame's own inputs:
           K2 cost and v1 and K3 v3 bitwise, K4 valid equal and
           |d disp| < 1e-4 where valid, K6 rtol 1e-4 / atol 1e-3; median
           CUDA-event time over 10 launches, the plain version's median over
           3, and the least time the card could take (bound_ms).
Then the card's nvidia-smi line and, last, the result line. Any failed
comparison or exception exits nonzero without the result line; a hung
kernel ends the run through the faulthandler watchdog. Without a CUDA card,
or outside the repository, it exits nonzero before any result.
"""
import dataclasses
import faulthandler
import json
import statistics
import subprocess
import sys
import time

BUDGET_S = 300  # whole-run watchdog: a hang exits nonzero with a traceback
H, W, D = 1080, 1920, 128
FOCAL, BASELINE = 1050.0, 0.06
KERNEL_RUNS, PLAIN_RUNS, FRAMES, WARMUP = 10, 3, 10, 2
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 ops/s outside tensor cores
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def bench_scene():
    """bench.py:build_headline's scene: rectified gray pair, truth, BGR
    color stream and the standard Q (bench.py:155-187)."""
    import numpy as np

    from recon3d_tpu_torch.camera.fake import FakeStereoCamera

    rect_l, rect_r, disp_true, _ = FakeStereoCamera(width=W, height=H, focal=FOCAL,
                                                    baseline=BASELINE).render(0)
    rng_c = np.random.RandomState(1)
    color_bgr = np.stack([np.clip(rect_l * s + rng_c.rand(H, W) * 8.0, 0, 255)
                          for s in (0.9, 1.0, 0.8)], axis=-1).astype(np.uint8)
    Q = np.zeros((4, 4), np.float32)
    Q[0, 0], Q[1, 1] = 1.0, 1.0
    Q[0, 3], Q[1, 3] = -W / 2.0, -H / 2.0
    Q[2, 3], Q[3, 2] = FOCAL, 1.0 / BASELINE
    return rect_l, rect_r, disp_true, color_bgr, Q


def cuda_ms(fn, runs, setup=lambda: ()):
    """Median CUDA-event time of fn(*setup()) over `runs` calls (setup runs
    outside the timed region)."""
    import torch

    times = []
    for _ in range(runs):
        args = setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, nops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main():
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from recon3d_tpu_torch import convert, kernels
    from recon3d_tpu_torch.config import StereoMatcherConfig, WLSConfig
    from recon3d_tpu_torch.depth import sgm_cuda, wls_cuda
    from recon3d_tpu_torch.depth.matcher import compute_disparity, disparity_to_depth
    from recon3d_tpu_torch.depth.sgm import speckle_filter_fast
    from recon3d_tpu_torch.depth.wls import _edge_weights, lambda_schedule
    from recon3d_tpu_torch.pointcloud.backproject import backproject_disparity

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    nvcc_out = subprocess.run([kernels.find_nvcc(), "--version"], capture_output=True,
                              text=True, check=True).stdout
    nvcc_line = [ln for ln in nvcc_out.splitlines() if "release" in ln][-1].strip()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc_line,
          "count": torch.cuda.device_count()})

    # ---- build
    cold = not (kernels.BUILD_DIR / kernels.LIB_NAME).exists()
    t0 = time.perf_counter()
    kernels.load()
    emit({"phase": "build", "build_s": round(time.perf_counter() - t0, 3), "cold": cold,
          "library": str(kernels.BUILD_DIR / kernels.LIB_NAME)})

    # ---- the frame's state, carried across as convert.py receives the JAX
    # package's bench configuration (backend 'pallas' on the TPU)
    rect_l, rect_r, disp_true, color_bgr_np, Q_np = bench_scene()
    st = convert.convert_state(
        dict(dataclasses.asdict(StereoMatcherConfig.tuned(num_disparities=D, block_size=5)),
             backend="pallas"),
        dataclasses.asdict(WLSConfig()), Q_np, device=dev)
    m, w = st.matcher, st.wls
    check(m.backend == "cuda" and m.mode == "sgm4" and m.p2() == 96 * 25, "bench config")
    gl = torch.tensor(rect_l, dtype=torch.float32, device=dev)
    gr = torch.tensor(rect_r, dtype=torch.float32, device=dev)
    color_bgr = torch.tensor(color_bgr_np, device=dev)

    def frame():
        disp, valid = compute_disparity(gl, gr, m, w, True)
        depth = disparity_to_depth(disp, st.Q)
        color = color_bgr.flip(-1).to(torch.float32) / 255.0  # BGR -> RGB, in the frame
        pc = backproject_disparity(disp, st.Q, color=color, assume_standard_q=True)
        return disp, valid, depth, pc

    # ---- slice: the counted run of the main path
    wrappers = {"K2": sgm_cuda.cost_fwd_down, "K3": sgm_cuda.bwd_accumulate,
                "K4": sgm_cuda.vfinalize, "K6": wls_cuda.tridiag_solve}
    for fn in wrappers.values():
        fn.launches = 0
    disp, valid, depth, pc = frame()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")

    for _ in range(WARMUP):
        frame()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    frame_ms = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    peak_bytes = torch.cuda.max_memory_allocated(dev)

    # the same frame from the plain versions, on the card
    color_rgb = color_bgr.flip(-1).to(torch.float32) / 255.0
    p1, p2 = float(m.p1()), float(m.p2())
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    planes = sgm_cuda.prefilter_planes(gl, gr, m.pre_filter_cap)
    cost_p, v_p = sgm_cuda.cost_fwd_down_plain(planes, HP, WP, DP, D, 0, m.block_size, p1, p2)
    sgm_cuda.bwd_accumulate_plain(cost_p, v_p, p1, p2)
    dp_raw, vp = sgm_cuda.vfinalize_plain(cost_p, v_p, p1, p2, D, m.uniqueness_ratio,
                                          m.disp12_max_diff, m.subpixel, W, "up")
    del cost_p, v_p
    dp_raw, vp = dp_raw[:H, :W], vp[:H, :W]
    vp = speckle_filter_fast(dp_raw, vp, float(m.speckle_range), m.speckle_window_size,
                             max_disparity=DP)
    u = torch.where(vp, dp_raw, 0.0)
    conf = vp.to(torch.float32)
    wx, wy = _edge_weights(gl, 1, w.sigma_color), _edge_weights(gl, 0, w.sigma_color)
    for lt in lambda_schedule(w.lam, w.iterations):
        u = wls_cuda.tridiag_solve_plain(*wls_cuda.solve_planes(wx, conf, u, lt, 1), 1)
        u = wls_cuda.tridiag_solve_plain(*wls_cuda.solve_planes(wy, conf, u, lt, 0), 0)
    pc_p = backproject_disparity(u, st.Q, color=color_rgb, assume_standard_q=True)

    # the frame's stages on their own: SGM (K2-K4 + glue), WLS (6 x K6 +
    # glue), depth + cloud
    sgm_kw = dict(num_disparities=D, block_size=m.block_size, p1=p1, p2=p2, num_directions=4,
                  uniqueness_ratio=m.uniqueness_ratio, disp12_max_diff=m.disp12_max_diff,
                  speckle_window_size=m.speckle_window_size,
                  speckle_range=float(m.speckle_range), pre_filter_cap=m.pre_filter_cap,
                  do_subpixel=m.subpixel)
    d_sgm, v_sgm = sgm_cuda.sgm_disparity_cuda(gl, gr, **sgm_kw)
    stages_ms = {
        "sgm": cuda_ms(lambda: sgm_cuda.sgm_disparity_cuda(gl, gr, **sgm_kw), KERNEL_RUNS),
        "wls": cuda_ms(lambda: wls_cuda.wls_refine_cuda(d_sgm, v_sgm, gl, w.lam, w.sigma_color,
                                                        w.iterations), KERNEL_RUNS),
        "depth_cloud": cuda_ms(lambda: (disparity_to_depth(disp, st.Q), backproject_disparity(
            disp, st.Q, color=color_rgb, assume_standard_q=True)), KERNEL_RUNS),
    }

    check(disp.shape == (H, W) and depth.shape == (H, W), "output shapes")
    check(pc.points.shape == (H * W, 3) and pc.colors.shape == (H * W, 3), "cloud shapes")
    check(bool(torch.isfinite(disp).all() and torch.isfinite(depth).all()), "finite output")
    check(bool(torch.isfinite(pc.points[pc.valid]).all()), "finite points")
    check(torch.equal(valid, u > 0), "valid mask differs from the plain frame")
    check(torch.allclose(disp, u, rtol=1e-4, atol=1e-3), "disparity differs from the plain frame")
    check(torch.equal(pc.valid, pc_p.valid), "cloud mask differs from the plain frame")
    rmse_plain = float(torch.sqrt(((disp - u) ** 2).mean()))
    # against the analytic disparity (truth > 1 px): the dense WLS output,
    # and the SGM stage on its own valid pixels (bench.py:686-695's measure);
    # "core" crops an 8 px border and the left D band no match can reach
    dt = torch.tensor(disp_true, device=dev)
    core = torch.zeros((H, W), dtype=torch.bool, device=dev)
    core[8:H - 8, D + 8:W - 8] = True

    def rmse_truth(d, mask):
        mask = mask & (dt > 1.0)
        return float(torch.sqrt(((d[mask] - dt[mask]) ** 2).mean()))

    truth = {"wls_px": rmse_truth(disp, valid), "wls_core_px": rmse_truth(disp, valid & core),
             "sgm_px": rmse_truth(d_sgm, v_sgm), "sgm_core_px": rmse_truth(d_sgm, v_sgm & core)}
    # sanity bars, far above what a working matcher scores on this scene
    check(truth["sgm_core_px"] < 2.0 and truth["wls_core_px"] < 2.5,
          f"disparity far from the analytic truth: {truth}")
    emit({"phase": "slice", "shape": [H, W, D], "fps": round(1e3 / statistics.median(frame_ms), 3),
          "frame_ms_median": round(statistics.median(frame_ms), 3),
          "frame_ms": [round(t, 3) for t in frame_ms],
          "stages_ms": {k: round(v, 3) for k, v in stages_ms.items()},
          "peak_mem_bytes": peak_bytes, "launches": launches,
          "valid_fraction": round(float(valid.float().mean()), 5),
          "sgm_valid_fraction": round(float(v_sgm.float().mean()), 5),
          "points_valid": int(pc.valid.sum()), "rmse_vs_plain_px": rmse_plain,
          "rmse_vs_truth": truth})

    # ---- kernels against their plain versions, on the frame's inputs
    rows = []
    n_el = HP * WP * DP
    cost_b, v1_b = HP * WP * DP * 2, HP * WP * DP * 4

    def row(name, source, replaces, err, ms, plain_ms, bound, **extra):
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches[name.split()[0]], max_abs_err=err,
                         ms=round(ms, 4), plain_ms=round(plain_ms, 4),
                         bound_ms=round(bound[0], 4), bound_by=bound[1], library_ms=None,
                         **extra))

    # K2
    k2 = lambda: sgm_cuda.cost_fwd_down(gl, gr, D, 0, m.block_size, m.pre_filter_cap, p1, p2,
                                        HP, WP, DP, True, planes=planes)
    k2p = lambda: sgm_cuda.cost_fwd_down_plain(planes, HP, WP, DP, D, 0, m.block_size, p1, p2)
    cost_k, v1_k = k2()
    cost_q, v1_q = k2p()
    check(torch.equal(cost_k, cost_q), "K2 cost differs from its plain version")
    check(torch.equal(v1_k, v1_q), "K2 v1 differs from its plain version")
    err = max(float((cost_k.float() - cost_q.float()).abs().max()),
              float((v1_k - v1_q).abs().max()))
    del cost_q, v1_q
    row("K2 cost_fwd_down", "recon3d_tpu_torch/csrc/sgm_cost.cu",
        "recon3d_tpu/depth/sgm_pallas.py:985", err, cuda_ms(k2, KERNEL_RUNS),
        cuda_ms(k2p, PLAIN_RUNS), bound_ms(6 * H * W * 4 + cost_b + v1_b, 30 * n_el))

    # K3 (in place on v1: every run gets a fresh copy, made outside the timing)
    v3_k = sgm_cuda.bwd_accumulate(cost_k, v1_k.clone(), p1, p2)
    v3_q = sgm_cuda.bwd_accumulate_plain(cost_k, v1_k.clone(), p1, p2)
    check(torch.equal(v3_k, v3_q), "K3 v3 differs from its plain version")
    err = float((v3_k - v3_q).abs().max())
    del v3_q
    row("K3 bwd_accumulate", "recon3d_tpu_torch/csrc/sgm_bwd.cu",
        "recon3d_tpu/depth/sgm_pallas.py:1094", err,
        cuda_ms(lambda v: sgm_cuda.bwd_accumulate(cost_k, v, p1, p2), KERNEL_RUNS,
                lambda: (v1_k.clone(),)),
        cuda_ms(lambda v: sgm_cuda.bwd_accumulate_plain(cost_k, v, p1, p2), PLAIN_RUNS,
                lambda: (v1_k.clone(),)),
        bound_ms(cost_b + 2 * v1_b, 8 * n_el))
    del v1_k

    # K4 (S is written over v3)
    args = (p1, p2, D, m.uniqueness_ratio, m.disp12_max_diff, m.subpixel, W, "up")
    d_k, val_k = sgm_cuda.vfinalize(cost_k, v3_k.clone(), *args)
    d_q, val_q = sgm_cuda.vfinalize_plain(cost_k, v3_k.clone(), *args)
    check(torch.equal(val_k, val_q), "K4 valid differs from its plain version")
    err = float((d_k - d_q).abs()[val_q].max())
    check(err < 1e-4, f"K4 disparity differs from its plain version by {err}")
    row("K4 vfinalize", "recon3d_tpu_torch/csrc/sgm_vfinalize.cu",
        "recon3d_tpu/depth/sgm_pallas.py:1135", err,
        cuda_ms(lambda v: sgm_cuda.vfinalize(cost_k, v, *args), KERNEL_RUNS,
                lambda: (v3_k.clone(),)),
        cuda_ms(lambda v: sgm_cuda.vfinalize_plain(cost_k, v, *args), PLAIN_RUNS,
                lambda: (v3_k.clone(),)),
        bound_ms(cost_b + v1_b + HP * WP * 8, 16 * n_el))
    del cost_k, v3_k, d_q, val_q

    # K6: the first sweep's horizontal and vertical solves of the frame's WLS
    conf = v_sgm.to(torch.float32)
    u0 = torch.where(v_sgm, d_sgm, 0.0)
    lt = lambda_schedule(w.lam, w.iterations)[0]
    err, times, plain_times = 0.0, [], []
    for axis, w_edge in ((1, wx), (0, wy)):
        sp = wls_cuda.solve_planes(w_edge, conf, u0, lt, axis)
        out_k = wls_cuda.tridiag_solve(*sp, axis)
        out_q = wls_cuda.tridiag_solve_plain(*sp, axis)
        check(torch.allclose(out_k, out_q, rtol=1e-4, atol=1e-3),
              f"K6 axis {axis} differs from its plain version")
        err = max(err, float((out_k - out_q).abs().max()))
        times.append(cuda_ms(lambda: wls_cuda.tridiag_solve(*sp, axis), KERNEL_RUNS))
        plain_times.append(cuda_ms(lambda: wls_cuda.tridiag_solve_plain(*sp, axis), PLAIN_RUNS))
    row("K6 tridiag_solve", "recon3d_tpu_torch/csrc/wls_tridiag.cu",
        "recon3d_tpu/depth/wls_pallas.py:102", err, sum(times) / 2, sum(plain_times) / 2,
        bound_ms(5 * H * W * 4, 10 * H * W), ms_axis1=round(times[0], 4),
        ms_axis0=round(times[1], 4))

    emit({"kernels": rows})
    print(smi, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(f"# wall {time.perf_counter() - t_start:.1f} s", file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
