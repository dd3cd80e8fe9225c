#!/usr/bin/env python3
"""Drive recon3d_tpu_torch's depth paths on one NVIDIA H100 and hold every
kernel on them to its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

The frames are the bench scene at full size: the synthetic sphere-over-plane
pair at 1920x1080, D = 128, block 5. Phases, one JSON line each:
  device      card name, nvidia-smi name / power limit, CUDA of torch, nvcc;
  build       seconds to build the kernels (cold when build/kernels/ is empty);
  slice       the rectified pair through compute_disparity (tuned SGM-4,
              P2 = 96 * 25, box-count speckle, WLS), depth and the colored
              cloud;
  headline    bench.py:build_headline's frame: the raw pair (the rectified
              scene pushed through the inverse of the bench's synthetic
              rectification) through the two-pass warp (K1) twice, then the
              slice's frame and the BGR color stream's cloud;
  pipeline    one DepthPipeline.process at 1920x1080 on an in-memory rig
              with radial distortion and small rectifying rotations;
  accurate    the accurate() preset (SGM-8, P2 = 128 * 25) on the rectified
              pair;
  standalone  aggregate_and_finalize without v1, whose forward and downward
              paths then run as the standalone scans (K14);
  kernels     each kernel against its plain version on its path's own
              inputs, its median CUDA-event time over 10 launches, the plain
              version's median over 3, the least time the card could take
              (bound_ms) and, where one PyTorch call computes the same or
              the yardstick function, that call's time (library_ms).
Each path runs once with every launch counter at 0 before it, and the
counts it leaves must be the path's kernels exactly. The frames record fps
(median of 10 frames after 2 warm-ups), peak memory, RMSE against the same
frame built from the plain versions on the card, and RMSE against the
analytic disparity under sanity bars. Then the card's nvidia-smi line and,
last, the result line. Any failed comparison or exception exits nonzero
without the result line; a hung kernel ends the run through the
faulthandler watchdog. Without a CUDA card, or outside the repository, it
exits nonzero before any result.
"""
import dataclasses
import faulthandler
import json
import statistics
import subprocess
import sys
import time

BUDGET_S = 300  # whole-run watchdog: a hang exits nonzero with a traceback
DEVICE = "cuda"  # the card; a rehearsal of the script on the CPU sets "cpu"
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


def forward_xy(x, y, H, W):
    """bench.py:_forward_xy, the synthetic rectification model: rectified
    coords -> raw coords (radial distortion + small rotation + offset)."""
    import numpy as np

    cx, cy, f = W / 2.0, H / 2.0, 1.2 * W
    xn, yn = (x - cx) / f, (y - cy) / f
    scale = 1.0 - 0.06 * (xn ** 2 + yn ** 2)
    ang = 0.006
    mx = cx + f * (scale * xn * np.cos(ang) - yn * np.sin(ang)) + 4.0
    my = cy + f * (scale * yn * np.cos(ang) + xn * np.sin(ang)) - 3.0
    return mx, my


def synthetic_maps(H, W):
    """bench.py:_synthetic_maps: rectification maps, remap(raw, mx, my) = rect."""
    import numpy as np

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    mx, my = forward_xy(xx, yy, H, W)
    return mx.astype(np.float32), my.astype(np.float32)


def inverse_maps(H, W, iters=12):
    """bench.py:_inverse_maps: the inverse warp by fixed-point iteration, so
    raw = remap(rect, inverse) makes the benched rectification a real one."""
    import numpy as np

    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    x, y = uu.copy(), vv.copy()
    for _ in range(iters):
        fx, fy = forward_xy(x, y, H, W)
        x += uu - fx
        y += vv - fy
    return x.astype(np.float32), y.astype(np.float32)


def remap_replicate(img, mx, my):
    """cv2.remap(img, mx, my, INTER_LINEAR, borderMode=BORDER_REPLICATE) on a
    float32 image, in numpy (the card's machine has no OpenCV)."""
    import numpy as np

    H, W = img.shape
    x0, y0 = np.floor(mx), np.floor(my)
    fx, fy = mx - x0, my - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)

    def tap(y, x):
        return img[np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)]

    top = (1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1)
    bottom = (1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)
    return ((1 - fy) * top + fy * bottom).astype(np.float32)


def rodrigues(rvec):
    """Axis-angle (3,) -> rotation matrix (cv2.Rodrigues), numpy."""
    import numpy as np

    theta = float(np.linalg.norm(rvec))
    k = np.asarray(rvec, np.float64) / theta
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def pipeline_rig():
    """An in-memory rectified rig at the bench's size: radial and tangential
    distortion, small rectifying rotations, baseline 0.06."""
    import numpy as np

    from recon3d_tpu_torch.calib.npz import StereoParams

    f = 1040.0
    K1 = np.array([[FOCAL, 0.0, W / 2 + 3.0], [0.0, FOCAL + 2.0, H / 2 - 2.0], [0, 0, 1]])
    K2 = np.array([[FOCAL - 4.0, 0.0, W / 2 - 5.0], [0.0, FOCAL - 3.0, H / 2 + 1.0], [0, 0, 1]])
    d1 = np.array([[-0.06, 0.012, 0.0004, -0.0003, 0.0]])
    d2 = np.array([[-0.05, 0.010, -0.0002, 0.0005, 0.0]])
    P1 = np.array([[f, 0.0, W / 2, 0.0], [0.0, f, H / 2, 0.0], [0.0, 0.0, 1.0, 0.0]])
    P2 = P1.copy()
    P2[0, 3] = -f * BASELINE
    Q = np.zeros((4, 4))
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3], Q[1, 3], Q[2, 3], Q[3, 2] = -W / 2, -H / 2, f, 1.0 / BASELINE
    return StereoParams(mtx1=K1, dist1=d1, mtx2=K2, dist2=d2, R=rodrigues([0.002, -0.004, 0.001]),
                        T=np.array([[-BASELINE], [0.0], [0.0]]),
                        R1=rodrigues([0.001, -0.002, 0.0008]),
                        R2=rodrigues([0.0012, 0.0021, -0.0004]), P1=P1, P2=P2, Q=Q)


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




def plain_disparity(gl, gr, m, w, num_directions):
    """compute_disparity's kernel path built from the plain versions (on the
    tensors' device): returns (dense WLS disparity, SGM valid mask)."""
    import torch

    from recon3d_tpu_torch.depth import sgm_cuda, wls_cuda
    from recon3d_tpu_torch.depth.sgm import speckle_filter_fast
    from recon3d_tpu_torch.depth.wls import _edge_weights, lambda_schedule

    p1, p2 = float(m.p1()), float(m.p2())
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    planes = sgm_cuda.prefilter_planes(gl, gr, m.pre_filter_cap)
    cost, v = sgm_cuda.cost_fwd_down_plain(planes, HP, WP, DP, D, 0, m.block_size, p1, p2,
                                           num_directions >= 4)
    sgm_cuda.bwd_accumulate_plain(cost, v, p1, p2)
    if num_directions == 8:
        for vertical in ("down", "up"):
            sgm_cuda.diag_accumulate_plain(cost, v, p1, p2, vertical)
    d_raw, vp = sgm_cuda.vfinalize_plain(cost, v, p1, p2, D, m.uniqueness_ratio,
                                         m.disp12_max_diff, m.subpixel, W,
                                         "up" if num_directions >= 4 else "down")
    del cost, v
    d_raw, vp = d_raw[:H, :W], vp[:H, :W]
    vp = speckle_filter_fast(d_raw, vp, float(m.speckle_range), m.speckle_window_size,
                             max_disparity=DP)
    u = torch.where(vp, d_raw, 0.0)
    conf = vp.to(torch.float32)
    wx, wy = _edge_weights(gl, 1, w.sigma_color), _edge_weights(gl, 0, w.sigma_color)
    for lt in lambda_schedule(w.lam, w.iterations):
        u = wls_cuda.tridiag_solve_plain(*wls_cuda.solve_planes(wx, conf, u, lt, 1), 1)
        u = wls_cuda.tridiag_solve_plain(*wls_cuda.solve_planes(wy, conf, u, lt, 0), 0)
    return u, vp


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
    from recon3d_tpu_torch.depth import DepthPipeline, sgm_cuda, wls_cuda
    from recon3d_tpu_torch.depth.matcher import compute_disparity, disparity_to_depth
    from recon3d_tpu_torch.depth.wls import _edge_weights, lambda_schedule
    from recon3d_tpu_torch.ops import warp
    from recon3d_tpu_torch.pointcloud.backproject import backproject_disparity

    dev = torch.device(DEVICE, 0)
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

    # every kernel wrapper's launch counter
    wrappers = {"K1": warp.resample_pass, "K2": sgm_cuda.cost_fwd_down,
                "K3": sgm_cuda.bwd_accumulate, "K4": sgm_cuda.vfinalize,
                "K5": sgm_cuda.diag_accumulate, "K6": wls_cuda.tridiag_solve,
                "K14 fwd": sgm_cuda.fwd_scan, "K14 down": sgm_cuda.down_accumulate}

    def counted(fn, expected):
        """Run a path once with every counter at 0 before it; its counts must
        be `expected` (the other kernels 0)."""
        for f in wrappers.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in wrappers.items()}
        want = {k: expected.get(k, 0) for k in wrappers}
        check(counts == want, f"launches {counts}, expected {want}")
        return out, {k: n for k, n in counts.items() if n}

    def timed_frames(frame):
        """Host-clock ms of FRAMES frames after WARMUP, each ending in a
        synchronize, and the peak device memory of those frames."""
        for _ in range(WARMUP):
            frame()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = []
        for _ in range(FRAMES):
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms, torch.cuda.max_memory_allocated(dev)

    def frame_stats(ms, peak):
        med = statistics.median(ms)
        return {"fps": round(1e3 / med, 3), "frame_ms_median": round(med, 3),
                "frame_ms": [round(t, 3) for t in ms], "peak_mem_bytes": peak}

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
    color_rgb = color_bgr.flip(-1).to(torch.float32) / 255.0
    p1, p2 = float(m.p1()), float(m.p2())
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    dt = torch.tensor(disp_true, device=dev)
    # "core" crops an 8 px border and the left D band no match can reach
    core = torch.zeros((H, W), dtype=torch.bool, device=dev)
    core[8:H - 8, D + 8:W - 8] = True

    def rmse_truth(d, mask):
        """RMSE against the analytic disparity on mask & truth > 1 px."""
        mask = mask & (dt > 1.0)
        return float(torch.sqrt(((d[mask] - dt[mask]) ** 2).mean()))

    def sgm_kw(mc, num_directions):
        return dict(num_disparities=D, block_size=mc.block_size, p1=float(mc.p1()),
                    p2=float(mc.p2()), num_directions=num_directions,
                    uniqueness_ratio=mc.uniqueness_ratio, disp12_max_diff=mc.disp12_max_diff,
                    speckle_window_size=mc.speckle_window_size,
                    speckle_range=float(mc.speckle_range), pre_filter_cap=mc.pre_filter_cap,
                    do_subpixel=mc.subpixel)

    def against(disp, valid, u, vp_dense, what):
        """The frame against its plain-version twin on the card."""
        check(torch.equal(valid, vp_dense), f"{what}: valid mask differs from the plain frame")
        check(torch.allclose(disp, u, rtol=1e-4, atol=1e-3),
              f"{what}: disparity differs from the plain frame")
        return float(torch.sqrt(((disp - u) ** 2).mean()))

    def truth_of(disp, valid, d_sgm, v_sgm, what):
        """RMSE against the analytic disparity under sanity bars, far above
        what a working matcher scores on this scene: the SGM stage on its
        valid pixels (bench.py:686-695's measure) and the dense WLS output.
        The exact WLS solution is a weighted mean of the SGM data, so it
        lies in [0, D]; values outside are float32 failures of the FGS solve
        on near-singular systems (guide edges at the 1e-6 weight floor around
        pixels without data), as in the JAX package's solver. The WLS bar is
        held on the pixels inside that range, and those outside must stay
        below 0.5 % of the core."""
        in_range = (disp >= 0) & (disp <= D)
        scored = valid & core & (dt > 1.0)
        truth = {"wls_px": rmse_truth(disp, valid), "wls_core_px": rmse_truth(disp, valid & core),
                 "wls_core_in_range_px": rmse_truth(disp, valid & core & in_range),
                 "wls_core_out_of_range_share": float((scored & ~in_range).sum() / scored.sum()),
                 "wls_max_px": float(disp.abs().max()),
                 "sgm_px": rmse_truth(d_sgm, v_sgm), "sgm_core_px": rmse_truth(d_sgm, v_sgm & core)}
        check(truth["sgm_core_px"] < 2.0 and truth["wls_core_in_range_px"] < 2.5
              and truth["wls_core_out_of_range_share"] < 0.005,
              f"{what}: disparity far from the analytic truth: {truth}")
        return truth

    # ---- slice: the rectified pair (the counted run of its path)
    def frame():
        disp, valid = compute_disparity(gl, gr, m, w, True)
        depth = disparity_to_depth(disp, st.Q)
        color = color_bgr.flip(-1).to(torch.float32) / 255.0  # BGR -> RGB, in the frame
        pc = backproject_disparity(disp, st.Q, color=color, assume_standard_q=True)
        return disp, valid, depth, pc

    (disp, valid, depth, pc), launches = counted(frame, {"K2": 1, "K3": 1, "K4": 1, "K6": 6})
    stats = frame_stats(*timed_frames(frame))
    u, vp = plain_disparity(gl, gr, m, w, 4)
    pc_p = backproject_disparity(u, st.Q, color=color_rgb, assume_standard_q=True)

    # the frame's stages on their own: SGM (K2-K4 + glue), WLS (6 x K6 +
    # glue), depth + cloud
    d_sgm, v_sgm = sgm_cuda.sgm_disparity_cuda(gl, gr, **sgm_kw(m, 4))
    stages_ms = {
        "sgm": cuda_ms(lambda: sgm_cuda.sgm_disparity_cuda(gl, gr, **sgm_kw(m, 4)), KERNEL_RUNS),
        "wls": cuda_ms(lambda: wls_cuda.wls_refine_cuda(d_sgm, v_sgm, gl, w.lam, w.sigma_color,
                                                        w.iterations), KERNEL_RUNS),
        "depth_cloud": cuda_ms(lambda: (disparity_to_depth(disp, st.Q), backproject_disparity(
            disp, st.Q, color=color_rgb, assume_standard_q=True)), KERNEL_RUNS),
    }
    check(disp.shape == (H, W) and depth.shape == (H, W), "output shapes")
    check(pc.points.shape == (H * W, 3) and pc.colors.shape == (H * W, 3), "cloud shapes")
    check(bool(torch.isfinite(disp).all() and torch.isfinite(depth).all()), "finite output")
    check(bool(torch.isfinite(pc.points[pc.valid]).all()), "finite points")
    rmse_plain = against(disp, valid, u, u > 0, "slice")
    check(torch.equal(pc.valid, pc_p.valid), "cloud mask differs from the plain frame")
    # against the analytic disparity (truth > 1 px): the dense WLS output,
    # and the SGM stage on its own valid pixels (bench.py:686-695's measure)
    truth = truth_of(disp, valid, d_sgm, v_sgm, "slice")
    check(truth["wls_core_px"] < 2.5, f"slice: WLS far from the analytic truth: {truth}")
    emit({"phase": "slice", "shape": [H, W, D], **stats,
          "stages_ms": {k: round(v, 3) for k, v in stages_ms.items()}, "launches": launches,
          "valid_fraction": round(float(valid.float().mean()), 5),
          "sgm_valid_fraction": round(float(v_sgm.float().mean()), 5),
          "points_valid": int(pc.valid.sum()), "rmse_vs_plain_px": rmse_plain,
          "rmse_vs_truth": truth})
    del u, vp, pc_p, d_sgm, v_sgm
    all_launches = {"slice": launches}

    # ---- headline: bench.py:build_headline's raw pair -> two-pass warp x2
    # -> tuned SGM-4 + WLS -> cloud with the BGR color stream
    mx, my = synthetic_maps(H, W)
    imx, imy = inverse_maps(H, W)
    raw_l = torch.tensor(remap_replicate(rect_l.astype(np.float32), imx, imy), device=dev)
    raw_r = torch.tensor(remap_replicate(rect_r.astype(np.float32), imx, imy), device=dev)
    t0 = time.perf_counter()
    plan = warp.build_remap_plan(mx, my, device=dev)
    plan_s = time.perf_counter() - t0

    def headline():
        lg = warp.remap_two_pass_cuda(raw_l, plan)
        rg = warp.remap_two_pass_cuda(raw_r, plan)
        disp, valid = compute_disparity(lg, rg, m, w, True)
        col = color_bgr.flip(-1).to(torch.float32) / 255.0
        pc = backproject_disparity(disp, st.Q, color=col, assume_standard_q=True)
        return lg, rg, disp, valid, pc

    (lg, rg, disp, valid, pc), launches = counted(
        headline, {"K1": 4, "K2": 1, "K3": 1, "K4": 1, "K6": 6})
    stats = frame_stats(*timed_frames(headline))
    lg_p, rg_p = warp.remap_two_pass(raw_l, plan), warp.remap_two_pass(raw_r, plan)
    check(torch.equal(lg, lg_p) and torch.equal(rg, rg_p), "headline: warp differs from plain")
    u, vp = plain_disparity(lg_p, rg_p, m, w, 4)
    rmse_plain = against(disp, valid, u, u > 0, "headline")
    check(rmse_plain <= 1e-3, f"headline: RMSE against the plain frame {rmse_plain}")
    d_sgm, v_sgm = sgm_cuda.sgm_disparity_cuda(lg, rg, **sgm_kw(m, 4))
    truth = truth_of(disp, valid, d_sgm, v_sgm, "headline")
    check(pc.points.shape == (H * W, 3) and bool(torch.isfinite(pc.points[pc.valid]).all()),
          "headline cloud")
    stages_ms = {
        "warp": cuda_ms(lambda: (warp.remap_two_pass_cuda(raw_l, plan),
                                 warp.remap_two_pass_cuda(raw_r, plan)), KERNEL_RUNS),
        "sgm": cuda_ms(lambda: sgm_cuda.sgm_disparity_cuda(lg, rg, **sgm_kw(m, 4)), KERNEL_RUNS),
        "wls": cuda_ms(lambda: wls_cuda.wls_refine_cuda(d_sgm, v_sgm, lg, w.lam, w.sigma_color,
                                                        w.iterations), KERNEL_RUNS),
        "cloud": cuda_ms(lambda: backproject_disparity(disp, st.Q, color=color_rgb,
                                                       assume_standard_q=True), KERNEL_RUNS),
    }
    emit({"phase": "headline", "shape": [H, W, D], **stats,
          "stages_ms": {k: round(v, 3) for k, v in stages_ms.items()},
          "plan_build_s": round(plan_s, 3), "launches": launches,
          "plan_valid_fraction": round(float(plan.valid.float().mean()), 5),
          "valid_fraction": round(float(valid.float().mean()), 5),
          "sgm_valid_fraction": round(float(v_sgm.float().mean()), 5),
          "points_valid": int(pc.valid.sum()), "rmse_vs_plain_px": rmse_plain,
          "rmse_vs_truth": truth})
    all_launches["headline"] = launches
    del lg_p, rg_p, u, vp, d_sgm, v_sgm, disp, valid, pc

    # ---- pipeline: DepthPipeline.process on an in-memory rig
    t0 = time.perf_counter()
    pipe = DepthPipeline(pipeline_rig(), (W, H), m, w, device=dev)
    init_s = time.perf_counter() - t0
    check(pipe.plans is not None, "pipeline: the rig's maps are not row-monotonic")
    (p_disp, p_depth, p_vis), launches = counted(
        lambda: pipe.process(raw_l, raw_r), {"K1": 4, "K2": 1, "K3": 1, "K4": 1, "K6": 6})
    check(p_disp.shape == (H, W) and p_depth.shape == (H, W) and p_vis.shape == (H, W, 3),
          "pipeline output shapes")
    check(bool(torch.isfinite(p_disp).all() and torch.isfinite(p_depth).all()
               and torch.isfinite(p_vis).all()), "pipeline: finite output")
    plg = warp.remap_two_pass(raw_l, pipe.plans[0])
    prg = warp.remap_two_pass(raw_r, pipe.plans[1])
    u, vp = plain_disparity(plg, prg, m, w, 4)
    rmse_pipe = against(p_disp, p_disp > 0, u, u > 0, "pipeline")
    check(torch.allclose(p_depth, disparity_to_depth(u, pipe.Q), rtol=1e-3, atol=1e-4),
          "pipeline: depth differs from the plain frame")
    stats = frame_stats(*timed_frames(lambda: pipe.process(raw_l, raw_r)))
    emit({"phase": "pipeline", "shape": [H, W, D], **stats, "init_s": round(init_s, 3),
          "launches": launches,
          "plan_shift_bounds": [pipe.plans[0].v_resid_bound, pipe.plans[0].h_resid_bound,
                                pipe.plans[0].v_coarse_bits, pipe.plans[0].h_coarse_bits],
          "valid_fraction": round(float((p_disp > 0).float().mean()), 5),
          "rmse_vs_plain_px": rmse_pipe})
    all_launches["pipeline"] = launches
    del pipe, plg, prg, u, vp, p_disp, p_depth, p_vis

    # ---- accurate: SGM-8 with P2 = 128 * w^2 on the rectified pair
    m8 = dataclasses.replace(StereoMatcherConfig.accurate(num_disparities=D, block_size=5),
                             backend="cuda")
    check(m8.mode == "sgm8" and m8.p2() == 3200, "accurate config")

    def accurate():
        disp, valid = compute_disparity(gl, gr, m8, w, True)
        pc = backproject_disparity(disp, st.Q, color=color_rgb, assume_standard_q=True)
        return disp, valid, pc

    (disp, valid, pc), launches = counted(
        accurate, {"K2": 1, "K3": 1, "K5": 2, "K4": 1, "K6": 6})
    stats = frame_stats(*timed_frames(accurate))
    u, vp = plain_disparity(gl, gr, m8, w, 8)
    rmse_plain = against(disp, valid, u, u > 0, "accurate")
    d_sgm, v_sgm = sgm_cuda.sgm_disparity_cuda(gl, gr, **sgm_kw(m8, 8))
    truth = truth_of(disp, valid, d_sgm, v_sgm, "accurate")
    emit({"phase": "accurate", "shape": [H, W, D], "mode": m8.mode, "p2": m8.p2(), **stats,
          "sgm_ms": round(cuda_ms(lambda: sgm_cuda.sgm_disparity_cuda(gl, gr, **sgm_kw(m8, 8)),
                                  KERNEL_RUNS), 3),
          "launches": launches, "valid_fraction": round(float(valid.float().mean()), 5),
          "sgm_valid_fraction": round(float(v_sgm.float().mean()), 5),
          "rmse_vs_plain_px": rmse_plain, "rmse_vs_truth": truth})
    all_launches["accurate"] = launches
    del u, vp, d_sgm, v_sgm, disp, valid, pc

    # ---- standalone: aggregate_and_finalize without v1 (K14's scans), on
    # the slice's cost volume, against the fused route that gets v1 from K2
    planes = sgm_cuda.prefilter_planes(gl, gr, m.pre_filter_cap)
    cost_k, v1_k = sgm_cuda.cost_fwd_down(gl, gr, D, 0, m.block_size, m.pre_filter_cap, p1, p2,
                                          HP, WP, DP, True, planes=planes)
    fin = (p1, p2, D, m.uniqueness_ratio, m.disp12_max_diff, m.subpixel, W)
    (d_s, v_s), launches = counted(lambda: sgm_cuda.aggregate_and_finalize(cost_k, *fin),
                                   {"K14 fwd": 1, "K14 down": 1, "K3": 1, "K4": 1})
    d_f, v_f = sgm_cuda.aggregate_and_finalize(cost_k, *fin, v1=v1_k.clone())
    check(torch.equal(v_s, v_f) and torch.equal(d_s[v_f], d_f[v_f]),
          "standalone: differs from the fused route")
    emit({"phase": "standalone", "launches": launches,
          "valid_fraction": round(float(v_s.float().mean()), 5)})
    all_launches["standalone"] = launches
    del d_s, v_s, d_f, v_f

    # ---- kernels against their plain versions, on their paths' inputs
    rows = []
    n_el = HP * WP * DP
    cost_b, v1_b = HP * WP * DP * 2, HP * WP * DP * 4

    def row(name, source, replaces, launches, err, ms, plain_ms, bound, library_ms=None,
            **extra):
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches, max_abs_err=err, ms=round(ms, 4),
                         plain_ms=round(plain_ms, 4), bound_ms=round(bound[0], 4),
                         bound_by=bound[1],
                         library_ms=None if library_ms is None else round(library_ms, 4),
                         **extra))

    slice_n = all_launches["slice"]

    # K1, one row per pass, on the headline's raw left image. Each
    # remap_two_pass_cuda call launches each pass once, so a pass's count
    # is half of K1's. The yardstick is one grid_sample over the same maps:
    # the single-pass bilinear remap, a different function from the
    # two-pass one (on this card gathers are cheap).
    t_k = warp.resample_pass(raw_l, plan.vy, plan.v_coarse, plan.v_coarse_bits,
                             plan.v_resid_bound, 0)
    grid = torch.stack([torch.tensor(mx, device=dev) * (2.0 / (W - 1)) - 1.0,
                        torch.tensor(my, device=dev) * (2.0 / (H - 1)) - 1.0], -1)[None]
    grid_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
        raw_l[None, None], grid, mode="bilinear", padding_mode="zeros", align_corners=True),
        KERNEL_RUNS)
    passes = (("vertical", raw_l, plan.vy, plan.v_coarse, plan.v_coarse_bits, plan.v_resid_bound,
               0, None), ("horizontal", t_k, plan.hx, plan.h_coarse, plan.h_coarse_bits,
                          plan.h_resid_bound, 1, plan.valid))
    for name, src, coord, coarse, bits, bound_r, axis, mask in passes:
        args = (src, coord, coarse, bits, bound_r, axis, mask)
        out_k = warp.resample_pass(*args)
        out_q = warp.resample_pass_plain(*args)
        check(torch.equal(out_k, out_q), f"K1 {name} pass differs from its plain version")
        nbytes = 3 * H * W * 4 + coarse.numel() * 4 + (0 if mask is None else H * W)
        row(f"K1 resample_pass {name}", "recon3d_tpu_torch/csrc/warp_resample.cu",
            f"recon3d_tpu/ops/warp.py:{266 if axis == 0 else 276}",
            all_launches["headline"]["K1"] // 2, float((out_k - out_q).abs().max()),
            cuda_ms(lambda: warp.resample_pass(*args), KERNEL_RUNS),
            cuda_ms(lambda: warp.resample_pass_plain(*args), PLAIN_RUNS),
            bound_ms(nbytes, 14 * H * W), grid_ms,
            library="torch.nn.functional.grid_sample, bilinear, zeros, align_corners: the "
                    "single-pass remap of the whole frame, not the same function")
    del t_k, out_k, out_q, grid

    # K2
    k2 = lambda: sgm_cuda.cost_fwd_down(gl, gr, D, 0, m.block_size, m.pre_filter_cap, p1, p2,
                                        HP, WP, DP, True, planes=planes)
    k2p = lambda: sgm_cuda.cost_fwd_down_plain(planes, HP, WP, DP, D, 0, m.block_size, p1, p2)
    cost_q, v1_q = k2p()
    check(torch.equal(cost_k, cost_q), "K2 cost differs from its plain version")
    check(torch.equal(v1_k, v1_q), "K2 v1 differs from its plain version")
    err = max(float((cost_k.float() - cost_q.float()).abs().max()),
              float((v1_k - v1_q).abs().max()))
    # and on the headline's warped pair, whose gray levels are not integers
    planes_w = sgm_cuda.prefilter_planes(lg, rg, m.pre_filter_cap)
    cost_w, v1_w = sgm_cuda.cost_fwd_down(lg, rg, D, 0, m.block_size, m.pre_filter_cap, p1, p2,
                                          HP, WP, DP, True, planes=planes_w)
    cost_q, v1_q = sgm_cuda.cost_fwd_down_plain(planes_w, HP, WP, DP, D, 0, m.block_size, p1,
                                                p2)
    check(torch.equal(cost_w, cost_q) and torch.equal(v1_w, v1_q),
          "K2 differs from its plain version on the warped pair")
    del cost_q, v1_q, cost_w, v1_w, planes_w
    row("K2 cost_fwd_down", "recon3d_tpu_torch/csrc/sgm_cost.cu",
        "recon3d_tpu/depth/sgm_pallas.py:985", slice_n["K2"], err, cuda_ms(k2, KERNEL_RUNS),
        cuda_ms(k2p, PLAIN_RUNS), bound_ms(6 * H * W * 4 + cost_b + v1_b, 30 * n_el))

    # K14: the standalone forward scan and the downward scan, on K2's cost
    std_n = all_launches["standalone"]
    v_k = sgm_cuda.fwd_scan(cost_k, p1, p2)
    v_q = sgm_cuda.fwd_scan_plain(cost_k, p1, p2)
    check(torch.equal(v_k, v_q), "K14 forward scan differs from its plain version")
    row("K14 fwd_scan", "recon3d_tpu_torch/csrc/sgm_scan.cu",
        "recon3d_tpu/depth/sgm_pallas.py:1067", std_n["K14 fwd"],
        float((v_k - v_q).abs().max()), cuda_ms(lambda: sgm_cuda.fwd_scan(cost_k, p1, p2),
                                                KERNEL_RUNS),
        cuda_ms(lambda: sgm_cuda.fwd_scan_plain(cost_k, p1, p2), PLAIN_RUNS),
        bound_ms(cost_b + v1_b, 8 * n_el))
    d_k = sgm_cuda.down_accumulate(cost_k, v_k.clone(), p1, p2)
    d_q = sgm_cuda.down_accumulate_plain(cost_k, v_k.clone(), p1, p2)
    check(torch.equal(d_k, d_q), "K14 downward scan differs from its plain version")
    check(torch.equal(d_k, v1_k), "K14 fwd + down differ from K2's v1")
    row("K14 down_accumulate", "recon3d_tpu_torch/csrc/sgm_scan.cu",
        "recon3d_tpu/depth/sgm_pallas.py:1077", std_n["K14 down"],
        float((d_k - d_q).abs().max()),
        cuda_ms(lambda v: sgm_cuda.down_accumulate(cost_k, v, p1, p2), KERNEL_RUNS,
                lambda: (v_k.clone(),)),
        cuda_ms(lambda v: sgm_cuda.down_accumulate_plain(cost_k, v, p1, p2), PLAIN_RUNS,
                lambda: (v_k.clone(),)),
        bound_ms(cost_b + 2 * v1_b, 9 * n_el))
    del v_k, v_q, d_k, d_q

    # K3 (in place on v1: every run gets a fresh copy, made outside the timing)
    v3_k = sgm_cuda.bwd_accumulate(cost_k, v1_k.clone(), p1, p2)
    v3_q = sgm_cuda.bwd_accumulate_plain(cost_k, v1_k.clone(), p1, p2)
    check(torch.equal(v3_k, v3_q), "K3 v3 differs from its plain version")
    err = float((v3_k - v3_q).abs().max())
    del v3_q
    row("K3 bwd_accumulate", "recon3d_tpu_torch/csrc/sgm_bwd.cu",
        "recon3d_tpu/depth/sgm_pallas.py:1094", slice_n["K3"], err,
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
        "recon3d_tpu/depth/sgm_pallas.py:1135", slice_n["K4"], err,
        cuda_ms(lambda v: sgm_cuda.vfinalize(cost_k, v, *args), KERNEL_RUNS,
                lambda: (v3_k.clone(),)),
        cuda_ms(lambda v: sgm_cuda.vfinalize_plain(cost_k, v, *args), PLAIN_RUNS,
                lambda: (v3_k.clone(),)),
        bound_ms(cost_b + v1_b + HP * WP * 8, 16 * n_el))
    del cost_k, v3_k, d_q, val_q

    # K5, one row per vertical direction, on the accurate frame's cost and
    # v3 (P2 = 3200). Each 8-direction frame adds the downward pair once and
    # the upward pair once, so a direction's count is half of K5's.
    p2_8 = float(m8.p2())
    cost8, v8 = sgm_cuda.cost_fwd_down(gl, gr, D, 0, m8.block_size, m8.pre_filter_cap, p1,
                                       p2_8, HP, WP, DP, True, planes=planes)
    v8 = sgm_cuda.bwd_accumulate(cost8, v8, p1, p2_8)
    for vertical in ("down", "up"):
        out_k = sgm_cuda.diag_accumulate(cost8, v8.clone(), p1, p2_8, vertical)
        out_q = sgm_cuda.diag_accumulate_plain(cost8, v8.clone(), p1, p2_8, vertical)
        check(torch.equal(out_k, out_q), f"K5 {vertical} differs from its plain version")
        row(f"K5 diag_accumulate {vertical}", "recon3d_tpu_torch/csrc/sgm_diag.cu",
            "recon3d_tpu/depth/sgm_pallas.py:1111", all_launches["accurate"]["K5"] // 2,
            float((out_k - out_q).abs().max()),
            cuda_ms(lambda v: sgm_cuda.diag_accumulate(cost8, v, p1, p2_8, vertical),
                    KERNEL_RUNS, lambda: (v8.clone(),)),
            cuda_ms(lambda v: sgm_cuda.diag_accumulate_plain(cost8, v, p1, p2_8, vertical),
                    PLAIN_RUNS, lambda: (v8.clone(),)),
            bound_ms(cost_b + 2 * v1_b, 2 * 9 * n_el))
        del out_k, out_q
    del cost8, v8

    # K6: the first sweep's horizontal and vertical solves of the frame's WLS
    d_sgm, v_sgm = sgm_cuda.sgm_disparity_cuda(gl, gr, **sgm_kw(m, 4))
    conf = v_sgm.to(torch.float32)
    u0 = torch.where(v_sgm, d_sgm, 0.0)
    lt = lambda_schedule(w.lam, w.iterations)[0]
    wx, wy = _edge_weights(gl, 1, w.sigma_color), _edge_weights(gl, 0, w.sigma_color)
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
        "recon3d_tpu/depth/wls_pallas.py:102", slice_n["K6"], err, sum(times) / 2,
        sum(plain_times) / 2, bound_ms(5 * H * W * 4, 10 * H * W),
        ms_axis1=round(times[0], 4), ms_axis0=round(times[1], 4))

    emit({"kernels": rows})
    print(smi, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(f"# wall {time.perf_counter() - t_start:.1f} s", file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
