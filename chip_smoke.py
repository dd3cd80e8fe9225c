#!/usr/bin/env python3
"""Drive recon3d_tpu_torch's depth, point-cloud and fusion paths on one NVIDIA H100
and hold every kernel on them to its plain PyTorch version.

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
              slice's frame and the BGR color stream's cloud; a line before
              it (headline_profile) gives the frame's device busy share and
              kernel time by name under torch.profiler over 3 frames, and
              the device ms of the fused K4 and its LR check a frame;
  pipeline    one DepthPipeline.process at 1920x1080 on an in-memory rig
              with radial distortion and small rectifying rotations;
  accurate    the accurate() preset (SGM-8, P2 = 128 * 25) on the rectified
              pair;
  standalone  aggregate_and_finalize without v1, whose forward and downward
              paths then run as the standalone scans (K14), against the call
              with v1 (left as it was) and its fuse_bwd variant (K3 then K4);
  rowsharded  the rectified pair through sgm_disparity_cuda_rowsharded on a
              4-shard in-process row mesh on this one card (1080 rows pad to
              1088: 272 a shard, the last one's final 8 dead): K2, K13, the
              carry relays (K10) and K12 on each shard, the shards one after
              another (serialized, not a scaling number); bitwise against the
              single-device kernel path;
  rowsharded_accurate  the same with the accurate() preset (SGM-8: K11's
              diagonal relays too);
  batched     parallel/batch.py:batched_depth of 4 frames (render(0..3)) with
              the tuned matcher and WLS over a 4-shard in-process frame mesh:
              each frame bitwise against compute_disparity, the psum mean
              against a host recomputation;
  scan_post   the post-scan chain of pipeline/scanner.py:179-180 at its
              defaults on SyntheticRGBDCamera(640, 480) frame 0:
              pointcloud_from_rgbd -> PointCloudProcessing() (voxel 0.0025,
              compact to 2^18, statistical 30 / 1.2, radius 16 / 0.01) ->
              NormalEstimation() (grid path G = 128, C = 8: K7 + K8 fused,
              then orient_normals_consistent(10, 100)); per-stage CUDA-event
              ms, point counts, overflow, peak memory, the chain with K7 / K8
              replaced by their plain versions, normals against the plane;
  normals_1m  tools/bench_pointops.py's normals case: 1M uniform unit-cube
              points, radius 0.02, G = 52, C = 16, through estimate_normals;
  moments_1m  grid_pca_moments_cuda on the same cloud (K8's moments variant);
  normals_10m 10M points, radius 0.008, G = 128, C = 16: the kernel path timed;
  voxel_10m   tools/bench_pointops.py's voxel case: 10M points, voxel 0.05,
              capacity 2^14 (plain torch, timed);
  fusion      dense TSDF fusion at FusionConfig()'s defaults (256^3, voxel
              0.004, sdf_trunc 0.02, depth_trunc 3, color) of 30
              SyntheticRGBDCamera(640, 480) frames at their true poses, one
              K9 launch a frame: integrate ms per frame, the 30-frame fuse,
              peak memory, the volume from K9's plain version (bitwise), and
              extract_point_cloud's points against the sphere and the plane;
  mesh        Scanner3D.extract_mesh / save_mesh's steps on the fused volume:
              extract_triangle_mesh (at the JAX package's own budget, 2^19),
              filter_smooth_laplacian x 5, cleanup + compute_vertex_normals,
              the binary PLY write; ms, counts, drops, the mesh of the plain
              K9 volume (equal) and the vertices against the scene;
  kernels     each kernel against its plain version on its path's own
              inputs (bitwise: K2 on the rectified and the warped pair, with
              and without the downward path; K6 on both axes), its median
              CUDA-event time over 10 launches, the plain version's median
              over 3, the least time the card could take (bound_ms) and,
              where one PyTorch call computes the same or the yardstick
              function, that call's time (library_ms); K2 also its two
              stages (the walk, the forward scan) apart and its call
              without the downward path, K6 each axis; K4 (v3 read only,
              checked) and K12 bitwise, each also timed without the LR
              check (no right view).
Each path runs once with every launch counter at 0 before it, and the
counts it leaves must be the path's kernels exactly. The frames record fps
(median of 10 frames after 2 warm-ups), peak memory (a single-device frame
may add at most its cost and path volumes and half a path volume to what
was live before it, and the row-sharded aggregation a few carry planes:
no volume is copied), RMSE against the same
frame built from the plain versions on the card, and RMSE against the
analytic disparity under sanity bars. Then the card's nvidia-smi line and,
last, the result line. Any failed comparison or exception exits nonzero
without the result line; a hung kernel ends the run through the
faulthandler watchdog. Without a CUDA card, or outside the repository, it
exits nonzero before any result.
"""
import dataclasses
import faulthandler
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

BUDGET_S = 300  # whole-run watchdog: a hang exits nonzero with a traceback
DEVICE = "cuda"  # the card; a rehearsal of the script on the CPU sets "cpu"
H, W, D = 1080, 1920, 128
FOCAL, BASELINE = 1050.0, 0.06
KERNEL_RUNS, PLAIN_RUNS, FRAMES, WARMUP = 10, 3, 10, 2
PROFILE_FRAMES = 3  # headline frames under torch.profiler
ROW_SHARDS, BATCH = 4, 4  # the row mesh of one frame; the frames of the batched phase
# the point-cloud phases: scanner.py:179-180's chain on a 640x480 frame and
# tools/bench_pointops.py's cases (bench.py:698-729, 952-976)
SCAN_W, SCAN_H, SCAN_RUNS = 640, 480, 5
NORMALS_1M = dict(n=1_000_000, radius=0.02, grid_size=52, cell_capacity=16, runs=5)
NORMALS_10M = dict(n=10_000_000, radius=0.008, grid_size=128, cell_capacity=16, runs=3)
VOXEL_10M = dict(n=10_000_000, voxel_size=0.05, capacity=1 << 14, runs=3)
# the fusion phases: FusionConfig()'s 256^3 volume fed the capture camera's
# 640x480 frames (config.py:120, 160-169); the origin holds the sphere (z 0.9
# to 1.5) and the plane z = 1.8, half a voxel off any plane of voxel centers
FUSION = dict(width=640, height=480, frames=30, origin=(-0.512, -0.512, 0.902),
              point_capacity=1 << 18, mesh_runs=3)
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



def device_profile(fn, top=6, calls=1):
    """One call of fn, which makes `calls` calls of a path, under
    torch.profiler: its wall ms (host clock, to a synchronize), the kernels'
    summed device ms, the device's busy share and the `top` kernels by
    device time, the times per call of the path; (None, {}) when the trace
    holds no device time. Also returns the device microseconds by kernel
    name (over all calls)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_us = {}
    for e in prof.key_averages():
        t_us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        if e.key and t_us and not e.key.startswith(("aten::", "cuda", "Memcpy", "Memset")):
            dev_us[e.key] = t_us
    if not dev_us:
        return None, {}
    total = sum(dev_us.values()) / 1e3
    ranked = sorted(dev_us.items(), key=lambda kv: -kv[1])[:top]
    return ({"wall_ms": round(wall / calls, 4), "device_ms": round(total / calls, 4),
             "busy_share": round(total / wall, 4), "kernels": len(dev_us),
             "top_ms": [[k[:100], round(t / 1e3 / calls, 4)] for k, t in ranked]}, dev_us)


# the finalize kernels of csrc/sgm_vfinalize.cu, by a part of their symbol
FINALIZE_KERNELS = {"K4 scan + finalize": "ScanFeed", "K12 finalize": "MemFeed",
                    "K4 / K12 LR check": "lr_check_kernel"}


def finalize_ms(dev_us, calls=1):
    """Device ms a call of each finalize kernel, from device_profile's
    microseconds by kernel name."""
    return {k: round(sum(t for n, t in dev_us.items() if part in n) / 1e3 / calls, 4)
            for k, part in FINALIZE_KERNELS.items()}


def unit_cube_cloud(n, dev):
    """tools/bench_pointops.py's cloud: n uniform unit-cube points from
    np.random.RandomState(0), all valid."""
    import numpy as np
    import torch

    from recon3d_tpu_torch.utils.types import PointCloud

    pts = np.random.RandomState(0).rand(n, 3).astype(np.float32)
    return PointCloud(points=torch.tensor(pts, device=dev),
                      valid=torch.ones(n, dtype=torch.bool, device=dev))


def plain_grid_normals(points, valid, radius, G, C):
    """normals._grid_normals with K7 and K8 replaced by their plain
    versions; returns (normals (N, 3), per-point neighbor count)."""
    import torch

    from recon3d_tpu_torch.ops import grid_knn, grid_knn_cuda

    pk, slot, _ = grid_knn._bin_points_packed(points, valid, radius, G, C)
    r = torch.tensor(radius, dtype=torch.float32)
    chan, has = grid_knn_cuda.packed_chan_readback(
        grid_knn.core_plain(pk, float(r * r), G, C, True), slot)
    v = torch.stack([chan(0), chan(1), chan(2)], -1)
    fallback = torch.tensor([0.0, 0.0, 1.0], device=points.device)
    return torch.where(has[:, None], v, fallback), torch.where(has, chan(3), 0.0)


def normals_agree(a, b, well, signed, what):
    """The normals bars: |dot| (or the signed dot) median > 0.99999 and
    > 0.999 on at least 99 % of the `well` points; returns the numbers."""
    import torch

    dots = (a[well] * b[well]).sum(-1)
    if not signed:
        dots = dots.abs()
    out = {"points": int(well.sum()), "dot_median": float(dots.median()),
           "share_above_0.999": float((dots > 0.999).float().mean()),
           "bitwise": bool(torch.equal(a, b))}
    check(out["points"] > 0 and out["share_above_0.999"] >= 0.99
          and (signed or out["dot_median"] > 0.99999), f"{what}: normals differ: {out}")
    return out


def k8_operations(pk, counts, G, C, fused):
    """The f32 operations K8 needs on this table: 9 for each candidate test
    (3 subtractions, 3 products, 2 sums, 1 compare) an occupied query makes
    against the occupied slots of its in-grid neighbor cells, 16 for each
    in-radius candidate (10 sums, 6 products), and with `fused` ~220 for the
    normalization and eigen-solve of each occupied slot."""
    import torch

    occ = pk[:, 3].reshape(G, G, G, C).sum(-1).double()
    padded = torch.nn.functional.pad(occ, (1, 1, 1, 1, 1, 1))
    nbr = sum(padded[1 + dx:1 + dx + G, 1 + dy:1 + dy + G, 1 + dz:1 + dz + G]
              for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))
    tests = float((occ * nbr).sum())
    occupied = float(occ.sum())
    return 9 * tests + 16 * float(counts.double().sum()) + (220 * occupied if fused else 0.0)



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
    from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
    from recon3d_tpu_torch.normal_estimation import NormalEstimation
    from recon3d_tpu_torch.ops import grid_knn, grid_knn_cuda, warp
    from recon3d_tpu_torch.pointcloud import normals, outliers, voxel
    from recon3d_tpu_torch.pointcloud.backproject import (backproject_disparity,
                                                          pointcloud_from_rgbd)
    from recon3d_tpu_torch.pointcloud_processing import PointCloudProcessing
    from recon3d_tpu_torch.utils.types import CameraIntrinsics, compact
    from recon3d_tpu_torch.config import FusionConfig, MeshConfig
    from recon3d_tpu_torch.camera.fake import FakeStereoCamera
    from recon3d_tpu_torch.depth import sgm_sharded
    from recon3d_tpu_torch.parallel import batch as pbatch
    from recon3d_tpu_torch.parallel.mesh import make_mesh
    from recon3d_tpu_torch.fusion import marching, tsdf
    from recon3d_tpu_torch.mesh import ops as mesh_ops
    from recon3d_tpu_torch.ops import project_sample, project_sample_cuda
    from recon3d_tpu_torch.utils import io as ply_io

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
                "K14 fwd": sgm_cuda.fwd_scan, "K14 down": sgm_cuda.down_accumulate,
                "K7": grid_knn_cuda.pack_cells, "K8": grid_knn_cuda.core_call,
                "K9": project_sample_cuda.sample_images_cuda,
                "K10": sgm_cuda.vscan_carry, "K11": sgm_cuda.diag_carry,
                "K12": sgm_cuda.wta_finalize, "K13": sgm_sharded.bwd_accumulate_shard}

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

    def timed_frames(frame, runs=FRAMES, warmup=WARMUP):
        """Host-clock ms of `runs` frames after `warmup`, each ending in a
        synchronize, the peak device memory of those frames and the bytes
        live before them."""
        for _ in range(warmup):
            frame()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev)
        ms = []
        for _ in range(runs):
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms, torch.cuda.max_memory_allocated(dev), live

    def frame_stats(ms, peak, live, what=None):
        """The frame times and memory; a single-device frame (`what`) may add
        at most its cost and path volumes and half a path volume to what was
        live before it: a copy of a volume would exceed that."""
        med = statistics.median(ms)
        if what is not None:
            check(peak - live < cost_b + v1_b + v1_b // 2,
                  f"{what}: peak {peak - live} B over the live bytes: a volume was copied")
        return {"fps": round(1e3 / med, 3), "frame_ms_median": round(med, 3),
                "frame_ms": [round(t, 3) for t in ms], "peak_mem_bytes": peak,
                "mem_live_before_bytes": live, "frame_extra_peak_bytes": peak - live}

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
    cost_b, v1_b = HP * WP * DP * 2, HP * WP * DP * 4  # the frame's int16 cost, f32 path volume
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
    stats = frame_stats(*timed_frames(frame), "slice")
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
    stats = frame_stats(*timed_frames(headline), "headline")
    # the frame's device busy share and kernel time by name, a frame
    prof, dev_us = device_profile(lambda: [headline() for _ in range(PROFILE_FRAMES)], top=16,
                                  calls=PROFILE_FRAMES)
    emit({"phase": "headline_profile", "frames": PROFILE_FRAMES, "per_frame": prof,
          "finalize_ms": finalize_ms(dev_us, PROFILE_FRAMES)})
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
    stats = frame_stats(*timed_frames(lambda: pipe.process(raw_l, raw_r)), "pipeline")
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
    stats = frame_stats(*timed_frames(accurate), "accurate")
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
    v1_in = v1_k.clone()
    d_f, v_f = sgm_cuda.aggregate_and_finalize(cost_k, *fin, v1=v1_k)
    check(torch.equal(v1_k, v1_in), "standalone: aggregate_and_finalize changed the caller's v1")
    del v1_in
    check(torch.equal(v_s, v_f) and torch.equal(d_s[v_f], d_f[v_f]),
          "standalone: differs from the fused route")
    # the JAX package's fuse_bwd variant: K3 then K4, bitwise the same
    (d_b, v_b), launches_bwd = counted(
        lambda: sgm_cuda.aggregate_and_finalize(cost_k, *fin, v1=v1_k, fuse_bwd=True),
        {"K3": 1, "K4": 1})
    check(torch.equal(v_b, v_f) and torch.equal(d_b, d_f),
          "standalone: fuse_bwd differs from fuse_bwd=False")
    emit({"phase": "standalone", "launches": launches, "fuse_bwd_launches": launches_bwd,
          "fuse_bwd_bitwise": True, "v1_left_intact": True,
          "valid_fraction": round(float(v_s.float().mean()), 5)})
    all_launches["standalone"] = launches
    all_launches["standalone_fuse_bwd"] = launches_bwd
    del d_s, v_s, d_f, v_f, d_b, v_b

    # ---- rowsharded, rowsharded_accurate: one frame's rows over a 4-shard
    # in-process mesh on this card, against the single-device kernel path
    row_mesh = make_mesh(ROW_SHARDS, ("row",), device=dev)
    for name, mc, ndir, want in (
            ("rowsharded", m, 4, {"K2": 4, "K13": 4, "K10": 8, "K12": 4}),
            ("rowsharded_accurate", m8, 8, {"K2": 4, "K13": 4, "K10": 8, "K11": 8, "K12": 4})):
        kw = sgm_kw(mc, ndir)

        def sharded():
            return sgm_sharded.sgm_disparity_cuda_rowsharded(gl, gr, row_mesh, **kw)

        (d_s, v_s), launches = counted(sharded, want)
        stats = frame_stats(*timed_frames(sharded))
        prof, dev_us = device_profile(sharded, top=8)
        d_1, v_1 = sgm_cuda.sgm_disparity_cuda(gl, gr, **kw)
        check(torch.equal(d_s, d_1) and torch.equal(v_s, v_1),
              f"{name}: differs from the single-device kernel path")
        # the relays work in place on the shards' volumes: aggregating adds
        # no more than carry planes to what the shards hold
        sh = sgm_sharded.shard_volumes(gl, gr, row_mesh, D, 0, mc.block_size, mc.pre_filter_cap,
                                       p1, float(mc.p2()))
        torch.cuda.synchronize()
        agg_live = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        sgm_sharded.aggregate(sh, p1, float(mc.p2()), ndir)
        torch.cuda.synchronize()
        agg_extra = torch.cuda.max_memory_allocated(dev) - agg_live
        check(agg_extra < sh.S[0].numel() * 4 // 2,
              f"{name}: aggregating the shards added {agg_extra} B: a volume was copied")
        del sh
        emit({"phase": name, "shape": [H, W, D], "mode": mc.mode, "p2": mc.p2(),
              "shards": ROW_SHARDS, "transport": "in-process, one card: shards serialized",
              **stats, "single_device_sgm_ms": round(cuda_ms(
                  lambda: sgm_cuda.sgm_disparity_cuda(gl, gr, **kw), KERNEL_RUNS), 3),
              "aggregate_extra_peak_bytes": agg_extra,
              "profiled_frame": prof,
              "finalize_ms": finalize_ms(dev_us), "launches": launches,
              "equal_to_single_device": True,
              "valid_fraction": round(float(v_s.float().mean()), 5)})
        all_launches[name] = launches
        del d_s, v_s, d_1, v_1

    # ---- batched: batched_depth of 4 frames over a 4-shard frame mesh
    cam4 = FakeStereoCamera(width=W, height=H, focal=FOCAL, baseline=BASELINE)
    pairs = [cam4.render(k)[:2] for k in range(BATCH)]
    ls, rs = (torch.tensor(np.stack([p[i] for p in pairs]), dtype=torch.float32, device=dev)
              for i in (0, 1))
    frame_mesh = make_mesh(BATCH, ("frame",), device=dev)
    batched = lambda: pbatch.batched_depth(ls, rs, frame_mesh, m, w)  # noqa: E731
    (b_disp, b_valid, b_mean), launches = counted(
        batched, {"K2": BATCH, "K3": BATCH, "K4": BATCH, "K6": 6 * BATCH})
    ms, peak, live = timed_frames(batched)
    for k in range(BATCH):
        d_1, v_1 = compute_disparity(ls[k], rs[k], m, w, True)
        check(torch.equal(b_disp[k], d_1) and torch.equal(b_valid[k], v_1),
              f"batched: frame {k} differs from compute_disparity")
    d_h, v_h = b_disp.cpu().double().numpy(), b_valid.cpu().numpy()
    mean_host = float(d_h[v_h].sum() / max(v_h.sum(), 1))
    check(abs(float(b_mean) - mean_host) <= 1e-6 * abs(mean_host),
          f"batched: mean {float(b_mean)} against the host's {mean_host}")
    med = statistics.median(ms)
    emit({"phase": "batched", "shape": [H, W, D], "frames": BATCH, "shards": BATCH,
          "transport": "in-process, one card: shards serialized",
          "batch_ms_median": round(med, 3), "batch_ms": [round(t, 3) for t in ms],
          "fps": round(BATCH * 1e3 / med, 3), "peak_mem_bytes": peak,
          "mem_live_before_bytes": live, "launches": launches,
          "frames_equal_to_compute_disparity": True, "mean_disparity": float(b_mean),
          "mean_host": mean_host, "valid_fraction": round(float(b_valid.float().mean()), 5)})
    all_launches["batched"] = launches
    del ls, rs, pairs, b_disp, b_valid, d_1, v_1

    # ---- scan_post: the post-scan chain at its defaults on a 640x480 frame
    cam = SyntheticRGBDCamera(SCAN_W, SCAN_H)
    cam.open()
    color_np, depth_np = cam.grab()
    intr = CameraIntrinsics(cam.fx, cam.fy, cam.cx, cam.cy)
    color_s = torch.tensor(color_np, device=dev)
    depth_s = torch.tensor(depth_np, device=dev)
    proc, nest = PointCloudProcessing(), NormalEstimation()
    pcfg = proc.config
    defaults = inspect.signature(normals.estimate_normals).parameters
    scan_G, scan_C = defaults["grid_size"].default, defaults["cell_capacity"].default

    def scan_post():
        pc = pointcloud_from_rgbd(color_s, depth_s, intr)
        q = proc.process_point_cloud(pc)
        return pc, q, nest.estimate_normals(q)

    (pc, q, o), launches = counted(scan_post, {"K7": 1, "K8": 1})
    all_launches["scan_post"] = launches
    stage_names = ("backproject", "voxel", "compact", "statistical", "radius", "normals",
                   "orient")

    def scan_post_staged():
        """The same chain stage by stage (the functions the shims call),
        with a CUDA event after each stage."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stage_names) + 1)]
        ev[0].record()
        out = [pointcloud_from_rgbd(color_s, depth_s, intr)]
        stages = (lambda c: voxel.voxel_downsample(c, pcfg.voxel_size),
                  lambda c: compact(c, min(c.capacity, pcfg.capacity)),
                  lambda c: outliers.remove_statistical_outliers(
                      c, nb_neighbors=pcfg.outlier_nb_neighbors, std_ratio=pcfg.outlier_std_ratio),
                  lambda c: outliers.remove_radius_outliers(
                      c, nb_points=pcfg.radius_nb_points, radius=pcfg.radius),
                  lambda c: normals.estimate_normals(c, radius=pcfg.normal_radius,
                                                     max_nn=pcfg.normal_max_nn),
                  lambda c: normals.orient_normals_consistent(
                      c, k=nest.consistent_k, iterations=nest.consistent_iterations))
        ev[1].record()
        for i, stage in enumerate(stages):
            out.append(stage(out[-1]))
            ev[i + 2].record()
        torch.cuda.synchronize()
        stage_ms.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
        staged[:] = out

    stage_ms, staged = [], []
    scan_ms, scan_peak, _ = timed_frames(scan_post_staged, SCAN_RUNS, 1)
    stage_ms = stage_ms[1:]  # without the warm-up's
    n_pc = int(pc.valid.sum())
    check(pc.capacity == SCAN_W * SCAN_H and q.capacity == min(staged[1].capacity, pcfg.capacity)
          and q.capacity > normals.GRID_SWITCH, f"scan_post: capacities {pc.capacity} "
          f"{staged[1].capacity} {q.capacity}")
    check(bool(torch.isfinite(o.normals[q.valid]).all()), "scan_post: normals not finite")
    # the normals' inputs and counts, and the chain with K7 / K8 plain
    pk_s, slot_s, overflow_s = grid_knn_cuda.bin_points_packed_cuda(
        q.points, q.valid, pcfg.normal_radius, scan_G, scan_C)
    r2_s = float(torch.tensor(pcfg.normal_radius, dtype=torch.float32) ** 2)
    plain_n, cnt_s = plain_grid_normals(q.points, q.valid, pcfg.normal_radius, scan_G, scan_C)
    o_plain = normals.orient_normals_consistent(
        dataclasses.replace(q, normals=plain_n), k=nest.consistent_k,
        iterations=nest.consistent_iterations)
    well_s = q.valid & (cnt_s >= 5)
    agree_s = normals_agree(o.normals, o_plain.normals, well_s, True, "scan_post vs plain")
    # against the truth: on the plane z = 1.8 (-1.8 after the flip) the
    # normal is +-z wherever a neighborhood spans the plane; a neighborhood
    # whose middle eigenvalue is under 1 % of the largest is a line of
    # points (a cell keeps its first C points in voxel order, one 2.5 mm
    # column of the frame), whose normal is not defined
    (cnt_m, _, cov6), launches = counted(lambda: grid_knn_cuda.grid_pca_moments_cuda(
        q.points, q.valid, pcfg.normal_radius, scan_G, scan_C), {"K7": 1, "K8": 1})
    all_launches["scan_post_moments"] = launches
    check(torch.equal(cnt_m, cnt_s), "scan_post: moments count differs from the fused count")
    plane = well_s & ((q.points[:, 2] + 1.8).abs() < 1e-3)
    c6 = cov6[plane].double().cpu()  # eigenvalues of the plane points' covariances, on the host
    ev = torch.linalg.eigvalsh(torch.stack([torch.stack([c6[:, 0], c6[:, 3], c6[:, 4]], -1),
                                            torch.stack([c6[:, 3], c6[:, 1], c6[:, 5]], -1),
                                            torch.stack([c6[:, 4], c6[:, 5], c6[:, 2]], -1)], -2))
    spread = ev[:, 1] > 0.01 * ev[:, 2]
    along_z = (o.normals[plane, 2].abs() > float(np.cos(np.radians(5.0)))).cpu()
    truth = {"plane_points": int(plane.sum()),
             "plane_within_5deg": float(along_z.float().mean()),
             "plane_spanning": int(spread.sum()),
             "plane_spanning_within_5deg": float(along_z[spread].float().mean())}
    check(truth["plane_spanning"] > 0.5 * truth["plane_points"] > 0
          and truth["plane_spanning_within_5deg"] >= 0.95,
          f"scan_post: normals far from the plane's: {truth}")
    emit({"phase": "scan_post", "frame": [SCAN_H, SCAN_W], "launches": all_launches["scan_post"],
          "ms_median": round(statistics.median(scan_ms), 3), "ms": [round(t, 3) for t in scan_ms],
          "stages_ms": {k: round(statistics.median(r[i] for r in stage_ms), 3)
                        for i, k in enumerate(stage_names)},
          "points": {"frame": n_pc, "voxel": int(staged[1].valid.sum()),
                     "voxel_capacity": staged[1].capacity, "compact": int(staged[2].valid.sum()),
                     "compact_capacity": staged[2].capacity,
                     "statistical": int(staged[3].valid.sum()),
                     "radius": int(staged[4].valid.sum()),
                     "normals_count_ge5": int(well_s.sum())},
          "grid": [scan_G, scan_C], "overflow": float(overflow_s), "peak_mem_bytes": scan_peak,
          "vs_plain": agree_s, "vs_truth": truth,
          "staged_equals_shims": bool(torch.equal(staged[-1].normals, o.normals)
                                      and torch.equal(staged[4].valid, q.valid))})
    del staged, plain_n, o_plain, c6, cov6, ev

    # ---- normals_1m / moments_1m: tools/bench_pointops.py's normals case
    c1m = NORMALS_1M
    pc1 = unit_cube_cloud(c1m["n"], dev)
    nkw = dict(radius=c1m["radius"], grid_size=c1m["grid_size"],
               cell_capacity=c1m["cell_capacity"])
    n1m = lambda: normals.estimate_normals(pc1, max_nn=30, **nkw)  # noqa: E731
    o1, launches = counted(n1m, {"K7": 1, "K8": 1})
    all_launches["normals_1m"] = launches
    ms_1m, peak_1m, _ = timed_frames(n1m, c1m["runs"], 1)
    G1, C1 = c1m["grid_size"], c1m["cell_capacity"]
    pk_1, slot_1, overflow_1 = grid_knn_cuda.bin_points_packed_cuda(pc1.points, pc1.valid,
                                                                    c1m["radius"], G1, C1)
    r2_1 = float(torch.tensor(c1m["radius"], dtype=torch.float32) ** 2)
    plain_1, cnt_1 = plain_grid_normals(pc1.points, pc1.valid, c1m["radius"], G1, C1)
    agree_1 = normals_agree(o1.normals, plain_1, cnt_1 >= 5, False, "normals_1m vs plain")
    emit({"phase": "normals_1m", "n": c1m["n"], "radius": c1m["radius"], "grid": [G1, C1],
          "launches": launches, "ms_median": round(statistics.median(ms_1m), 3),
          "ms": [round(t, 3) for t in ms_1m], "overflow": float(overflow_1),
          "mean_occupancy": round(c1m["n"] / G1 ** 3, 3), "peak_mem_bytes": peak_1m,
          "vs_plain": agree_1})
    del plain_1
    (n_m, mean_m, cov_m), launches = counted(lambda: grid_knn_cuda.grid_pca_moments_cuda(
        pc1.points, pc1.valid, c1m["radius"], G1, C1), {"K7": 1, "K8": 1})
    all_launches["moments_1m"] = launches
    n_q, mean_q, cov_q = grid_knn.grid_pca_moments(pc1.points, pc1.valid, c1m["radius"], G1, C1)
    cov_q6 = torch.stack([cov_q[:, 0, 0], cov_q[:, 1, 1], cov_q[:, 2, 2], cov_q[:, 0, 1],
                          cov_q[:, 0, 2], cov_q[:, 1, 2]], -1)
    err_m = {"mean": float((mean_m - mean_q).abs().max()),
             "cov": float((cov_m - cov_q6).abs().max())}
    # atol 1e-5 relative to the cloud's extent (1 m here)
    check(torch.equal(n_m, n_q) and err_m["mean"] <= 1e-5 and err_m["cov"] <= 1e-5,
          f"moments_1m: differs from the plain route: {err_m}")
    emit({"phase": "moments_1m", "launches": launches, "max_abs_err": err_m,
          "count_mean": round(float(n_m.mean()), 3)})
    del n_m, mean_m, cov_m, n_q, mean_q, cov_q, cov_q6

    # ---- normals_10m: the kernel path at the reference benchmark's scale
    c10 = NORMALS_10M
    pc10 = unit_cube_cloud(c10["n"], dev)
    n10 = lambda: normals.estimate_normals(  # noqa: E731
        pc10, radius=c10["radius"], max_nn=30, grid_size=c10["grid_size"],
        cell_capacity=c10["cell_capacity"])
    o10, launches = counted(n10, {"K7": 1, "K8": 1})
    all_launches["normals_10m"] = launches
    unit = (o10.normals.norm(dim=1) - 1.0).abs() < 1e-4
    check(bool(torch.isfinite(o10.normals).all()) and float(unit.float().mean()) > 0.99,
          "normals_10m: normals not finite unit vectors")
    ms_10, peak_10, _ = timed_frames(n10, c10["runs"], 0)
    emit({"phase": "normals_10m", "n": c10["n"], "radius": c10["radius"],
          "grid": [c10["grid_size"], c10["cell_capacity"]], "launches": launches,
          "ms_median": round(statistics.median(ms_10), 3), "ms": [round(t, 3) for t in ms_10],
          "peak_mem_bytes": peak_10})
    del o10

    # ---- voxel_10m: tools/bench_pointops.py's voxel case (plain torch)
    cv = VOXEL_10M
    v10 = lambda: voxel.voxel_downsample(pc10, cv["voxel_size"],  # noqa: E731
                                         capacity=cv["capacity"])
    vout, launches = counted(v10, {})
    n_vox = int(vout.valid.sum())
    check(0 < n_vox <= 21 ** 3 and vout.capacity == cv["capacity"],
          f"voxel_10m: {n_vox} voxels in a buffer of {vout.capacity}")
    ms_v, peak_v, _ = timed_frames(v10, cv["runs"], 1)
    emit({"phase": "voxel_10m", "n": cv["n"], "voxel_size": cv["voxel_size"],
          "capacity": cv["capacity"], "voxels": n_vox,
          "ms_median": round(statistics.median(ms_v), 3), "ms": [round(t, 3) for t in ms_v],
          "peak_mem_bytes": peak_v})
    del pc10, vout

    # ---- fusion: 30 posed 640x480 frames into FusionConfig()'s 256^3 volume
    fcfg, mcfg, cf = FusionConfig(), MeshConfig(), FUSION
    fcam = SyntheticRGBDCamera(cf["width"], cf["height"], n_frames=cf["frames"])
    fcam.open()
    fintr = CameraIntrinsics(fcam.fx, fcam.fy, fcam.cx, fcam.cy)
    fframes = []
    for k in range(cf["frames"]):
        c_np, d_np = fcam.grab()
        fframes.append((torch.tensor(c_np, device=dev), torch.tensor(d_np, device=dev),
                        torch.tensor(fcam.true_pose(k), dtype=torch.float32, device=dev)))

    def new_volume():
        return tsdf.make_volume(fcfg.grid_resolution, fcfg.voxel_size, fcfg.sdf_trunc,
                                origin=cf["origin"], with_color=fcfg.color, device=dev)

    def fuse(frame_ms=None):
        vol = new_volume()
        for c_t, d_t, pose in fframes:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            vol = tsdf.integrate(vol, d_t, fintr, pose, color=c_t, depth_trunc=fcfg.depth_trunc)
            ev[1].record()
            if frame_ms is not None:
                frame_ms.append(ev)
        return vol

    warm = tsdf.integrate(new_volume(), fframes[0][1], fintr, fframes[0][2],
                          color=fframes[0][0], depth_trunc=fcfg.depth_trunc)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    frame_ev = []
    t0 = time.perf_counter()
    vol_k, launches = counted(lambda: fuse(frame_ev), {"K9": cf["frames"]})
    fuse_ms = (time.perf_counter() - t0) * 1e3
    fuse_peak = torch.cuda.max_memory_allocated(dev)
    all_launches["fusion"] = launches
    frame_ms = [a.elapsed_time(b) for a, b in frame_ev]
    # where a frame's time goes: a profiler trace of the last frame's integrate
    c_t, d_t, pose = fframes[-1]
    prof_frame, dev_us = device_profile(lambda: tsdf.integrate(
        vol_k, d_t, fintr, pose, color=c_t, depth_trunc=fcfg.depth_trunc))
    if prof_frame is not None:
        prof_frame["k9_ms"] = round(sum(t for k, t in dev_us.items()
                                        if "project_sample" in k) / 1e3, 4)
    # the same 30 frames with K9 replaced by its plain version
    sampler = tsdf.sample_images_at
    tsdf.sample_images_at = project_sample.sample_images_plain
    try:
        vol_q, launches = counted(fuse, {})
    finally:
        tsdf.sample_images_at = sampler
    for name in ("tsdf", "weight", "color"):
        check(torch.equal(getattr(vol_k, name), getattr(vol_q, name)),
              f"fusion: {name} differs from the plain-K9 volume")
    pc_f = tsdf.extract_point_cloud(vol_k, capacity=cf["point_capacity"])
    pts_f = pc_f.points[pc_f.valid]

    def scene_truth(p):
        """Median distances of points near the sphere (center (0, 0, 1.2),
        r 0.3) and the plane z = 1.8 to them; bar: under one voxel."""
        d_sph = ((p - torch.tensor([0.0, 0.0, 1.2], device=p.device)).norm(dim=1) - 0.3).abs()
        d_pl = (p[:, 2] - 1.8).abs()
        near_s, near_p = d_sph < 0.05, d_pl < 0.05
        out = {"sphere_points": int(near_s.sum()), "plane_points": int(near_p.sum()),
               "sphere_median_m": float(d_sph[near_s].median()),
               "plane_median_m": float(d_pl[near_p].median())}
        check(out["sphere_points"] > 100 and out["plane_points"] > 100
              and out["sphere_median_m"] < fcfg.voxel_size
              and out["plane_median_m"] < fcfg.voxel_size, f"far from the scene: {out}")
        return out

    fusion_truth = scene_truth(pts_f)
    emit({"phase": "fusion", "resolution": fcfg.grid_resolution, "voxel_size": fcfg.voxel_size,
          "frame": [cf["height"], cf["width"]], "frames": cf["frames"],
          "launches": all_launches["fusion"],
          "integrate_ms_median": round(statistics.median(frame_ms), 4),
          "integrate_ms": [round(t, 4) for t in frame_ms],
          "fuse_ms": round(fuse_ms, 3), "peak_mem_bytes": fuse_peak,
          "profiled_frame": prof_frame, "plain_k9_equal": True,
          "surface_points": int(pc_f.valid.sum()), "vs_truth": fusion_truth})
    del pc_f, pts_f

    # ---- mesh: extract_triangle_mesh -> smooth -> cleanup + normals -> PLY
    R_f = fcfg.grid_resolution
    budget = marching.default_max_triangles(R_f)
    _, _, n_1x, dropped_1x = marching.extract_triangle_soup(vol_k, max_triangles=budget,
                                                            with_dropped=True, cap_mult=1)
    _, _, n_4x, dropped_4x = marching.extract_triangle_soup(vol_k, max_triangles=budget,
                                                            with_dropped=True, cap_mult=4)
    ply_dir = tempfile.TemporaryDirectory()
    ply_path = os.path.join(ply_dir.name, "mesh.ply")

    def mesh_chain(vol, times=None):
        t = [time.perf_counter()]
        m = marching.extract_triangle_mesh(vol)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        m = mesh_ops.filter_smooth_laplacian(m, mcfg.smoothing_iterations)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        m = mesh_ops.compute_vertex_normals(mesh_ops.cleanup(m))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        n_vertices = ply_io.write_triangle_mesh(ply_path, m)
        t.append(time.perf_counter())
        if times is not None:
            times.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
        return m, n_vertices

    mesh_ms = []
    (mesh_k, n_vertices), launches = counted(lambda: mesh_chain(vol_k), {})
    all_launches["mesh"] = launches
    for _ in range(cf["mesh_runs"]):
        mesh_chain(vol_k, mesh_ms)
    ply_bytes = os.path.getsize(ply_path)
    prof_extract, _ = device_profile(lambda: marching.extract_triangle_mesh(vol_k))
    prof_chain, _ = device_profile(lambda: mesh_chain(vol_k))
    mesh_q, _ = mesh_chain(vol_q)  # the plain-K9 volume's mesh
    for f in dataclasses.fields(mesh_k):
        a, b = getattr(mesh_k, f.name), getattr(mesh_q, f.name)
        check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
              f"mesh: {f.name} differs from the plain-K9 volume's mesh")
    verts_m = mesh_k.vertices[mesh_k.vertex_valid]
    n_tris = int(mesh_k.triangle_valid.sum())
    check(bool(torch.isfinite(verts_m).all()) and n_tris > 10000
          and n_vertices == int(mesh_k.vertex_valid.sum()), "mesh: empty or not finite")
    emit({"phase": "mesh", "launches": all_launches["mesh"], "budget": budget,
          "rerun_4x": int(dropped_1x) > 0, "dropped_1x": int(dropped_1x),
          "dropped_4x": int(dropped_4x), "soup_1x": int(n_1x), "soup_4x": int(n_4x),
          "triangles": n_tris, "vertices": n_vertices, "ply_bytes": ply_bytes,
          "ms": {k: round(statistics.median(r[i] for r in mesh_ms), 3)
                 for i, k in enumerate(("extract", "smooth", "cleanup_normals", "ply_write"))},
          "ms_runs": [[round(t, 3) for t in r] for r in mesh_ms], "plain_k9_equal": True,
          "profiled_extract": prof_extract, "profiled_chain": prof_chain,
          "vs_truth": scene_truth(verts_m)})
    ply_dir.cleanup()
    del mesh_q, verts_m, vol_q

    # ---- kernels against their plain versions, on their paths' inputs
    rows = []
    n_el = HP * WP * DP

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
    # and on the headline's warped pair, whose gray levels are not integers;
    # on both pairs also without the downward path (the row-sharded call)
    planes_w = sgm_cuda.prefilter_planes(lg, rg, m.pre_filter_cap)
    for pair, (a, b, pl) in (("rectified", (gl, gr, planes)), ("warped", (lg, rg, planes_w))):
        for with_down in ((False,) if pair == "rectified" else (True, False)):
            cost_w, v1_w = sgm_cuda.cost_fwd_down(a, b, D, 0, m.block_size, m.pre_filter_cap, p1,
                                                  p2, HP, WP, DP, with_down, planes=pl)
            cost_q, v1_q = sgm_cuda.cost_fwd_down_plain(pl, HP, WP, DP, D, 0, m.block_size, p1,
                                                        p2, with_down)
            check(torch.equal(cost_w, cost_q) and torch.equal(v1_w, v1_q),
                  f"K2 differs from its plain version on the {pair} pair (down {with_down})")
            del cost_q, v1_q, cost_w, v1_w
    del planes_w
    # its two stages timed apart through their own entry points (timing
    # launches, not counted), on fresh volumes, then run once more in turn
    # and held to the whole call
    P = kernels.ptr
    cost_s, v1_s = torch.empty_like(cost_k), torch.empty_like(v1_k)
    walk = lambda down, v: kernels.launch(  # noqa: E731
        "r3d_cost_walk", dev, *map(P, planes), P(cost_s), P(v), H, W, HP, WP, DP, D,
        m.block_size, 0, 2.0 * p1, 2.0 * p2, int(down))
    fwd = lambda down, v: kernels.launch(  # noqa: E731
        "r3d_cost_fwd", dev, P(cost_s), P(v), HP, WP, DP, 2.0 * p1, 2.0 * p2, int(down))
    stage_ms = {}
    for down in (True, False):
        key = "" if down else "_without_down"
        stage_ms["walk" + key] = cuda_ms(lambda: walk(down, v1_s), KERNEL_RUNS)
        stage_ms["fwd" + key] = cuda_ms(lambda v: fwd(down, v), KERNEL_RUNS,
                                        lambda: (v1_s.clone(),))
    walk(True, v1_s)
    fwd(True, v1_s)
    check(torch.equal(cost_s, cost_k) and torch.equal(v1_s, v1_k),
          "K2's stages run apart differ from the whole call")
    del cost_s, v1_s
    k2_no_down = lambda: sgm_cuda.cost_fwd_down(  # noqa: E731
        gl, gr, D, 0, m.block_size, m.pre_filter_cap, p1, p2, HP, WP, DP, False, planes=planes)
    row("K2 cost_fwd_down", "recon3d_tpu_torch/csrc/sgm_cost.cu",
        "recon3d_tpu/depth/sgm_pallas.py:985", slice_n["K2"], err, cuda_ms(k2, KERNEL_RUNS),
        cuda_ms(k2p, PLAIN_RUNS), bound_ms(6 * H * W * 4 + cost_b + v1_b, 30 * n_el),
        ms_without_down=round(cuda_ms(k2_no_down, KERNEL_RUNS), 4),
        stages_ms={k: round(v, 4) for k, v in stage_ms.items()})

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

    # K4 (v3 read only: S never reaches memory)
    args = (p1, p2, D, m.uniqueness_ratio, m.disp12_max_diff, m.subpixel, W, "up")
    v3_in = v3_k.clone()
    d_k, val_k = sgm_cuda.vfinalize(cost_k, v3_k, *args)
    torch.cuda.synchronize()
    check(torch.equal(v3_k, v3_in), "K4 changed v3")
    del v3_in
    d_q, val_q = sgm_cuda.vfinalize_plain(cost_k, v3_k, *args)
    check(torch.equal(val_k, val_q) and torch.equal(d_k, d_q),
          "K4 differs from its plain version")
    # without the LR check: no right view, what the left view and the scan cost
    no_lr = args[:4] + (-1,) + args[5:]
    row("K4 vfinalize", "recon3d_tpu_torch/csrc/sgm_vfinalize.cu",
        "recon3d_tpu/depth/sgm_pallas.py:1135", slice_n["K4"], float((d_k - d_q).abs().max()),
        cuda_ms(lambda: sgm_cuda.vfinalize(cost_k, v3_k, *args), KERNEL_RUNS),
        cuda_ms(lambda: sgm_cuda.vfinalize_plain(cost_k, v3_k, *args), PLAIN_RUNS),
        bound_ms(cost_b + v1_b + HP * WP * 8, 16 * n_el),
        ms_without_lr_check=round(cuda_ms(lambda: sgm_cuda.vfinalize(cost_k, v3_k, *no_lr),
                                          KERNEL_RUNS), 4))
    del cost_k, v3_k, d_q, val_q

    # K5, one row per vertical direction, on the accurate frame's cost and
    # v3 (P2 = 3200). Each 8-direction frame adds the downward pair once and
    # the upward pair once, so a direction's count is half of K5's. The
    # bound is one pass over v (both paths of the pair together); the
    # two-pass floor is that of a design that makes a pass a direction.
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
            bound_ms(cost_b + 2 * v1_b, 2 * 9 * n_el),
            two_pass_floor_ms=round(bound_ms(2 * (cost_b + 2 * v1_b), 0)[0], 4))
        del out_k, out_q
    del cost8, v8

    # K10-K13 on the last shard of the rowsharded frames (h_real of its rows
    # real, the rest dead), on its own volumes and the carry planes that the
    # shards before it relay down to it; K10 and K11 take that real carry in
    # both directions (in the frame the upward chain starts there from zero)
    last = ROW_SHARDS - 1
    sh = sgm_sharded.shard_volumes(gl, gr, row_mesh, D, 0, m.block_size, m.pre_filter_cap, p1,
                                   p2)
    cost_l, h_l = sh.cost[last], sh.h_real(last)
    el = cost_l.numel()
    shard_b = el * 2 + 2 * el * 4  # the cost read, the path volume read and written
    v1_l = sh.S[last].clone()
    v3_k = sgm_sharded.bwd_accumulate_shard(cost_l, v1_l.clone(), p1, p2)
    v3_q = sgm_cuda.bwd_accumulate_plain(cost_l, v1_l.clone(), p1, p2)
    check(torch.equal(v3_k, v3_q), "K13 differs from its plain version")
    row("K13 bwd_accumulate_shard", "recon3d_tpu_torch/csrc/sgm_bwd.cu",
        "recon3d_tpu/depth/sgm_sharded.py:59", all_launches["rowsharded"]["K13"],
        float((v3_k - v3_q).abs().max()),
        cuda_ms(lambda v: sgm_sharded.bwd_accumulate_shard(cost_l, v, p1, p2), KERNEL_RUNS,
                lambda: (v1_l.clone(),)),
        cuda_ms(lambda v: sgm_cuda.bwd_accumulate_plain(cost_l, v, p1, p2), PLAIN_RUNS,
                lambda: (v1_l.clone(),)),
        bound_ms(shard_b, 8 * el), shard=list(cost_l.shape), h_real=h_l)
    del v1_l, v3_k, v3_q

    def relayed_carry(shards, scan, planes, mc):
        """The carry the shards before the last relay down to it (the public
        mirror, which leaves the shards' volumes as they are)."""
        carry = torch.zeros(planes + tuple(cost_l.shape[1:]), device=dev)
        for k in range(last):
            _, carry = scan(shards.cost[k], shards.S[k], carry, p1, float(mc.p2()), False,
                            shards.h_real(k))
        return carry

    def carry_rows(name, shards, scan, inplace, plain, planes, mc, launches, replaces, source,
                   two_pass=False):
        """A row a direction: the public mirror checked against the plain
        version (the shard's volume left as it was), the in-place entry the
        relay runs timed on a fresh copy made outside the timing."""
        carry = relayed_carry(shards, scan, planes, mc)
        S_l, p2_ = shards.S[last], float(mc.p2())
        S_in = S_l.clone()
        for reverse in (False, True):
            out_k, cout_k = scan(shards.cost[last], S_l, carry, p1, p2_, reverse, h_l)
            out_q, cout_q = plain(shards.cost[last], S_l.clone(), carry, p1, p2_, reverse, h_l)
            check(torch.equal(out_k, out_q) and torch.equal(cout_k, cout_q),
                  f"{name} {reverse} differs from its plain version")
            check(torch.equal(S_l, S_in), f"{name} changed the caller's acc")
            extra = {}
            if two_pass:
                extra["two_pass_floor_ms"] = round(
                    bound_ms(2 * shard_b + 2 * carry.numel() * 4, 0)[0], 4)
            row(f"{name} {'up' if reverse else 'down'}", source, replaces, launches,
                max(float((out_k - out_q).abs().max()), float((cout_k - cout_q).abs().max())),
                cuda_ms(lambda v: inplace(shards.cost[last], v, carry, p1, p2_, reverse, h_l),
                        KERNEL_RUNS, lambda: (S_l.clone(),)),
                cuda_ms(lambda v: plain(shards.cost[last], v, carry, p1, p2_, reverse, h_l),
                        PLAIN_RUNS, lambda: (S_l.clone(),)),
                bound_ms(shard_b + 2 * carry.numel() * 4, 9 * (planes[0] if planes else 1) * el),
                shard=list(cost_l.shape), h_real=h_l, carry_max=float(carry.max()), **extra)
            del out_k, out_q, cout_k, cout_q
        del S_in

    for k in range(ROW_SHARDS):
        sgm_sharded.bwd_accumulate_shard(sh.cost[k], sh.S[k], p1, p2)
    carry_rows("K10 vscan_carry", sh, sgm_cuda.vscan_carry, sgm_cuda._vscan_carry_,
               sgm_cuda.vscan_carry_plain, (), m, all_launches["rowsharded"]["K10"],
               "recon3d_tpu/depth/sgm_pallas.py:385", "recon3d_tpu_torch/csrc/sgm_carry.cu")
    # K12 on the last shard's S after the frame's two vertical relays
    sgm_sharded.relay(sh, sgm_cuda._vscan_carry_, (), False, p1, p2)
    sgm_sharded.relay(sh, sgm_cuda._vscan_carry_, (), True, p1, p2)
    S_l = sh.S[last]
    fin = (D, m.uniqueness_ratio, m.disp12_max_diff, m.subpixel, W)
    d_k, val_k = sgm_cuda.wta_finalize(S_l, *fin)
    d_q, val_q = sgm_cuda.wta_finalize_plain(S_l, *fin)
    check(torch.equal(val_k, val_q) and torch.equal(d_k, d_q),
          "K12 differs from its plain version")
    fin_no_lr = fin[:2] + (-1,) + fin[3:]
    row("K12 wta_finalize", "recon3d_tpu_torch/csrc/sgm_vfinalize.cu",
        "recon3d_tpu/depth/sgm_pallas.py:537", all_launches["rowsharded"]["K12"],
        float((d_k - d_q).abs().max()), cuda_ms(lambda: sgm_cuda.wta_finalize(S_l, *fin),
                                                KERNEL_RUNS),
        cuda_ms(lambda: sgm_cuda.wta_finalize_plain(S_l, *fin), PLAIN_RUNS),
        bound_ms(el * 4 + d_k.numel() * 5, 8 * el), shard=list(S_l.shape),
        ms_without_lr_check=round(cuda_ms(lambda: sgm_cuda.wta_finalize(S_l, *fin_no_lr),
                                          KERNEL_RUNS), 4))
    del sh, S_l, d_k, val_k, d_q, val_q
    # K11 on the accurate frame's last shard, after its vertical relays
    sh = sgm_sharded.shard_volumes(gl, gr, row_mesh, D, 0, m8.block_size, m8.pre_filter_cap, p1,
                                   p2_8)
    for k in range(ROW_SHARDS):
        sgm_sharded.bwd_accumulate_shard(sh.cost[k], sh.S[k], p1, p2_8)
    sgm_sharded.relay(sh, sgm_cuda._vscan_carry_, (), False, p1, p2_8)
    sgm_sharded.relay(sh, sgm_cuda._vscan_carry_, (), True, p1, p2_8)
    carry_rows("K11 diag_carry", sh, sgm_cuda.diag_carry, sgm_cuda._diag_carry_,
               sgm_cuda.diag_carry_plain, (2,), m8, all_launches["rowsharded_accurate"]["K11"],
               "recon3d_tpu/depth/sgm_pallas.py:343", "recon3d_tpu_torch/csrc/sgm_diag.cu",
               two_pass=True)
    del sh, cost_l

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
        check(torch.equal(out_k, out_q), f"K6 axis {axis} differs from its plain version")
        err = max(err, float((out_k - out_q).abs().max()))
        times.append(cuda_ms(lambda: wls_cuda.tridiag_solve(*sp, axis), KERNEL_RUNS))
        plain_times.append(cuda_ms(lambda: wls_cuda.tridiag_solve_plain(*sp, axis), PLAIN_RUNS))
    row("K6 tridiag_solve", "recon3d_tpu_torch/csrc/wls_tridiag.cu",
        "recon3d_tpu/depth/wls_pallas.py:102", slice_n["K6"], err, sum(times) / 2,
        sum(plain_times) / 2, bound_ms(5 * H * W * 4, 10 * H * W),
        ms_axis1=round(times[0], 4), ms_axis0=round(times[1], 4))

    # K7 and K8 at the scan_post and normals_1m shapes. K7's yardstick is
    # one index_select of the sorted points at the clamped slot positions:
    # the placement without occupancy. No single PyTorch call computes K8.
    for shape, pts_, valid_, radius_, G_, C_, pk_k, r2 in (
            ("scan_post", q.points, q.valid, pcfg.normal_radius, scan_G, scan_C, pk_s, r2_s),
            ("normals_1m", pc1.points, pc1.valid, c1m["radius"], G1, C1, pk_1, r2_1)):
        _, sp, _, start, _, _, _ = grid_knn._sort_cells(pts_, valid_, radius_, G_, C_)
        sp = sp.contiguous()
        pk_q = grid_knn.pack_plain(sp, start, C_)
        check(torch.equal(grid_knn_cuda.pack_cells(sp, start, C_), pk_q) and
              torch.equal(pk_k, pk_q), f"K7 differs from its plain version ({shape})")
        slot = torch.arange(pk_q.shape[0], device=dev)
        pos = torch.clamp(start[slot // C_].long() + slot % C_, max=sp.shape[0] - 1)
        row(f"K7 pack_cells {shape}", "recon3d_tpu_torch/csrc/grid_pack.cu",
            "recon3d_tpu/ops/grid_knn_pallas.py:319", all_launches[shape]["K7"], 0.0,
            cuda_ms(lambda: grid_knn_cuda.pack_cells(sp, start, C_), KERNEL_RUNS),
            cuda_ms(lambda: grid_knn.pack_plain(sp, start, C_), PLAIN_RUNS),
            bound_ms(pk_q.numel() * 4 + sp.numel() * 4 + start.numel() * 4, 0),
            cuda_ms(lambda: torch.index_select(sp, 0, pos), KERNEL_RUNS),
            library="torch.index_select of the sorted points at the clamped slot positions: "
                    "the placement without occupancy", grid=[G_, C_],
            occupied_slots=int(pk_q[:, 3].sum()))
        del pos, slot
        moments_path = "moments_1m" if shape == "normals_1m" else "scan_post_moments"
        for variant, fused, path in (("moments", False, moments_path), ("fused", True, shape)):
            out_k = grid_knn_cuda.core_call(pk_q, r2, G_, C_, fused)
            out_q = grid_knn.core_plain(pk_q, r2, G_, C_, fused)
            cnt = out_k[:, 3 if fused else 0]
            check(torch.equal(cnt, out_q[:, 3 if fused else 0]),
                  f"K8 {variant} count differs from its plain version ({shape})")
            if fused:
                agree = normals_agree(out_k[:, :3], out_q[:, :3], cnt >= 5, False,
                                      f"K8 fused ({shape})")
            else:
                nn = torch.clamp(cnt, min=1.0)[:, None]
                extent = float((pts_[valid_].amax(0) - pts_[valid_].amin(0)).max())
                d1 = float((out_k[:, 1:4] / nn - out_q[:, 1:4] / nn).abs().max())
                d2 = float((out_k[:, 4:] / nn - out_q[:, 4:] / nn).abs().max())
                agree = {"mean": d1, "second": d2, "extent": extent,
                         "bitwise": bool(torch.equal(out_k, out_q))}
                check(d1 <= 1e-5 * extent and d2 <= 1e-5 * extent ** 2,
                      f"K8 moments differ from their plain version ({shape}): {agree}")
            nbytes = pk_q.numel() * 4 + out_k.numel() * 4
            row(f"K8 core_call {variant} {shape}", "recon3d_tpu_torch/csrc/grid_moments.cu",
                "recon3d_tpu/ops/grid_knn_pallas.py:147", all_launches[path]["K8"],
                float((out_k - out_q).abs().max()),
                cuda_ms(lambda: grid_knn_cuda.core_call(pk_q, r2, G_, C_, fused), KERNEL_RUNS),
                cuda_ms(lambda: grid_knn.core_plain(pk_q, r2, G_, C_, fused), PLAIN_RUNS),
                bound_ms(nbytes, k8_operations(pk_q, cnt, G_, C_, fused)), None,
                library="none: no single PyTorch call computes it", grid=[G_, C_],
                vs_plain=agree)
            del out_k, out_q, cnt
        del sp, start, pk_q

    # K9 at the fusion shape: frame 0's pixel indices and image stack. The
    # plain version is itself one PyTorch call, the advanced-index gather,
    # timed again over KERNEL_RUNS as the library yardstick.
    c_t, d_t, pose = fframes[0]
    _, _, vc, uc = tsdf._pixel_indices(vol_k, cf["height"], cf["width"], fintr, pose)
    imgs = tsdf._image_stack(d_t, c_t)
    s_k = project_sample_cuda.sample_images_cuda(vc, uc, imgs)
    s_q = project_sample.sample_images_plain(vc, uc, imgs)
    vcl, ucl = vc.long(), uc.long()
    check(torch.equal(s_k, s_q), "K9 differs from its plain version")
    row("K9 sample_images_at", "recon3d_tpu_torch/csrc/project_sample.cu",
        "recon3d_tpu/ops/project_sample.py:131", all_launches["fusion"]["K9"],
        float((s_k - s_q).abs().max()),
        cuda_ms(lambda: project_sample_cuda.sample_images_cuda(vc, uc, imgs), KERNEL_RUNS),
        cuda_ms(lambda: project_sample.sample_images_plain(vc, uc, imgs), PLAIN_RUNS),
        bound_ms(vc.numel() * 8 + s_q.numel() * 4 + imgs.numel() * 4, 0),
        cuda_ms(lambda: imgs[:, vcl, ucl], KERNEL_RUNS),
        library="advanced-index gather imgs[:, vc, uc] (the plain version itself)",
        shape=[*imgs.shape, fcfg.grid_resolution])
    del vc, uc, vcl, ucl, imgs, s_k, s_q, vol_k

    emit({"kernels": rows})
    print(smi, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(f"# wall {time.perf_counter() - t_start:.1f} s", file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
