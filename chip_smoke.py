#!/usr/bin/env python3
"""Drive recon3d_tpu_torch's depth, point-cloud, fusion, registration,
streaming, calibration and scanner paths, its CLI, the sharded fusion, the
scalable TSDF and the viewers on one NVIDIA H100 and hold every kernel on
them to its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one CUDA card

The frames are the bench scene at full size: the synthetic sphere-over-plane
pair at 1920x1080, D = 128, block 5. Phases, one JSON line each (with t_s,
the seconds since the script started):
  device      card name, nvidia-smi name / power limit, CUDA of torch, nvcc;
  build       seconds to build the kernels (cold when build/kernels/ is empty);
  slice       the rectified pair through compute_disparity (tuned SGM-4,
              P2 = 96 * 25, box-count speckle, WLS), depth and the colored
              cloud;
  headline    bench.py:build_headline's frame: the raw pair (the rectified
              scene pushed through the inverse of the bench's synthetic
              rectification) through the two-pass warp (K1: both passes in
              one launch) twice, then the
              slice's frame and the BGR color stream's cloud; a line before
              it (headline_profile) gives the frame's device busy share and
              kernel time by name under torch.profiler over 3 frames, the
              device ms of the fused K4 and its LR check a frame and of a
              K1 launch;
  one_pass    (a counted path, no line) K1's one-pass entry, resample_pass,
              twice as its callers use it: equal to the fused remap;
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
              fuse-kernel launch a frame: integrate ms per frame, the
              30-frame fuse, peak memory, the volume from the plain path
              (PyTorch's projection and update with K9; bitwise), and
              extract_point_cloud's points against the sphere and the plane;
  mesh        Scanner3D.extract_mesh / save_mesh's steps on the fused volume:
              extract_triangle_mesh (at the JAX package's own budget, 2^19),
              filter_smooth_laplacian x 5, cleanup + compute_vertex_normals,
              the binary PLY write; ms, counts, drops, the mesh of the plain
              path's volume (equal) and the vertices against the scene;
  registration  Scanner3D.register_fragments' chain (pipeline/offline.py:
              533-613) at ScannerConfig()'s defaults on 8
              SyntheticRGBDCamera(640, 480) frames, a pair at a time:
              backproject, voxel 0.02, compact 8192, statistical 20 / 2.0,
              normals (0.04, 30), FPFH (0.1, 64); the 7 sequential and 3
              loop pairs through registration_ransac_fpfh (0.03, 65536
              trials, point-to-plane refine) and information_matrix; the
              pose graph's LM. ms of a frame's preprocess, a pair and the
              pose graph, each pair's fitness / rmse, the pose error
              against true_pose(k), and the chain of the first cpu_frames
              frames on the card against the same on the host CPU (the same
              CPU-drawn RANSAC trials), and each such graph's edges' final
              line-process weights (pruned below 0.25), card and host;
  odometry    compute_rgbd_odometry on frames 0 -> 1 (3 levels, 10 sweeps
              each, gathers): median ms of 10, the busy share, the error
              against the truth (5 mm / 0.01) and against the host's run;
  icp         PointCloudAlignment (point-to-point; point-to-plane, K7 + K8
              in its normals) and GICP with covariances_for_gicp on the
              backprojected frames 0 -> 1: N, M, the correspondence branch
              (the grid 1-NN where N * M > 2^26), ms, iterations, fitness,
              rmse and the host's run. TF32 must be off;
  streaming   StreamingFusion at ScannerConfig()'s defaults (256^3, voxel
              0.004, color, keyframe tracking, consume_batch "auto", queue
              10, the live mesher, an auto-fit origin) on 16
              SyntheticRGBDCamera(640, 480) frames (step 0.01): warmup, the
              threaded stream (start(max_frames=16), stop(): fps, every
              captured frame integrated, no odometry or host failure, the
              fuse kernel once a frame), the same frames through _fuse_one (ms a frame,
              the last under torch.profiler for the busy share, peak
              memory after frame 5 and 16, extract_mesh_live after frame 1
              and 16), each frame's drift from inv(true_pose(k)) (frames
              1-3 within 1 cm), extract_mesh() against the scene, the live
              mesh against extract_triangle_mesh (equal vertex-key and face
              sets, vertices within 1e-6), then bitwise against the
              _fuse_one run: the stream, the plain path, a checkpoint
              at frame 8 resumed with the rest as one backlog through
              _fuse_frames (its stages timed, profile=True); the host
              syncs a step makes
              (torch.cuda's sync debug mode, by line); the host CPU's first
              2 frames (trajectory within 1e-4); DepthFilterBank()'s ms a
              frame on the first 10 depth frames;
  calibration calibrate -> rectify -> depth: 15 stereo pairs of a 9x6 board
              (square 0.04 m) rendered at 1920x1080 through pipeline_rig()'s
              cameras (anti-aliased, a lens blur, 8 bits); initial corners
              the true projections + a seeded U(-0.75, 0.75) px (the
              stand-in for OpenCV's detection, which neither package has
              here), refined by corner_subpix on the card (2 pairs also on
              the host); calib.api.stereo_calibrate_camera with that
              detection (calibrate_camera x 2, stereo_calibrate,
              stereo_rectify, the NPZ, the report) on the card and on the
              host in float64: stage seconds, LM iterations, rms, the host
              syncs by line, the busy share of one calibrate_camera, card
              against host and against the true rig; a raw-schema NPZ of
              the result through DepthPipeline.from_npz, one counted frame
              of the bench's raw pair against its plain version, fps, the
              maps against the true rig's; census_cost_volume on the
              rectified pair and census SGM on its rows 405-675, card
              against host, and its RMSE against the analytic disparity;
  offline     Scanner3D(SyntheticRGBDCamera(640, 480, 8 frames),
              ScannerConfig()).run(8): capture + PNG checkpoints, 8
              preprocessed clouds, 7 sequential and 3 loop pairs through
              register_pairs_ransac_batched, the pose graph, 8 integrates
              (the fuse kernel once each, no other kernel), extract, PLY; ms a stage and
              peak memory. Bars: two pairs (the first sequential, the first
              loop) bitwise their per-pair registration_ransac_fpfh +
              information_matrix; every node's sphere center within 5 mm and
              plane normal within 5e-3 of the truth; the mesh's median
              distance to the scene under a voxel (0.004 m); 8 PNG pairs
              replayed by FakeRGBDCamera (colors equal, the raw depth the
              writer's truncation, within 1 / depth_scale);
              integrate_saved_frames on the first 4 (fuse 4) bitwise the same
              _fuse_one loop. It also gives the pose graph's kept edges on
              the card and the host CPU, and its weights on the host CPU;
  scanner     StreamingScanner(SyntheticRGBDCamera(640, 480, 10 frames),
              ScannerConfig()): start(max_frames=10), join, stop, finalize
              (K7 1 and K8 1 in the normals: the processed cloud's capacity
              is 2^18, past the 32,768-point switch; its valid count is
              printed); frames_rejected, ms an accumulate step, finalize's
              stages, the host syncs of one accumulate step by line, peak
              memory. Bars: every frame processed, every path written;
              Poisson's indicator at depth 6 on the finalized oriented cloud
              bitwise between two card runs and within 1e-5 of its maximum
              of the host CPU's (densities rtol 1e-5 over a floor of 1e-6 of
              the maximum); the mesh's median distance to the scene, over
              the vertices above MeshConfig().density_quantile, under one
              Poisson cell;
  cli         recon3d_tpu_torch.cli.main in this process: depth at the
              CLI's defaults (960x540, 3 frames) on an NPZ of pipeline_rig()
              scaled to it (frame 0's PNG bitwise DepthPipeline.process on
              the same pair and rig), fuse at ScannerConfig() (3 frames)
              with --checkpoint and --resume (2 more), scan (3 frames) and
              offline (4 frames) at ScannerConfig(), inspect, doctor; each
              command's seconds and launches; the PLYs load;
  parallel_fusion  parallel/fusion.py on 4 in-process frame shards: 4 of
              the fusion phase's frames into 256^3 by integrate_frames_exact
              (the fuse kernel twice a frame) against 4 integrate calls
              (weights exact, tsdf and color within 1e-5) and bitwise its
              plain-path call,
              its peak over the bytes live before it;
              fused_frames_sharded of frames 1-4 against frame 0 against the
              same odometry + integrate chain frame by frame;
  scalable    fusion/scalable.py at make_scalable_volume()'s defaults on the
              fusion phase's 30 frames with maybe_grow between frames:
              ms a frame, bricks, grows, drops, one frame's host syncs by
              line; the extracted mesh against
              the scene; save at frame 15 / load / continue bitwise one run;
              the first 2 frames on the host CPU against the card;
  viewers     render_points of the scanner phase's cloud at 960x720 (ms,
              bitwise the host's render); LiveDepthViewer with a sink over
              DepthPipeline at 1920x1080, 3 frames; live_remesh_loop on a
              2-frame StreamingScanner with a remesh after each frame (K7 +
              K8 each, their normals bitwise the plain versions on the
              remesh's cloud);
  kernels     each kernel against its plain version on its path's own
              inputs (bitwise: K2 on the rectified and the warped pair, with
              and without the downward path; K6 on both axes; K8 both
              variants), its device time (ms: a run of 10 launches between
              one event pair behind a spin that hides the host, over the
              count; for a working set under the 50 MB L2 the median of 10
              launches each after an L2 flush, and that time is the row's
              ms; call_ms: one call between an event pair, the host's
              wrapper included), the plain version's median over 3, the
              least time the card could take (bound_ms: bytes at 3.35 TB/s
              or operations at 67e12 a second, K8's at 33.45e12
              uncontracted f32 instructions a second) and,
              where one PyTorch call computes the same or the yardstick
              function, that call's time (library_ms); K2 also its two
              stages (the walk, the forward scan) apart and its call
              without the downward path, K6 each axis; K4 (v3 read only,
              checked) and K12 bitwise, each also timed without the LR
              check (no right view); the fuse kernel's rows (fold and
              contribution at the fusion phase's shape) also give its
              launches on the streaming, offline and replay paths (`streaming_launches`,
              `offline_launches`, `offline_replay_launches`), K7's and the
              fused K8's scan_post rows theirs on the scanner path
              (`scanner_launches`); every row its kernel's launches on the
              cli, parallel_fusion and viewers paths (`path_launches`). A
              plain version slower than 100 ms is timed once.
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
import contextlib
import dataclasses
import faulthandler
import glob
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

BUDGET_S = 600  # whole-run watchdog (half of the 1200 s a run may take): a hang exits nonzero
DEVICE = "cuda"  # the card; a rehearsal of the script on the CPU sets "cpu"
H, W, D = 1080, 1920, 128
FOCAL, BASELINE = 1050.0, 0.06
KERNEL_RUNS, PLAIN_RUNS, FRAMES, WARMUP = 10, 3, 10, 2
PLAIN_SLOW_MS = 100.0  # a plain version slower than this is timed once, not PLAIN_RUNS times
PROFILE_FRAMES = 3  # headline frames under torch.profiler
ROW_SHARDS, BATCH = 4, 4  # the row mesh of one frame; the frames of the batched phase
# the point-cloud phases: scanner.py:179-180's chain on a 640x480 frame and
# tools/bench_pointops.py's cases (bench.py:698-729, 952-976)
SCAN_W, SCAN_H, SCAN_RUNS = 640, 480, 1  # timed runs of the chain (~7.2 s each on an H100)
NORMALS_1M = dict(n=1_000_000, radius=0.02, grid_size=52, cell_capacity=16, runs=5)
NORMALS_10M = dict(n=10_000_000, radius=0.008, grid_size=128, cell_capacity=16, runs=3)
VOXEL_10M = dict(n=10_000_000, voxel_size=0.05, capacity=1 << 14, runs=3)
# the fusion phases: FusionConfig()'s 256^3 volume fed the capture camera's
# 640x480 frames (config.py:120, 160-169); the origin holds the sphere (z 0.9
# to 1.5) and the plane z = 1.8, half a voxel off any plane of voxel centers
FUSION = dict(width=640, height=480, frames=30, origin=(-0.512, -0.512, 0.902),
              point_capacity=1 << 18, mesh_runs=3)
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 ops/s outside tensor cores
# (a fused multiply-add counted as two), and the rate of f32 instructions
# (132 SMs x 128 lanes x 1.98 GHz): the ceiling of a kernel held to one rounding an
# operation (__f*_rn, no contraction), where each addition and product is one
HBM_BYTES_PER_S, F32_OPS_PER_S, F32_INSTR_PER_S = 3.35e12, 67e12, 132 * 128 * 1.98e9
# the H100's L2: a kernel whose bytes fit is also timed with it flushed, and that
# time is the one held to the bound; the flush writes five times as much
L2_BYTES, L2_FLUSH_BYTES = 50 * 2 ** 20, 256 * 2 ** 20
SPIN_CYCLES_PER_MS = 1.98e6  # torch.cuda._sleep's cycles a millisecond at 1.98 GHz
# the registration phases: Scanner3D.register_fragments' chain on 8 capture
# frames (pipeline/offline.py:533-613 at ScannerConfig()'s defaults), the
# streaming path's odometry and the alignment shim on frames 0 -> 1
REGISTRATION = dict(width=640, height=480, frames=8, capacity=8192, odometry_runs=10,
                    icp_runs=3, cpu_frames=2)
# the streaming phase: StreamingFusion at ScannerConfig()'s defaults on the
# fusion phase's scene (capture frames, step 0.01); the last frames of the
# _fuse_one loop run under torch.profiler, the first ones on the host CPU;
# its frames (30 -> 16), profiled frames (5 -> 3 -> 1), host CPU frames (5 ->
# 3 -> 2) and filter frames (30 -> 10) cut to make room for later phases
STREAMING = dict(width=640, height=480, frames=16, step=0.01, queue_size=10, profile_frames=1,
                 cpu_frames=2, filter_frames=10, stream_timeout_s=300, peak_slack_bytes=1 << 20)
# the calibration phase: 15 stereo pairs of the reference's 9x6 board
# (calib/api.py's pattern_size), square 0.04 m, rendered at the depth path's
# size through pipeline_rig()'s cameras; the initial corners are the true
# projections plus a seeded uniform offset (the stand-in for OpenCV's
# detection, which neither package has without cv2)
CALIBRATION = dict(pairs=15, pattern=(9, 6), square=0.04, z=(0.6, 1.2), tilt=0.45, roll=0.12,
                   margin_px=40, jitter_px=0.75, supersample=4, lens_blur=(7, 1.0),
                   host_refine_pairs=2, seed=11, census_rows=(405, 675),
                   # the rectification maps from the calibrated rig against the
                   # true rig's: 1.5 x the JAX package's median on these renders
                   # and corners (1.6943 px, measured on the host CPU)
                   maps_median_px=1.5 * 1.6943)

# the offline phase: Scanner3D.run at ScannerConfig()'s defaults on 8
# capture frames (run()'s default count 16, cut to 8 to make room for later
# phases), its PNG checkpoints re-integrated by integrate_saved_frames on the
# first 4 (8 before the cut) into a 256^3 volume
OFFLINE = dict(width=640, height=480, frames=8, replay_frames=4, replay_resolution=256)
# the scanner phase: StreamingScanner at ScannerConfig()'s defaults on 10
# capture frames (the JAX test's flow at full width)
SCANNER = dict(width=640, height=480, frames=10, timeout_s=300)
# the cli phase: the CLI's commands in this process; depth at its defaults
# (960x540), the scanners' commands at ScannerConfig() on a few frames (their
# full runs are the scanner and offline phases)
CLI = dict(depth_size=(960, 540), depth_frames=3, fuse_frames=3, resume_frames=2,
           scan_frames=3, offline_frames=4)
# the parallel_fusion phase: 4 of the fusion phase's frames, 4 frame shards
PARALLEL_FUSION = dict(frames=4, shards=4)
# the scalable phase: the fusion phase's 30 frames into the default brick pool
SCALABLE = dict(save_at=15, host_frames=2, window=256)
# the viewers phase: the renderer at LiveVisualizer3D's default size
VIEWERS = dict(render_size=(720, 960), depth_frames=3, scan_width=640, scan_height=480,
               timeout_s=300)


T_START = time.perf_counter()  # the script's start: each phase line's t_s counts from it


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 3)}
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


@contextlib.contextmanager
def plain_fusion():
    """fusion/tsdf.py's plain version on the card's tensors (the projection
    and the update as PyTorch operations, K9's sample): the fuse kernel's
    reference."""
    from recon3d_tpu_torch.fusion import tsdf

    on_card = tsdf._on_card
    tsdf._on_card = lambda *a: False
    try:
        yield
    finally:
        tsdf._on_card = on_card


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


def pipeline_rig(scale=1.0):
    """An in-memory rectified rig at the bench's size (times `scale`: the
    focal lengths, principal points and image size): radial and tangential
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
    S = np.diag([scale, scale, 1.0])
    K1, K2, P1, P2 = S @ K1, S @ K2, S @ P1, S @ P2
    Q[:3, 3] *= scale
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


def plain_ms(fn, setup=lambda: ()):
    """A plain version's time: one call when it takes more than
    PLAIN_SLOW_MS, else the median over PLAIN_RUNS calls."""
    first = cuda_ms(fn, 1, setup)
    if first > PLAIN_SLOW_MS:
        return first
    return statistics.median([first] + [cuda_ms(fn, 1, setup) for _ in range(PLAIN_RUNS - 1)])


def _spin(ms):
    """A kernel that keeps the stream busy for about `ms` (and touches no
    memory), so that what the host enqueues behind it runs back to back."""
    import torch

    torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * ms))


def run_ms(fn, runs, setup=lambda: ()):
    """Device ms of one call of fn(*setup()) in a run: `runs` launches (one
    setup for the run) between one event pair, over the count, behind a spin
    that outlasts the host's enqueueing of the run, so the wrapper's host
    time is hidden. The L2 holds what the previous launch left."""
    import torch

    args = setup()
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _spin(max(1.0, 3.0 * host_ms * runs))
    start.record()
    for _ in range(runs):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def cold_ms(fn, runs, setup=lambda: ()):
    """Median device ms of `runs` single calls of fn(*setup()), each after
    an L2 flush (a write of L2_FLUSH_BYTES) and a spin that outlasts the
    host's enqueueing of the call, both outside the timed region."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    times = []
    for _ in range(runs):
        args = setup()
        flush.zero_()
        _spin(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_times(fn, nbytes, runs, setup=lambda: ()):
    """A kernel row's times: call_ms, one call between an event pair (the
    host's wrapper included, on an idle stream: the earlier yardstick);
    warm_ms (run_ms) and, for a working set under the L2, cold_ms. `ms` is
    the cold time where there is one (held to the bound, so no share reads
    above 100 %), else the warm one."""
    t = {"call_ms": cuda_ms(fn, runs, setup), "warm_ms": run_ms(fn, runs, setup)}
    if nbytes < L2_BYTES:
        t["cold_ms"] = cold_ms(fn, runs, setup)
    t["ms"] = t.get("cold_ms", t["warm_ms"])
    return t


def bound_ms(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    """(least ms, what bounds it, the operations' ceiling): the bytes at the
    HBM rate against the operations at `ops_per_s`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            "fma" if ops_per_s == F32_OPS_PER_S else "instructions")



def device_profile(fn, top=6, calls=1, host_ops=True):
    """One call of fn, which makes `calls` calls of a path, under
    torch.profiler: its wall ms (host clock, to a synchronize), the kernels'
    summed device ms, the device's busy share and the `top` kernels by
    device time, the times per call of the path; (None, {}) when the trace
    holds no device time. Also returns the device microseconds by kernel
    name (over all calls). host_ops=False traces the device activity only
    (the host's operator events of a launch-heavy path take the profiler
    tens of seconds to process)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_ops:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
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



def registration_chain(frames, intr, dev, times=None, optimize=True):
    """Scanner3D.register_fragments' chain (pipeline/offline.py:533-613) at
    ScannerConfig()'s defaults on `dev`, the pairs one at a time: each
    frame backprojected (depth_trunc 3), voxel 0.02, compacted to 8192,
    statistical outliers 20 / 2.0, normals (0.04, 30), FPFH (0.1, 64);
    the sequential pairs and the loop pairs (stride max(n // 4, 2))
    through registration_ransac_fpfh (0.03, 65536 trials, seed 0,
    point-to-plane refine) and information_matrix; then the pose graph
    (identity + uncertain edge for a weak sequential pair, good loop pairs
    as uncertain edges) through global_optimization (not with
    optimize=False). Returns the per-pair dicts, the graph before and
    after the optimization (None if not optimized), the clouds and
    their features; `times` collects host-clock ms a stage, each ending in
    a synchronize."""
    import numpy as np
    import torch

    from recon3d_tpu_torch.config import RegistrationConfig
    from recon3d_tpu_torch.pointcloud.backproject import backproject_depth
    from recon3d_tpu_torch.pointcloud.normals import estimate_normals
    from recon3d_tpu_torch.pointcloud.outliers import remove_statistical_outliers
    from recon3d_tpu_torch.pointcloud.voxel import voxel_downsample
    from recon3d_tpu_torch.registration.features import compute_fpfh
    from recon3d_tpu_torch.registration.icp import information_matrix
    from recon3d_tpu_torch.registration.ransac import registration_ransac_fpfh
    from recon3d_tpu_torch.utils.types import compact

    c = RegistrationConfig()
    times = {} if times is None else times

    def clock():
        if str(dev) != "cpu":
            torch.cuda.synchronize()
        return time.perf_counter()

    clouds, feats = [], []
    for color, depth in frames:
        t0 = clock()
        pc = backproject_depth(torch.as_tensor(depth, device=dev), intr,
                               color=torch.as_tensor(color, device=dev), depth_trunc=3.0)
        pc = voxel_downsample(pc, c.voxel_size)
        pc = compact(pc, REGISTRATION["capacity"])
        pc = remove_statistical_outliers(pc, nb_neighbors=20, std_ratio=2.0)
        pc = estimate_normals(pc, radius=2.0 * c.voxel_size, max_nn=30)
        feats.append(compute_fpfh(pc, radius=5.0 * c.voxel_size, max_nn=64))
        clouds.append(pc)
        times.setdefault("preprocess", []).append((clock() - t0) * 1e3)
    n = len(clouds)
    thr = 1.5 * c.voxel_size
    results = []
    for i, j in chain_pairs(n):
        t0 = clock()
        res = registration_ransac_fpfh(clouds[i], clouds[j], feats[i], feats[j],
                                       distance_threshold=thr,
                                       num_trials=min(c.ransac_max_iterations, 65536))
        info = information_matrix(clouds[i], clouds[j], thr, res.transformation)
        results.append({"pair": (i, j), "T": res.transformation.cpu().double().numpy(),
                        "info": info.cpu().double().numpy(), "fitness": float(res.fitness),
                        "rmse": float(res.inlier_rmse), "iterations": int(res.iterations),
                        "good": bool(res.is_good(c.fitness_min, c.rmse_max * 5)),
                        "points": int(clouds[i].valid.sum())})
        times.setdefault("pair", []).append((clock() - t0) * 1e3)
    t0 = clock()
    graph, optimized = chain_graph(results, n, dev, optimize)
    times.setdefault("pose_graph", []).append((clock() - t0) * 1e3)
    return {"pairs": results, "graph": optimized, "graph_in": graph, "clouds": clouds,
            "feats": feats}


def chain_pairs(n):
    """The chain's pairs on n frames: the sequential ones, then the loop
    pairs at stride max(n // 4, 2)."""
    stride = max(n // 4, 2)
    return [(i, i - 1) for i in range(1, n)] + [(i, i - stride) for i in range(stride, n, stride)]


def chain_graph(results, n, dev, optimize=True):
    """The chain's pose graph on n frames from its pairs' dicts, in
    chain_pairs(n)'s order (identity + uncertain edge for a weak sequential
    pair, good loop pairs as uncertain edges), and that graph after
    global_optimization on `dev` (None with optimize=False)."""
    import numpy as np

    from recon3d_tpu_torch.registration.posegraph import PoseGraph, global_optimization

    graph = PoseGraph()
    graph.add_node(np.eye(4))
    world_from_prev = np.eye(4)
    for r in results[:n - 1]:
        i, j = r["pair"]
        T, info, uncertain = ((r["T"], r["info"], False) if r["good"]
                              else (np.eye(4), np.eye(6) * 1e-3, True))
        world_from_prev = world_from_prev @ T
        graph.add_node(world_from_prev)
        graph.add_edge(i, j, T, info, uncertain=uncertain)
    for r in results[n - 1:]:
        if r["good"]:
            graph.add_edge(*r["pair"], r["T"], r["info"], uncertain=True)
    return graph, global_optimization(graph, device=dev) if optimize else None


def scene_motion(Ta, Tb, cam_from_world):
    """How two transforms into a camera frame disagree on what the synthetic
    scene fixes, for D = Ta Tb^-1: the move of the sphere's center (m) and
    of the plane's normal, in that frame (a rotation about the normal
    through the center moves neither sphere nor plane), and D's angle."""
    import numpy as np

    D = Ta @ np.linalg.inv(Tb)
    c = (cam_from_world @ np.array([0.0, 0.0, 1.2, 1.0]))[:3]
    n = cam_from_world[:3, :3] @ np.array([0.0, 0.0, 1.0])
    angle = np.arccos(np.clip((np.trace(D[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))
    return (float(np.linalg.norm(D[:3, :3] @ c + D[:3, 3] - c)),
            float(np.linalg.norm(D[:3, :3] @ n - n)), float(angle))

def registration_phases(dev, counted, timed_frames, all_launches):
    """The registration, odometry and icp phases: Scanner3D.register_fragments'
    chain on 8 capture frames, the streaming path's odometry and the
    alignment shim on frames 0 -> 1, each on the card and again on the host
    CPU for the comparison. `counted` runs a path with the launch counters
    at 0 and holds its counts; `timed_frames` gives host-clock ms."""
    import dataclasses

    import numpy as np
    import torch

    from recon3d_tpu_torch import convert
    from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
    from recon3d_tpu_torch.pointcloud import normals, voxel
    from recon3d_tpu_torch.utils.types import CameraIntrinsics, compact

    # ---- registration: Scanner3D.register_fragments' chain on 8 capture frames
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "registration: TF32 is on for float32 products")
    rg = REGISTRATION
    rcam = SyntheticRGBDCamera(rg["width"], rg["height"])
    rcam.open()
    reg_frames = [rcam.grab() for _ in range(rg["frames"])]
    reg_intr = CameraIntrinsics(rcam.fx, rcam.fy, rcam.cx, rcam.cy)
    t_phase = time.perf_counter()
    reg_times = {}
    chain, launches = counted(lambda: registration_chain(reg_frames, reg_intr, dev, reg_times), {})
    all_launches["registration"] = launches
    reg_pairs, reg_graph = chain["pairs"], chain["graph"]
    # the card against the host on the first cpu_frames frames (the host's
    # run of all 8 took 76-95 s of the script): the host runs the chain on
    # them; its pairs are pairs of the card's 8-frame run (the same clouds,
    # the same seeded trials), so only their pose graph is solved again on
    # the card
    n_cpu = rg["cpu_frames"]
    t0 = time.perf_counter()
    host = registration_chain(reg_frames[:n_cpu], reg_intr, "cpu", optimize=False)
    cpu_chain_s = time.perf_counter() - t0
    by_pair = {r["pair"]: r for r in reg_pairs}
    check(all(p in by_pair for p in chain_pairs(n_cpu)),
          "registration: the host's pairs are not pairs of the card's run")
    card_pairs = [by_pair[p] for p in chain_pairs(n_cpu)]
    # each cpu_frames graph solved once, its nodes, kept edges and weights read
    card_nodes, card_edges, card_weights = solve_graph(
        chain_graph(card_pairs, n_cpu, dev, optimize=False)[0], dev)
    cpu_nodes, cpu_edges, cpu_weights = solve_graph(host["graph_in"], "cpu")
    cpu_pairs = host["pairs"]
    nodes = np.stack(reg_graph.nodes)
    check(len(nodes) == rg["frames"] and np.isfinite(nodes).all(),
          "registration: the pose graph lost a node or holds a non-finite pose")
    pose0 = rcam.true_pose(0)
    truth = [pose0 @ np.linalg.inv(rcam.true_pose(k)) for k in range(rg["frames"])]
    # (center m, normal, angle) a pair against the host's (in the target's
    # frame) and a node against the host's and the truth (in frame 0's)
    vs_cpu_pair = [scene_motion(a["T"], b["T"], rcam.true_pose(a["pair"][1]))
                   for a, b in zip(card_pairs, cpu_pairs)]
    vs_cpu_node = [scene_motion(a, b, pose0) for a, b in zip(card_nodes, cpu_nodes)]
    vs_truth = [scene_motion(a, b, pose0) for a, b in zip(nodes, truth)]
    worst = lambda rows, i: max(r[i] for r in rows)  # noqa: E731
    good_cpu_only = [a["pair"] for a, b in zip(card_pairs, cpu_pairs)
                     if b["good"] and not a["good"]]
    # bars: every pair the host calls good is good on the card; against the
    # host's run (the same CPU-drawn trials) and the truth, the sphere's
    # center within 1 mm / 5 mm and the plane's normal within 1e-3 / 5e-3.
    # The angle about the normal through the center is reported, not held:
    # the scene does not fix it, so FPFH and ICP leave it where rounding
    # takes them (host runs alone differ by up to 4e-4 rad).
    bars = [(not good_cpu_only, f"registration: good on the host, weak on the card: "
                                f"{good_cpu_only}"),
            (worst(vs_cpu_pair, 0) <= 1e-3 and worst(vs_cpu_pair, 1) <= 1e-3
             and worst(vs_cpu_node, 0) <= 1e-3 and worst(vs_cpu_node, 1) <= 1e-3,
             f"registration: card vs host {vs_cpu_pair} {vs_cpu_node}"),
            (worst(vs_truth, 0) <= 5e-3 and worst(vs_truth, 1) <= 5e-3,
             f"registration: against the truth {vs_truth}")]
    # one pair (1 -> 0) stage by stage, and the pose graph again, on the card
    from recon3d_tpu_torch.registration import features as rfeat, icp as ricp
    from recon3d_tpu_torch.registration import ransac as rransac
    from recon3d_tpu_torch.registration.posegraph import global_optimization

    (src, tgt), (fs, ft) = chain["clouds"][1::-1], chain["feats"][1::-1]
    thr = 1.5 * 0.02
    stamps = [time.perf_counter()]

    def stamp():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    s2t, ok = rfeat.match_features(fs, src.valid, ft, tgt.valid)
    stamp()
    picks, score_idx = rransac.draw_trials(ok, 65536, 3, 2048, 0)
    stamp()
    scores, Ts = rransac._ransac_trials(src.points, tgt.points[s2t.long()], picks, score_idx, thr)
    T0 = Ts[torch.argmax(scores)]
    stamp()
    icp_res = ricp.registration_icp(src, tgt, thr, init=T0, method="point_to_plane",
                                    max_iterations=30)
    stamp()
    ricp.information_matrix(src, tgt, thr, icp_res.transformation)
    stamp()
    stage_ms = dict(zip(("match_features", "draw_trials", "ransac_trials", "icp_refine",
                         "information"),
                        (round((b - a) * 1e3, 3) for a, b in zip(stamps, stamps[1:]))))
    stage_ms["icp_iterations"] = int(icp_res.iterations)
    t0 = time.perf_counter()
    global_optimization(chain["graph_in"], device=dev)
    torch.cuda.synchronize()
    pose_graph_ms = (time.perf_counter() - t0) * 1e3
    prof_pair, _ = device_profile(lambda: rransac.registration_ransac_fpfh(
        src, tgt, fs, ft, distance_threshold=thr), host_ops=False)
    # five LM sweeps under the profiler (its post-processing of jacfwd's
    # host events grows with the sweeps; the default 50 took ~70 s)
    prof_graph, _ = device_profile(lambda: global_optimization(chain["graph_in"], max_iterations=5,
                                                               device=dev), host_ops=False)
    emit({"phase": "registration", "frames": rg["frames"], "frame": [rg["height"], rg["width"]],
          "capacity": rg["capacity"], "pairs": [r["pair"] for r in reg_pairs],
          "launches": all_launches["registration"],
          "preprocess_ms_median": round(statistics.median(reg_times["preprocess"]), 3),
          "pair_ms_median": round(statistics.median(reg_times["pair"]), 3),
          "pose_graph_ms": round(pose_graph_ms, 3),
          "pose_graph_first_ms": round(reg_times["pose_graph"][0], 3),
          "preprocess_ms": [round(t, 3) for t in reg_times["preprocess"]],
          "pair_ms": [round(t, 3) for t in reg_times["pair"]], "pair_1_0_stages_ms": stage_ms,
          "fitness": [round(r["fitness"], 6) for r in reg_pairs],
          "rmse": [round(r["rmse"], 7) for r in reg_pairs],
          "icp_iterations": [r["iterations"] for r in reg_pairs],
          "good": [r["good"] for r in reg_pairs], "points": [r["points"] for r in reg_pairs],
          "edges": len(reg_graph.edges), "card_edges_cpu_frames": card_edges,
          "cpu_edges": cpu_edges,
          # the pruning's input: each edge's final line-process weight (pruned
          # below 0.25), the card's and the host's graphs on the same frames
          "edge_weights_card_cpu_frames": card_weights, "cpu_edge_weights": cpu_weights,
          "card_good_cpu_frames": [r["good"] for r in card_pairs],
          "pose_err_max": float(max(np.abs(a - b).max() for a, b in zip(nodes, truth))),
          "translation_err_max_m": float(max(np.linalg.norm(a[:3, 3] - b[:3, 3])
                                             for a, b in zip(nodes, truth))),
          "vs_truth_center_normal_angle": vs_truth,
          "cpu_frames": n_cpu, "cpu_pairs": [r["pair"] for r in cpu_pairs],
          "vs_cpu_pair_T_max": float(max(np.abs(a["T"] - b["T"]).max()
                                         for a, b in zip(card_pairs, cpu_pairs))),
          "vs_cpu_pair_center_normal_angle": vs_cpu_pair,
          "vs_cpu_node_center_normal_angle": vs_cpu_node,
          "cpu_good": [r["good"] for r in cpu_pairs],
          "cpu_fitness": [round(r["fitness"], 6) for r in cpu_pairs],
          "cpu_icp_iterations": [r["iterations"] for r in cpu_pairs],
          "cpu_chain_s": round(cpu_chain_s, 3), "profiled_pair": prof_pair,
          "profiled_pose_graph_5_sweeps": prof_graph,
          "phase_s": round(time.perf_counter() - t_phase, 3)})
    for ok, what in bars:  # after the line, so a failed bar still shows its numbers
        check(ok, what)

    # ---- odometry: the streaming path's per-frame step, frames 0 -> 1
    from recon3d_tpu_torch.registration.odometry import compute_rgbd_odometry

    t_phase = time.perf_counter()
    (c0, d0), (c1, d1) = reg_frames[:2]
    o_intr = convert.camera_intrinsics(rcam.fx, rcam.fy, rcam.cx, rcam.cy)
    o_src, o_tgt = (convert.rgbd_image(c, d, device=dev) for c, d in ((c0, d0), (c1, d1)))
    odo = lambda: compute_rgbd_odometry(o_src, o_tgt, o_intr)  # noqa: E731
    res_o, launches = counted(odo, {})
    all_launches["odometry"] = launches
    odo_ms, odo_peak, _ = timed_frames(odo, rg["odometry_runs"], 2)
    prof_odo, _ = device_profile(odo, host_ops=False)
    res_oc = compute_rgbd_odometry(*(convert.rgbd_image(c, d, device="cpu")
                                     for c, d in ((c0, d0), (c1, d1))), o_intr)
    T_o = res_o.transformation.cpu().double().numpy()
    T_true = rcam.true_pose(1) @ np.linalg.inv(rcam.true_pose(0))
    t_err = float(np.linalg.norm(T_o[:3, 3] - T_true[:3, 3]))
    r_err = float(np.abs(T_o[:3, :3] - T_true[:3, :3]).max())
    o_diff = float(np.abs(T_o - res_oc.transformation.double().numpy()).max())
    frac_diff = abs(float(res_o.inlier_fraction) - float(res_oc.inlier_fraction))
    # bars: tests/test_registration.py:341-347 against the truth; against
    # the host: transform atol 1e-4, success equal, inlier share within 1e-3
    bars = [(bool(res_o.success) and t_err < 0.005 and r_err < 0.01,
             f"odometry: {t_err} m / {r_err} from the truth"),
            (o_diff <= 1e-4 and bool(res_oc.success) == bool(res_o.success)
             and frac_diff <= 1e-3, f"odometry: card vs host {o_diff}, inlier share {frac_diff}")]
    emit({"phase": "odometry", "frame": [rg["height"], rg["width"]], "levels": 3,
          "iterations": [10, 10, 10], "warp": "gather", "launches": launches,
          "ms_median": round(statistics.median(odo_ms), 3), "ms": [round(t, 3) for t in odo_ms],
          "peak_mem_bytes": odo_peak, "profiled": prof_odo,
          "translation_err_m": t_err, "rotation_err": r_err,
          "inlier_fraction": float(res_o.inlier_fraction), "vs_cpu_T_max": o_diff,
          "vs_cpu_inlier_fraction": frac_diff,
          "phase_s": round(time.perf_counter() - t_phase, 3)})
    for ok, what in bars:
        check(ok, what)

    # ---- icp: the alignment shim and GICP on the backprojected frames 0 -> 1
    from recon3d_tpu_torch.config import RegistrationConfig
    from recon3d_tpu_torch.pointcloud_alignment import PointCloudAlignment
    from recon3d_tpu_torch.registration import icp as ricp
    from recon3d_tpu_torch.pointcloud.backproject import backproject_depth

    t_phase = time.perf_counter()
    rcfg = RegistrationConfig()
    icp_pcs = [backproject_depth(torch.tensor(d, device=dev), reg_intr, depth_trunc=3.0)
               for _, d in reg_frames[:2]]
    icp_host = [convert.point_cloud({"points": pc.points.cpu().numpy(),
                                     "valid": pc.valid.cpu().numpy()}, device="cpu")
                for pc in icp_pcs]
    vox = [voxel.voxel_downsample(pc, rcfg.voxel_size) for pc in icp_pcs]
    n_valid = [int(v.valid.sum()) for v in vox]
    gcap = max(16384, 1 << (max(n_valid) - 1).bit_length())
    gicp_in = [compact(v, gcap) for v in vox]

    def host(pc):
        return convert.point_cloud({k: None if getattr(pc, k) is None
                                    else getattr(pc, k).cpu().numpy()
                                    for k in ("points", "valid", "normals")}, device="cpu")

    def p2plane_host():
        """The shim's point-to-plane steps on the host, the target normals the
        card's (their plain K7 / K8 at G = 128 take minutes on a host CPU)."""
        tgt_n = normals.estimate_normals(vox[1], radius=2.0 * rcfg.voxel_size, max_nn=30)
        return ricp.registration_icp(
            voxel.voxel_downsample(icp_host[0], rcfg.voxel_size), host(tgt_n),
            threshold=rcfg.icp_threshold, method="point_to_plane",
            max_iterations=rcfg.icp_max_iterations, relative_fitness=rcfg.icp_rel_fitness,
            relative_rmse=rcfg.icp_rel_rmse)

    def gicp(pcs):
        covs = [ricp.covariances_for_gicp(pc) for pc in pcs]
        return ricp.registration_icp(*pcs, threshold=rcfg.icp_threshold, method="gicp",
                                     max_iterations=rcfg.icp_max_iterations,
                                     relative_fitness=rcfg.icp_rel_fitness,
                                     relative_rmse=rcfg.icp_rel_rmse, source_cov=covs[0],
                                     target_cov=covs[1])

    shim = {m: PointCloudAlignment(dataclasses.replace(rcfg, method=m))
            for m in ("point_to_point", "point_to_plane")}
    cases = (("point_to_point", lambda: shim["point_to_point"].align_point_clouds(*icp_pcs)[1],
              lambda: shim["point_to_point"].align_point_clouds(*icp_host)[1], {}, vox),
             ("point_to_plane", lambda: shim["point_to_plane"].align_point_clouds(*icp_pcs)[1],
              p2plane_host, {"K7": 1, "K8": 1}, vox),
             ("gicp", lambda: gicp(gicp_in), lambda: gicp([host(pc) for pc in gicp_in]), {},
              gicp_in))
    icp_out, bars = {}, []
    for name, fn, host_fn, expected, ins in cases:
        res_i, launches = counted(fn, expected)
        all_launches[f"icp_{name}"] = launches
        ms_i, _, _ = timed_frames(fn, rg["icp_runs"], 1)
        prof_i, _ = device_profile(fn, host_ops=False)
        res_h = host_fn()
        N, M = ins[0].capacity, ins[1].capacity
        T_diff = float((res_i.transformation.cpu() - res_h.transformation).abs().max())
        fit_diff = abs(float(res_i.fitness) - float(res_h.fitness))
        icp_out[name] = {"N": N, "M": M, "valid": [int(pc.valid.sum()) for pc in ins],
                         "branch": "grid" if ricp.uses_grid(N, M) else "brute_force",
                         "launches": launches, "ms_median": round(statistics.median(ms_i), 3),
                         "ms": [round(t, 3) for t in ms_i], "iterations": int(res_i.iterations),
                         "fitness": float(res_i.fitness), "rmse": float(res_i.inlier_rmse),
                         "cpu_iterations": int(res_h.iterations), "vs_cpu_T_max": T_diff,
                         "vs_cpu_fitness": fit_diff, "profiled": prof_i}
        # bars: the card against the host, transform atol 1e-3 and fitness
        # within 1e-3 (each stops where its own rounding decides)
        bars.append((T_diff <= 1e-3 and fit_diff <= 1e-3 and float(res_i.fitness) > 0.3,
                     f"icp {name}: {icp_out[name]}"))
    cov_ms = cuda_ms(lambda: [ricp.covariances_for_gicp(pc) for pc in gicp_in], 3)
    emit({"phase": "icp", "voxel_size": rcfg.voxel_size, "threshold": rcfg.icp_threshold,
          "max_iterations": rcfg.icp_max_iterations, "gicp_capacity": gcap,
          "gicp_covariances_ms": round(cov_ms, 3), **icp_out,
          "phase_s": round(time.perf_counter() - t_phase, 3)})
    for ok, what in bars:
        check(ok, what)


def sync_sites(fn):
    """fn() under torch.cuda's sync debug mode: its result and the host
    syncs it made, counted by the line of the port that made them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return out, sites


def streaming_phase(dev, counted, all_launches):
    """The streaming phase: StreamingFusion at ScannerConfig()'s defaults
    (256^3, keyframe tracking, auto-batching, queue 10, live mesher, an
    auto-fit origin) on 30 SyntheticRGBDCamera(640, 480) frames: the
    threaded stream, the same frames through _fuse_one, the plain path,
    a checkpoint / resume with the rest as one backlog, the host CPU's first frames
    and a DepthFilterBank() chain. `counted` runs a path with the launch
    counters at 0 and holds its counts. The bars are checked after the
    phase's line, so a failed one still shows its numbers."""
    import numpy as np
    import torch

    from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
    from recon3d_tpu_torch.config import ScannerConfig
    from recon3d_tpu_torch.depth.filters import DepthFilterBank
    from recon3d_tpu_torch.pipeline.streaming import StreamingFusion
    from recon3d_tpu_torch.utils.types import CameraIntrinsics

    t_phase = time.perf_counter()
    cs = STREAMING
    N = cs["frames"]
    out_dir = tempfile.TemporaryDirectory()
    cfg = dataclasses.replace(ScannerConfig(), output_dir=out_dir.name)  # the log's directory
    fc = cfg.fusion
    out, bars, parts_s = {}, [], {}
    stamp = [time.perf_counter()]

    def part(name):
        """Seconds since the last part ended."""
        now = time.perf_counter()
        parts_s[name] = round(now - stamp[0], 3)
        stamp[0] = now

    def camera():
        return SyntheticRGBDCamera(cs["width"], cs["height"], n_frames=N, step=cs["step"])

    cam = camera()
    cam.open()
    frames = [cam.grab() for _ in range(N)]
    intr = CameraIntrinsics(cam.fx, cam.fy, cam.cx, cam.cy)

    def scanner(device=dev, **kw):
        return StreamingFusion(camera(), intr, cfg, resolution=fc.grid_resolution,
                               queue_size=cs["queue_size"], tracking="keyframe",
                               consume_batch="auto", live_mesher=True, device=device, **kw)

    def same(a, b, what):
        """A bar: trajectory and volume bitwise."""
        ok = len(a.trajectory) == len(b.trajectory) == N and all(
            torch.equal(p, q) for p, q in zip(a.trajectory, b.trajectory)) and all(
            torch.equal(getattr(a.volume, k), getattr(b.volume, k))
            for k in ("tsdf", "weight", "color", "origin"))
        bars.append((ok, f"streaming: {what}: the trajectory or the volume differs"))
        return ok

    # ---- (a) the threaded stream: warmup, start(max_frames=N), stop()
    sf = scanner()
    sf.warmup(*frames[0])
    part("warmup")
    check(sf._state is None and sf.frames_integrated == 0 and not sf.trajectory
          and not bool(sf.volume.weight.any()), "streaming: warmup touched the scan's state")

    def stream():
        # join, not poll: a polling main thread takes the interpreter lock
        # from the fusion thread, whose launches are host-bound
        t0 = time.perf_counter()
        sf.start(max_frames=N)
        for t in sf._threads:
            t.join(timeout=max(1.0, t0 + cs["stream_timeout_s"] - time.perf_counter()))
        sf.stop()
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    stream_s, launches = counted(stream, {"fuse": N})
    part("stream")
    all_launches["streaming"] = launches
    out["stream"] = {"frames_captured": sf.frames_captured,
                     "frames_integrated": sf.frames_integrated,
                     "odometry_failures": sf.odometry_failures,
                     "host_failures": sf._host_failures, "wall_s": round(stream_s, 4),
                     "fps": round(sf.frames_integrated / stream_s, 4),
                     "drain_cap": sf._consume_batch}
    check(sf.frames_captured == sf.frames_integrated == N and sf._host_failures == 0
          and sf.odometry_failures == 0, f"streaming: the stream lost frames: {out['stream']}")

    # ---- (b) the same frames through _fuse_one, one at a time
    dev_frames = [(torch.tensor(c, device=dev), torch.tensor(d, device=dev)) for c, d in frames]
    seq = scanner()
    frame_ms, live, peak = [], {}, {}

    def live_mesh(after):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        m = seq.extract_mesh_live()
        torch.cuda.synchronize(dev)
        live[after] = {"ms": round((time.perf_counter() - t0) * 1e3, 3),
                       "vertices": int(m.vertex_valid.sum()),
                       "triangles": int(m.triangle_valid.sum())}

    def sequential():
        for k, (c, d) in enumerate(dev_frames[:N - cs["profile_frames"]]):
            t0 = time.perf_counter()
            seq._fuse_one(c, d, fc)
            torch.cuda.synchronize(dev)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            if k == 0:
                live_mesh("frame_1")
                torch.cuda.reset_peak_memory_stats(dev)
            if k == 4:
                peak["frame_5"] = torch.cuda.max_memory_allocated(dev)
        # the last frames under torch.profiler: the device's busy share
        t0 = time.perf_counter()
        prof, dev_us = device_profile(lambda: [seq._fuse_one(c, d, fc)
                                               for c, d in dev_frames[N - cs["profile_frames"]:]],
                                      top=8, calls=cs["profile_frames"], host_ops=False)
        parts_s["profile"] = round(time.perf_counter() - t0, 3)
        peak["frame_n"] = torch.cuda.max_memory_allocated(dev)
        return prof, dev_us

    (prof, dev_us), launches = counted(sequential, {"fuse": N})
    part("sequential")
    if prof is not None:
        prof["fuse_ms"] = round(sum(t for k, t in dev_us.items() if "tsdf_fuse" in k)
                                / 1e3 / cs["profile_frames"], 4)
    out.update(fuse_one_launches=launches,
               fuse_one_ms_median=round(statistics.median(frame_ms[1:]), 3),
               fuse_one_ms=[round(t, 3) for t in frame_ms], profiled=prof)
    same(sf, seq, "the threaded stream against _fuse_one")
    live_mesh(f"frame_{N}")
    out["live_mesh"], out["peak_mem_bytes"] = live, peak
    part("live_mesh")
    # peak memory: the volume is written in place, so it stops growing
    bars.append((peak["frame_n"] - peak["frame_5"] <= cs["peak_slack_bytes"],
                 f"streaming: peak memory grew from frame 5 to {N}: {peak}"))

    # against the truth: world_from_cam(k) ~ inv(true_pose(k))
    drift = [float(np.linalg.norm(seq.trajectory[k].cpu().double().numpy()[:3, 3]
                                  - np.linalg.inv(cam.true_pose(k))[:3, 3])) for k in range(N)]
    out.update(drift_m=[round(x, 6) for x in drift], drift_max_m=max(drift))
    bars.append((max(drift[1:4]) < 0.01, f"streaming: frames 1-3 drift {drift[1:4]} m"))
    # the mesh against the scene: the auto-fit origin centers the volume on
    # the frame's median point (0, 0, 1.8), so it holds the plane z = 1.8 and
    # the sphere's shadow on it (the sphere's visible face, z < 1.2, lies in
    # front of the volume); bar: each vertex's distance to the nearer surface
    # under a voxel (median)
    mesh = seq.extract_mesh()
    verts = mesh.vertices[mesh.vertex_valid]
    d_sph = ((verts - torch.tensor([0.0, 0.0, 1.2], device=dev)).norm(dim=1) - 0.3).abs()
    d_near = torch.minimum(d_sph, (verts[:, 2] - 1.8).abs())
    out["vs_truth"] = vs_truth = {
        "vertices": int(verts.shape[0]), "median_m": float(d_near.median()),
        "max_m": float(d_near.max()), "sphere_points": int((d_sph < 0.05).sum()),
        "plane_points": int(((verts[:, 2] - 1.8).abs() < 0.05).sum())}
    bars.append((vs_truth["vertices"] > 1000 and vs_truth["median_m"] < fc.voxel_size,
                 f"streaming: the mesh is far from the scene: {vs_truth}"))
    part("extract_mesh")

    # the live mesh against the full extract: equal vertex and face sets,
    # vertices within 1e-6, the same triangles cut by the per-slab caps
    out["live_vs_full"] = lvf = live_against_full(seq.mesher, seq.volume,
                                                  seq.extract_mesh_live())
    bars.append((lvf["vertex_keys_equal"] and lvf["faces_equal"]
                 and lvf["vertex_max_abs"] <= 1e-6
                 and lvf["mesher_dropped"] == lvf["full_dropped"],
                 f"streaming: the live mesh differs from the full extract: {lvf}"))
    part("live_vs_full")

    # ---- (c) the plain path (PyTorch's projection and update, K9): bitwise
    with plain_fusion():
        plain = scanner()
        counted(lambda: [plain._fuse_one(c, d, fc) for c, d in dev_frames], {"K9": N})
    same(plain, seq, "the plain path")
    del plain
    part("plain_path")

    # ---- (d) checkpoint at N/2, restore, the rest as one backlog through
    # _fuse_frames (with profile=True: the step's stages, each ending in a
    # sync): bitwise against _fuse_one a frame; the host syncs of a step
    # counted on the first half
    half = N // 2
    ck = scanner()
    ck._fuse_one(*dev_frames[0], fc)
    torch.cuda.synchronize(dev)
    _, sites = sync_sites(lambda: [ck._fuse_one(c, d, fc) for c, d in dev_frames[1:half]])
    out.update(syncs_per_frame=sum(sites.values()) / (half - 1),
               sync_sites=dict(sorted(sites.items(), key=lambda kv: -kv[1])))
    ck_path = os.path.join(out_dir.name, "scan_ckpt.npz")
    t0 = time.perf_counter()
    ck.save_checkpoint(ck_path)
    t1 = time.perf_counter()
    resumed = scanner(profile=True).restore_checkpoint(ck_path)
    out["checkpoint"] = {"bytes": os.path.getsize(ck_path), "save_s": round(t1 - t0, 3),
                         "load_s": round(time.perf_counter() - t1, 3)}
    bars.append((resumed.frames_integrated == half,
                 "streaming: the checkpoint lost its frame count"))
    resumed._fuse_frames(dev_frames[half:], fc)
    same(resumed, seq, "checkpoint / resume, the rest through _fuse_frames")
    t = resumed.timer
    out.update(stages_ms_per_call={k: round(t.totals[k] * 1e3 / t.counts[k], 3) for k in t.totals},
               stage_calls=dict(t.counts))
    del ck, resumed
    part("checkpoint")

    # ---- (f) the port on the host CPU: the first frames
    nc = cs["cpu_frames"]
    host = scanner(device="cpu")
    for c, d in frames[:nc]:
        host._fuse_one(c, d, fc)
    vs_cpu = max(float((p.cpu() - q).abs().max())
                 for p, q in zip(seq.trajectory[:nc], host.trajectory))
    out.update(cpu_frames=nc, vs_cpu_trajectory_max=vs_cpu)
    bars.append((len(host.trajectory) == nc and vs_cpu <= 1e-4,
                 f"streaming: card against host trajectory {vs_cpu}"))
    del host
    part("cpu")

    # ---- (g) DepthFilterBank() at its defaults on the first depth frames
    bank = DepthFilterBank()
    filt_ms = []
    for _, d in dev_frames[:cs["filter_frames"]]:
        t0 = time.perf_counter()
        filtered = bank(d)
        torch.cuda.synchronize(dev)
        filt_ms.append((time.perf_counter() - t0) * 1e3)
    bars.append((bool(torch.isfinite(filtered).all()) and filtered.shape == d.shape,
                 "streaming: the filter chain's output"))
    out.update(filters_ms_median=round(statistics.median(filt_ms[1:]), 3),
               filters_ms=[round(t, 3) for t in filt_ms])
    part("filters")

    emit({"phase": "streaming", "frame": [cs["height"], cs["width"]], "frames": N,
          "resolution": fc.grid_resolution, "voxel_size": fc.voxel_size,
          "origin": seq.volume.origin.tolist(), "launches": all_launches["streaming"], **out,
          "bars_failed": [what for ok, what in bars if not ok], "parts_s": parts_s,
          "phase_s": round(time.perf_counter() - t_phase, 3)})
    out_dir.cleanup()
    for ok, what in bars:
        check(ok, what)


def keyed_mesh(vertex_keys, vertices, faces, valid=None):
    """A mesh as sets keyed by its vertices' weld keys (the integer keys the
    weld groups corners by, so two meshes welded from the same corners name
    each vertex alike however their means round): (vertex code -> position,
    the faces as rows of codes, each rotated to start at its least code
    (winding kept), sorted). Inputs are host arrays; `valid` picks the
    vertices that exist."""
    import numpy as np

    k = vertex_keys.astype(np.int64) + (1 << 20)
    code = (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]
    fc = code[faces]
    first = np.argmin(fc, axis=1)
    fc = np.take_along_axis(fc, (first[:, None] + np.arange(3)) % 3, axis=1)
    keep = np.ones(len(code), bool) if valid is None else valid
    return dict(zip(code[keep].tolist(), vertices[keep])), fc[np.lexsort(fc.T[::-1])]


def live_against_full(mesher, vol, live):
    """extract_mesh_live's mesh (`live`, the table's slots as vertices)
    against extract_triangle_mesh(vol), through the weld keys: the full
    extract's steps are replayed here to get each welded vertex's key and
    its output is required to equal that replay bitwise. Returns the
    numbers: equal vertex-key and face sets, and the largest vertex
    difference over equal keys."""
    import numpy as np
    import torch

    from recon3d_tpu_torch.fusion import marching

    budget = marching.default_max_triangles(vol.resolution)
    soup, valid, _, dropped = marching.extract_triangle_soup(vol, max_triangles=budget,
                                                             with_dropped=True, cap_mult=1)
    if int(dropped) > 0:
        soup, valid, _, dropped = marching.extract_triangle_soup(
            vol, max_triangles=budget, with_dropped=True, cap_mult=4)
    soup = marching._orient_by_gradient(vol, soup)
    verts, vvalid = soup.reshape(-1, 3), valid.repeat_interleave(3)
    quant = torch.tensor(float(vol.voxel_size) / 256.0, dtype=torch.float32, device=soup.device)
    vsum, vcnt, inv, n_u = marching._weld_device_hash(verts, vvalid, quant, ref=vol.origin)
    n_u = int(n_u)
    full_v = (vsum[:n_u].double() / vcnt[:n_u].double()[:, None]).to(torch.float32)
    faces = inv.reshape(-1, 3)[valid]
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])]
    full = marching.extract_triangle_mesh(vol)
    check(torch.equal(full.vertices, full_v) and torch.equal(full.triangles, faces),
          "streaming: the replayed full extract differs from extract_triangle_mesh")
    q = marching._quantize(verts, vvalid, quant, vol.origin)
    full_keys = torch.zeros((n_u, 3), dtype=torch.int32, device=q.device)
    full_keys[inv[vvalid].long()] = q[vvalid]
    fv, ff = keyed_mesh(full_keys.cpu().numpy(), full_v.cpu().numpy(),
                        faces.long().cpu().numpy())
    lv, lf = keyed_mesh(mesher.cache.key.cpu().numpy(), live.vertices.cpu().numpy(),
                        live.triangles[live.triangle_valid].long().cpu().numpy(),
                        live.vertex_valid.cpu().numpy())
    out = {"vertices": [len(lv), len(fv)], "faces": [len(lf), len(ff)],
           "vertex_keys_equal": lv.keys() == fv.keys(),
           "faces_equal": bool(lf.shape == ff.shape and np.array_equal(lf, ff)),
           "full_dropped": int(dropped), "mesher_dropped": mesher.dropped_triangles}
    if out["vertex_keys_equal"]:
        out["vertex_max_abs"] = float(max(np.abs(lv[k] - fv[k]).max() for k in fv))
    return out


def board_poses(rig, n, seed):
    """n board poses (rvec, tvec: board -> left camera) at z 0.6-1.2 m,
    tilted up to CALIBRATION["tilt"] rad about x and y and rolled up to
    CALIBRATION["roll"], each with the whole board (its outer squares and a
    margin) inside both cameras' images."""
    import numpy as np

    from recon3d_tpu_torch.calib import model as cm

    c = CALIBRATION
    nx, ny = c["pattern"]
    sq = c["square"]
    rng = np.random.RandomState(seed)
    outline = np.array([[x, y, 0.0] for x in (-sq, nx * sq) for y in (-sq, ny * sq)])
    center_b = np.array([(nx - 1) * sq / 2, (ny - 1) * sq / 2, 0.0])
    Kinv = np.linalg.inv(rig.mtx1)
    poses = []
    while len(poses) < n:
        rvec = np.array([rng.uniform(-c["tilt"], c["tilt"]), rng.uniform(-c["tilt"], c["tilt"]),
                         rng.uniform(-c["roll"], c["roll"])])
        z = rng.uniform(*c["z"])
        target = np.array([rng.uniform(0.3, 0.7) * W, rng.uniform(0.3, 0.7) * H, 1.0])
        tvec = z * (Kinv @ target) - rodrigues(rvec) @ center_b
        ok = True
        for K, d, (rv, tv) in ((rig.mtx1, rig.dist1, (rvec, tvec)),
                               (rig.mtx2, rig.dist2, right_pose(rig, rvec, tvec))):
            px = cm.project_points(outline, rv, tv, K, d).numpy()
            m = c["margin_px"]
            ok &= bool((px[:, 0] > m).all() and (px[:, 0] < W - 1 - m).all()
                       and (px[:, 1] > m).all() and (px[:, 1] < H - 1 - m).all())
        if ok:
            poses.append((rvec, tvec))
    return poses


def right_pose(rig, rvec, tvec):
    """The board's pose in the right camera: X_r = R X_l + T."""
    import numpy as np
    import torch

    from recon3d_tpu_torch.calib import model as cm

    R = np.asarray(rig.R, np.float64)
    Rr = R @ rodrigues(rvec)
    return cm.inv_rodrigues(torch.as_tensor(Rr)).numpy(), R @ tvec + rig.T.ravel()


def render_board(K, dist, rvec, tvec, device, rows=60):
    """The 9x6 board (10x7 squares, black 30 / white 220, a white surround)
    seen by a camera with intrinsics K and distortion dist at the pose
    (rvec, tvec), (H, W) uint8: each pixel the mean of supersample^2 rays,
    each ray undistorted (20 fixed-point steps), cast and intersected with
    the board's plane in float64 on `device`, then the lens's blur (a
    Gaussian, CALIBRATION["lens_blur"]) and rounding to 8 bits."""
    import numpy as np
    import torch

    from recon3d_tpu_torch.calib import model as cm
    from recon3d_tpu_torch.ops import image as im

    c = CALIBRATION
    nx, ny = c["pattern"]
    sq, ss = c["square"], c["supersample"]
    f64 = dict(dtype=torch.float64, device=device)
    R = torch.as_tensor(rodrigues(rvec), **f64)
    t = torch.as_tensor(np.asarray(tvec, np.float64), **f64)
    Kt, dt = torch.as_tensor(np.asarray(K), **f64), torch.as_tensor(np.asarray(dist), **f64)
    off = (torch.arange(ss, **f64) + 0.5) / ss - 0.5
    out = torch.empty((H, W), dtype=torch.float32, device=device)
    u = torch.arange(W, **f64)
    for y0 in range(0, H, rows):
        v = torch.arange(y0, min(y0 + rows, H), **f64)
        pu = u[None, :, None, None] + off[None, None, None, :]
        pv = v[:, None, None, None] + off[None, None, :, None]
        pts = torch.stack(torch.broadcast_tensors(pu, pv), -1)
        xy = cm.undistort_points(pts, Kt, dt, iters=20)
        ray = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
        # the plane z_b = 0: R[:, 2] . (s ray - t) = 0
        s = (R[:, 2] @ t) / (ray @ R[:, 2])
        b = (s[..., None] * ray - t) @ R  # board coords: R^T (s ray - t)
        i, j = torch.floor(b[..., 0] / sq), torch.floor(b[..., 1] / sq)
        on = (i >= -1) & (i <= nx - 1) & (j >= -1) & (j <= ny - 1) & (s > 0)
        black = on & (torch.remainder(i + j, 2) == 0)
        val = torch.where(black, 30.0, 220.0).mean((-2, -1))
        out[y0:y0 + v.shape[0]] = val
    return torch.round(im.gaussian_blur(out, *c["lens_blur"])).to(torch.uint8)


def board_views(device):
    """The phase's inputs: pipeline_rig(), the board poses, the 15 rendered
    pairs ((H, W) uint8 on `device`), the true corners of each view (V, N,
    2) float64 and the initial corners (true + U(-0.75, 0.75) px, seeded),
    float32."""
    import numpy as np

    from recon3d_tpu_torch.calib import chessboard as cb
    from recon3d_tpu_torch.calib import model as cm

    c = CALIBRATION
    rig = pipeline_rig()
    poses = board_poses(rig, c["pairs"], c["seed"])
    obj = cb.chessboard_object_points(c["pattern"], c["square"])
    imgs, truth = {"left": [], "right": []}, {"left": [], "right": []}
    for rvec, tvec in poses:
        for side, K, d, (rv, tv) in (("left", rig.mtx1, rig.dist1, (rvec, tvec)),
                                     ("right", rig.mtx2, rig.dist2, right_pose(rig, rvec, tvec))):
            imgs[side].append(render_board(K, d, rv, tv, device))
            truth[side].append(cm.project_points(obj, rv, tv, K, d).numpy())
    rng = np.random.RandomState(c["seed"] + 1)
    truth = {k: np.stack(v) for k, v in truth.items()}
    init = {k: (v + rng.uniform(-c["jitter_px"], c["jitter_px"], v.shape)).astype(np.float32)
            for k, v in truth.items()}
    return rig, poses, imgs, truth, init


def calibration_phase(dev, counted, timed_frames, all_launches, fr):
    """The calibration phase: calibrate -> rectify -> depth on the card.
    15 rendered pairs of pipeline_rig() (board_views); corners refined by
    corner_subpix from the stand-in detection; api.stereo_calibrate_camera
    with its detection replaced by those corners (calibrate_camera x 2,
    stereo_calibrate, stereo_rectify, the NPZ, the report) on the card, and
    the same on the host in float64; a raw-schema NPZ of the result through
    DepthPipeline.from_npz and one counted frame of the bench's raw pair;
    the census cost and census SGM, card against host. `fr` carries the
    frame context of main (raw_l, raw_r, gl, gr, dt, m, w, against,
    frame_stats). The bars are checked after the phase's line."""
    import numpy as np
    import torch

    from recon3d_tpu_torch.calib import api, chessboard as cb, lm, mono, npz, stereo
    from recon3d_tpu_torch.depth import DepthPipeline, cost as dcost, sgm
    from recon3d_tpu_torch.depth.matcher import disparity_to_depth
    from recon3d_tpu_torch.ops import warp

    t_phase = time.perf_counter()
    c = CALIBRATION
    out, bars, parts_s = {}, [], {}
    stamp = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts_s[name] = round(now - stamp[0], 3)
        stamp[0] = now

    def bar(ok, what):
        bars.append((bool(ok), f"calibration: {what}"))

    # ---- the pairs and the stand-in detection
    rig, poses, imgs, truth, init = board_views(dev)
    torch.cuda.synchronize()
    part("render")
    V = c["pairs"]
    refined = {}
    t0 = time.perf_counter()
    for side in ("left", "right"):
        refined[side] = np.stack([cb.corner_subpix(
            imgs[side][v].to(torch.float32), torch.as_tensor(init[side][v], device=dev)
        ).cpu().numpy().astype(np.float64) for v in range(V)])
    subpix_s = time.perf_counter() - t0
    err = np.linalg.norm(np.concatenate([refined["left"] - truth["left"],
                                         refined["right"] - truth["right"]]), axis=-1)
    err0 = np.linalg.norm(np.concatenate([init["left"] - truth["left"],
                                          init["right"] - truth["right"]]), axis=-1)
    nh = c["host_refine_pairs"]
    host_sub = max(float(np.abs(cb.corner_subpix(
        imgs[side][v].cpu().to(torch.float32), torch.as_tensor(init[side][v])
    ).numpy() - refined[side][v]).max()) for side in ("left", "right") for v in range(nh))
    out["corners"] = {"views": 2 * V, "per_view": int(err.shape[1]), "subpix_s": round(subpix_s, 3),
                      "initial_median_px": float(np.median(err0)),
                      "vs_truth_median_px": float(np.median(err)),
                      "vs_truth_max_px": float(err.max()),
                      "card_vs_host_max_px": host_sub, "host_pairs": nh}
    bar(np.median(err) <= 0.05 and err.max() <= 0.3, f"corners against the truth {out['corners']}")
    bar(host_sub <= 1e-3, f"corner_subpix card against host {host_sub}")
    part("corners")

    # ---- calibrate: the API with its detection replaced by the refined corners
    tmp = tempfile.TemporaryDirectory()
    stand_in = (lambda il, ir, ps, detector="opencv", device="cuda":  # noqa: E731
                ([refined["left"][v] for v in range(V)], [refined["right"][v] for v in range(V)],
                 list(range(V))))
    saved = {"detect": api.detect_corner_pairs, "lm": lm.levenberg_marquardt,
             "mono": mono.calibrate_camera, "stereo": stereo.stereo_calibrate,
             "rectify": stereo.stereo_rectify}
    record = {"iterations": [], "stages_s": {}}

    def lm_counted(*a, **k):
        res = saved["lm"](*a, **k)
        record["iterations"].append(res.iterations)
        return res

    def staged(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            res = fn(*a, **k)
            if res[0].is_cuda:
                torch.cuda.synchronize()
            record["stages_s"][name] = round(record["stages_s"].get(name, 0.0)
                                             + time.perf_counter() - t0, 4)
            return res
        return run

    images = {side: [im_.cpu().numpy() for im_ in imgs[side]] for side in imgs}

    def chain(device, tag):
        record["iterations"], record["stages_s"] = [], {}
        t0 = time.perf_counter()
        params, info = api.stereo_calibrate_camera(
            images["left"], images["right"], pattern_size=c["pattern"],
            square_size=c["square"], save_path=os.path.join(tmp.name, f"{tag}.npz"),
            report_path=os.path.join(tmp.name, f"{tag}_report.txt"), device=device)
        it = record["iterations"]
        return params, info, {"calibrate_s": round(time.perf_counter() - t0, 3),
                              "stages_s": dict(record["stages_s"]),
                              "lm_iterations": {"mono_left": it[0], "mono_right": it[1],
                                                "pnp_sum": sum(it[2:-1]),
                                                "pnp_max": max(it[2:-1]), "stereo": it[-1]}}

    api.detect_corner_pairs = stand_in
    lm.levenberg_marquardt = lm_counted
    mono.calibrate_camera = staged("calibrate_camera", saved["mono"])
    stereo.stereo_calibrate = staged("stereo_calibrate", saved["stereo"])
    stereo.stereo_rectify = staged("stereo_rectify", saved["rectify"])
    try:
        (params, info, card_t), sites = sync_sites(lambda: chain(dev, "card"))
        part("calibrate_card")
        hparams, hinfo, host_t = chain("cpu", "host")
        part("calibrate_host")
    finally:
        api.detect_corner_pairs = saved["detect"]
        lm.levenberg_marquardt = saved["lm"]
        mono.calibrate_camera = saved["mono"]
        stereo.stereo_calibrate = saved["stereo"]
        stereo.stereo_rectify = saved["rectify"]
    # the port's syncs: not the stage timers' own synchronize
    sites = {k: n for k, n in sites.items()
             if not (k.startswith("chip_smoke.py") or "torch/cuda/__init__.py" in k)}
    # the device's busy share over one calibrate_camera (the left camera's
    # LM over 4 + 5 + 6 V parameters): a trace of the whole chain (~10^5
    # short launches) takes the profiler half a minute to read
    objs = torch.as_tensor(np.stack([cb.chessboard_object_points(c["pattern"], c["square"])] * V),
                           device=dev)
    prof, _ = device_profile(lambda: mono.calibrate_camera(
        objs, torch.as_tensor(refined["left"], device=dev), (W, H)), top=4, host_ops=False)
    part("profile")
    report = open(os.path.join(tmp.name, "card_report.txt")).read()
    saved_npz = npz.inspect(os.path.join(tmp.name, "card.npz"))

    def rel(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())

    def absd(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    vs_host = {k: rel(getattr(params, k), getattr(hparams, k))
               for k in ("mtx1", "mtx2", "P1", "P2", "Q", "T")}
    vs_host.update({k: absd(getattr(params, k), getattr(hparams, k))
                    for k in ("dist1", "dist2", "R", "R1", "R2")})
    vs_host.update({k: abs(info[k] - hinfo[k]) / abs(hinfo[k])
                    for k in ("rms_left", "rms_right", "rms_stereo")})
    for k in ("mtx1", "mtx2", "P1", "P2", "Q", "T"):
        bar(vs_host[k] <= 1e-6, f"{k} card against host {vs_host[k]}")
    for k, tol in (("dist1", 1e-6), ("dist2", 1e-6), ("R", 1e-8), ("R1", 1e-8), ("R2", 1e-8)):
        bar(vs_host[k] <= tol, f"{k} card against host {vs_host[k]}")
    for k in ("rms_left", "rms_right", "rms_stereo"):
        bar(vs_host[k] <= 1e-8, f"{k} card against host {vs_host[k]}")

    def angle(Ra, Rb):
        cos = (np.trace(np.asarray(Ra) @ np.asarray(Rb).T) - 1.0) / 2.0
        return float(np.arccos(np.clip(cos, -1.0, 1.0)))

    vs_truth = {}
    for cam, K, Kt in (("left", params.mtx1, rig.mtx1), ("right", params.mtx2, rig.mtx2)):
        vs_truth[cam] = {"fx_rel": abs(K[0, 0] / Kt[0, 0] - 1.0),
                         "fy_rel": abs(K[1, 1] / Kt[1, 1] - 1.0),
                         "cx_px": abs(K[0, 2] - Kt[0, 2]), "cy_px": abs(K[1, 2] - Kt[1, 2])}
        bar(vs_truth[cam]["fx_rel"] <= 2e-3 and vs_truth[cam]["fy_rel"] <= 2e-3
            and vs_truth[cam]["cx_px"] <= 1.0 and vs_truth[cam]["cy_px"] <= 1.0,
            f"{cam} intrinsics against the truth {vs_truth[cam]}")
    vs_truth["T_norm_rel"] = abs(np.linalg.norm(params.T) / np.linalg.norm(rig.T) - 1.0)
    vs_truth["R_rad"] = angle(params.R, rig.R)
    vs_truth["dist1_max"] = absd(params.dist1.ravel(), rig.dist1.ravel())
    vs_truth["dist2_max"] = absd(params.dist2.ravel(), rig.dist2.ravel())
    bar(vs_truth["T_norm_rel"] <= 3e-3 and vs_truth["R_rad"] <= 1e-3,
        f"rig against the truth {vs_truth}")
    bar(info["rms_stereo"] <= 0.1, f"stereo rms {info['rms_stereo']}")
    out.update(detection="stand-in: true projections + seeded U(-0.75, 0.75) px, refined by "
                         "corner_subpix on the card (no OpenCV on this machine)",
               card=card_t, host=host_t, sync_sites=sites, syncs=sum(sites.values()),
               profile=prof,
               rms={"left": info["rms_left"], "right": info["rms_right"],
                    "stereo": info["rms_stereo"]},
               vs_host=vs_host, vs_truth=vs_truth, npz_keys=sorted(saved_npz),
               report_lines=report.count("\n"))
    bar(sorted(saved_npz) == sorted(npz.STEREO_FULL_KEYS), f"NPZ keys {sorted(saved_npz)}")

    # ---- depth from the result: a raw-schema NPZ through from_npz
    raw_path = os.path.join(tmp.name, "raw.npz")
    np.savez(raw_path, k1=params.mtx1, d1=params.dist1[0], k2=params.mtx2, d2=params.dist2[0],
             R=params.R, T=params.T.ravel())
    t0 = time.perf_counter()
    pipe = DepthPipeline.from_npz(raw_path, (W, H), matcher_config=fr["m"], wls_config=fr["w"],
                                  device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    part("from_npz")
    bar(pipe.plans is not None, "from_npz: the maps are not row-monotonic")
    raw_l, raw_r = fr["raw_l"], fr["raw_r"]
    (p_disp, p_depth, _), launches = counted(
        lambda: pipe.process(raw_l, raw_r), {"K1": 2, "K2": 1, "K3": 1, "K4": 1, "K6": 6})
    all_launches["calibration"] = launches
    plg = warp.remap_two_pass(raw_l, pipe.plans[0])
    prg = warp.remap_two_pass(raw_r, pipe.plans[1])
    u, vp = plain_disparity(plg, prg, fr["m"], fr["w"], 4)
    rmse_plain = fr["against"](p_disp, p_disp > 0, u, u > 0, "calibration")
    check(torch.allclose(p_depth, disparity_to_depth(u, pipe.Q), rtol=1e-3, atol=1e-4),
          "calibration: depth differs from the plain frame")
    del plg, prg, u, vp
    stats = fr["frame_stats"](*timed_frames(lambda: pipe.process(raw_l, raw_r)), "calibration")
    # the rectification maps against the true rig's, rectified the same way
    true_path = os.path.join(tmp.name, "true_raw.npz")
    np.savez(true_path, k1=rig.mtx1, d1=rig.dist1[0], k2=rig.mtx2, d2=rig.dist2[0], R=rig.R,
             T=rig.T.ravel())
    tp = npz.StereoParams.load(true_path)
    f32 = [np.asarray(a, np.float32) for a in (tp.mtx1, tp.dist1, tp.mtx2, tp.dist2, tp.R, tp.T)]
    rect_t = stereo.stereo_rectify(*f32[:4], (W, H), *f32[4:], device="cpu")
    maps_t = (stereo.rectify_maps(tp.mtx1, tp.dist1, rect_t.R1.numpy(), rect_t.P1.numpy(), (W, H),
                                  "cpu")
              + stereo.rectify_maps(tp.mtx2, tp.dist2, rect_t.R2.numpy(), rect_t.P2.numpy(), (W, H),
                                    "cpu"))
    dmap = torch.cat([(a.cpu() - b).abs().reshape(-1) for a, b in zip(pipe.maps, maps_t)])
    out["depth"] = {"init_s": round(init_s, 3), "launches": launches, **stats,
                    "rmse_vs_plain_px": rmse_plain,
                    "valid_fraction": round(float((p_disp > 0).float().mean()), 5),
                    "maps_vs_truth_median_px": float(dmap.median()),
                    "maps_vs_truth_max_px": float(dmap.max())}
    bar(float(dmap.median()) <= c["maps_median_px"],
        f"from_npz maps against the true rig's {out['depth']}")
    del pipe, p_disp, p_depth, dmap
    part("depth")

    # ---- census: the cost volume on the rectified pair, then census SGM on
    # the middle rows, card against host
    gl, gr = fr["gl"], fr["gr"]
    vol = dcost.census_cost_volume(gl, gr, D)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = dcost.census_cost_volume(gl, gr, D)
    torch.cuda.synchronize()
    census_ms = (time.perf_counter() - t0) * 1e3
    vol_h = dcost.census_cost_volume(gl.cpu(), gr.cpu(), D)
    census_equal = torch.equal(vol.cpu(), vol_h)
    del vol, vol_h
    r0, r1 = c["census_rows"]
    kw = dict(num_disparities=D, cost_kind="census")
    t0 = time.perf_counter()
    d_c, v_c = sgm.sgm_disparity(gl[r0:r1], gr[r0:r1], **kw)
    torch.cuda.synchronize()
    sgm_ms = (time.perf_counter() - t0) * 1e3
    d_h, v_h = sgm.sgm_disparity(gl[r0:r1].cpu(), gr[r0:r1].cpu(), **kw)
    d_c, v_c = d_c.cpu(), v_c.cpu()
    reg = torch.zeros_like(v_h)
    reg[:, D + 2:] = True
    both = v_c & v_h & reg
    dd = float((d_c - d_h).abs()[both].max()) if bool(both.any()) else 0.0
    dtr = fr["dt"][r0:r1].cpu()
    scored = v_c & (dtr > 1.0)
    out["census"] = {"volume_equal": census_equal, "volume_ms": round(census_ms, 3),
                     "sgm_rows": [r0, r1], "sgm_ms": round(sgm_ms, 3),
                     "sgm_valid_equal": torch.equal(v_c, v_h), "sgm_max_abs_diff": dd,
                     "sgm_valid_fraction": round(float(v_c.float().mean()), 5),
                     "sgm_rmse_vs_truth_px": float(torch.sqrt(((d_c - dtr)[scored] ** 2).mean()))}
    bar(census_equal, "the census cost volume differs between card and host")
    bar(out["census"]["sgm_valid_equal"] and dd < 1e-4, f"census SGM card against host {dd}")
    part("census")
    tmp.cleanup()
    emit({"phase": "calibration", "frame": [H, W], "pairs": V, "pattern": list(c["pattern"]),
          "square_m": c["square"], **out, "bars_failed": [w for ok, w in bars if not ok],
          "parts_s": parts_s, "phase_s": round(time.perf_counter() - t_phase, 3)})
    for ok, what in bars:
        check(ok, what)


def solve_graph(graph, dev):
    """global_optimization(graph) on `dev`, read whole: one LM solve
    (posegraph._optimize) and its pruning (an uncertain edge whose final
    line-process weight is below edge_prune_threshold, 0.25, is dropped).
    Returns (the nodes, the count of edges kept, each edge's weight)."""
    import inspect

    import numpy as np
    import torch

    from recon3d_tpu_torch.registration.posegraph import _optimize, global_optimization

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    es = graph.edges
    res = _optimize(put(np.stack(graph.nodes)), put([e.source for e in es], torch.int32),
                    put([e.target for e in es], torch.int32),
                    put(np.stack([e.transformation for e in es])),
                    put(np.stack([e.information for e in es])),
                    put([e.uncertain for e in es], torch.bool))
    prune = inspect.signature(global_optimization).parameters["edge_prune_threshold"].default
    w = res.edge_weights.cpu().numpy()
    kept = sum(1 for e, wi in zip(es, w) if not (e.uncertain and wi < prune))
    return list(res.poses.cpu().numpy()), kept, [round(float(wi), 6) for wi in w]


def scene_distance(p):
    """Distance (m) of world points (N, 3) to the synthetic scene: the
    nearer of the sphere (center (0, 0, 1.2), r 0.3) and the plane z = 1.8."""
    import torch

    d_sph = ((p - torch.tensor([0.0, 0.0, 1.2], device=p.device)).norm(dim=1) - 0.3).abs()
    return torch.minimum(d_sph, (p[:, 2] - 1.8).abs())


def offline_phase(dev, counted, all_launches):
    """The offline phase: Scanner3D(SyntheticRGBDCamera(640, 480, N
    frames), ScannerConfig()).run(N) on the card (the fuse kernel once a frame), its
    batched pairs against per-pair calls, its nodes and mesh against the
    truth, its PNG checkpoints replayed by FakeRGBDCamera and re-integrated
    by integrate_saved_frames (the fuse kernel once a frame) against the same _fuse_one
    loop, the pose graph's kept edges on the card and the host CPU and its
    line-process weights on the host CPU. The bars are checked after the
    phase's line."""
    import numpy as np
    import torch

    from recon3d_tpu_torch.camera.fake import FakeRGBDCamera, SyntheticRGBDCamera
    from recon3d_tpu_torch.config import ScannerConfig
    from recon3d_tpu_torch.pipeline.offline import Scanner3D
    from recon3d_tpu_torch.pipeline.streaming import StreamingFusion, integrate_saved_frames
    from recon3d_tpu_torch.registration.icp import information_matrix
    from recon3d_tpu_torch.registration.ransac import registration_ransac_fpfh
    from recon3d_tpu_torch.utils import io
    from recon3d_tpu_torch.utils.types import CameraIntrinsics

    t_phase = time.perf_counter()
    co = OFFLINE
    N = co["frames"]
    out_dir = tempfile.TemporaryDirectory()
    cfg = ScannerConfig(output_dir=out_dir.name)
    cam = SyntheticRGBDCamera(co["width"], co["height"], n_frames=N)
    intr = CameraIntrinsics(cam.fx, cam.fy, cam.cx, cam.cy)
    sc = Scanner3D(cam, intr, cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    path, launches = counted(lambda: sc.run(n_frames=N), {"fuse": N})
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    all_launches["offline"] = launches
    stages_ms = {k: round(v * 1e3, 3) for k, v in sc.timer.totals.items()}
    bars = []

    # the batched pairs against per-pair calls on two of them: the first
    # sequential pair and the first loop pair
    res, infos = sc.pair_results
    thr = 1.5 * cfg.registration.voxel_size
    trials = min(cfg.registration.ransac_max_iterations, 65536)
    checked = [0, N - 1]
    same = []
    for k in checked:
        i, j = sc.pairs[k]
        one = registration_ransac_fpfh(sc.clouds[i], sc.clouds[j], sc.feats[i], sc.feats[j],
                                       thr, num_trials=trials)
        info = information_matrix(sc.clouds[i], sc.clouds[j], thr, one.transformation)
        same.append(all(torch.equal(a, b[k]) for a, b in zip(one, res))
                    and torch.equal(info, infos[k]))
    bars.append((all(same), f"offline: batched pairs {[sc.pairs[k] for k in checked]} differ "
                            f"from their per-pair calls: {same}"))

    # the nodes against the truth (world = frame 0's camera)
    pose0 = cam.true_pose(0)
    vs_truth = [scene_motion(node, pose0 @ np.linalg.inv(cam.true_pose(k)), pose0)
                for k, node in enumerate(sc.pose_graph.nodes)]
    bars.append((len(vs_truth) == N and max(v[0] for v in vs_truth) <= 5e-3
                 and max(v[1] for v in vs_truth) <= 5e-3,
                 f"offline: nodes against the truth {vs_truth}"))

    # the mesh against the scene
    mesh = io.read_ply(path)
    d = scene_distance(torch.as_tensor(mesh["points"], dtype=torch.float32))
    mesh_median = float(d.median())
    bars.append((mesh_median <= cfg.fusion.voxel_size,
                 f"offline: mesh median {mesh_median} m from the scene"))

    # the pose graph's kept edges, card (Scanner3D's own solve) against host
    pairs_host = [{"pair": p, "T": res.transformation[k].cpu().double().numpy(),
                   "info": infos[k].cpu().double().numpy(),
                   "good": bool(res.is_good(cfg.registration.fitness_min,
                                            cfg.registration.rmse_max * 5)[k])}
                  for k, p in enumerate(sc.pairs)]
    graph_in, _ = chain_graph(pairs_host, N, "cpu", optimize=False)
    t0 = time.perf_counter()
    host_nodes, host_edges, host_weights = solve_graph(graph_in, "cpu")
    host_graph_s = time.perf_counter() - t0
    edges = {"card": len(sc.pose_graph.edges), "cpu": host_edges, "in": len(graph_in.edges)}
    node_vs_cpu = max(np.abs(a - b).max() for a, b in zip(sc.pose_graph.nodes, host_nodes))

    # the checkpoints on disk, replayed
    pngs = (len(glob.glob(os.path.join(out_dir.name, "color_*.png"))),
            len(glob.glob(os.path.join(out_dir.name, "depth_*.png"))))
    # the replay's raw depth is the writer's truncation of meters x depth_scale
    # (within one raw unit, 1 / depth_scale m, of the captured depth)
    scale = cfg.stream.depth_scale
    fake = FakeRGBDCamera(out_dir.name, depth_scale=scale)
    fake.open()
    replay = [fake.grab_raw() for _ in range(N)]
    raw_equal = all(np.array_equal(rd, np.clip(d0.astype(np.float64) * scale, 0, 65535)
                                   .astype(np.uint16)) for (_, rd), (_, d0) in zip(replay, sc.frames))
    depth_err = max(float(np.abs(rd / scale - d0).max()) for (_, rd), (_, d0) in zip(replay, sc.frames))
    colors_equal = all(np.array_equal(rc, c0) for (rc, _), (c0, _) in zip(replay, sc.frames))
    fake.open()
    first = fake.grab()
    grab_equal = np.array_equal(first[1], replay[0][1].astype(np.float32) / scale)
    bars.append((pngs == (N, N) and colors_equal and raw_equal and grab_equal
                 and fake.grab() is not None and len(fake) == N,
                 f"offline: PNG pairs {pngs}, colors equal {colors_equal}, raw depth equal "
                 f"{raw_equal}, grab {grab_equal}"))

    # integrate_saved_frames on the first frames against the same loop
    R = co["replay_resolution"]
    n_rep = co["replay_frames"]
    t0 = time.perf_counter()
    sf, rep_launches = counted(lambda: integrate_saved_frames(
        out_dir.name, intr, cfg, resolution=R, max_frames=n_rep, device=dev), {"fuse": n_rep})
    replay_s = time.perf_counter() - t0
    all_launches["offline_replay"] = rep_launches
    loop = StreamingFusion(None, intr, cfg, resolution=R, device=dev)
    for c, dep in io.load_rgbd_frames_batch(out_dir.name, cfg.stream.depth_scale, n_rep):
        loop._fuse_one(c, dep, cfg.fusion)
    replay_equal = all(torch.equal(getattr(sf.volume, k), getattr(loop.volume, k))
                       for k in ("tsdf", "weight", "color", "origin"))
    bars.append((replay_equal and sf.frames_integrated == n_rep,
                 "offline: integrate_saved_frames differs from its _fuse_one loop"))
    emit({"phase": "offline", "frame": [co["height"], co["width"]], "frames": N,
          "launches": all_launches["offline"], "replay_launches": rep_launches,
          "run_s": round(run_s, 3), "stages_ms": stages_ms, "peak_mem_bytes": peak,
          "pairs": [list(p) for p in sc.pairs],
          "fitness": [round(float(f), 6) for f in res.fitness.cpu()],
          "rmse": [round(float(r), 7) for r in res.inlier_rmse.cpu()],
          "good": [p["good"] for p in pairs_host], "batched_equal_pairs": same,
          "edges": edges, "cpu_edge_weights": host_weights, "node_vs_cpu_max": float(node_vs_cpu),
          "cpu_pose_graph_s": round(host_graph_s, 3),
          "vs_truth_center_normal_angle": vs_truth, "mesh_vs_truth_median_m": mesh_median,
          "mesh_vertices": len(mesh["points"]), "mesh_triangles": len(mesh["triangles"]),
          "pngs": list(pngs), "replay_depth_err_max_m": depth_err,
          "replay_frames": n_rep, "replay_resolution": R, "replay_s": round(replay_s, 3),
          "replay_equal": replay_equal, "phase_s": round(time.perf_counter() - t_phase, 3)})
    out_dir.cleanup()
    for ok, what in bars:
        check(ok, what)


def scanner_phase(dev, counted, all_launches):
    """The scanner phase: StreamingScanner(SyntheticRGBDCamera(640, 480, 10
    frames), ScannerConfig()) on the card: start(max_frames=10), join, stop,
    finalize (K7 + K8 in the normals); the accumulate step's host syncs;
    the Poisson indicator on the finalized oriented cloud twice on the card
    (bitwise) and on the host CPU; the mesh against the scene. The bars are
    checked after the phase's line."""
    import torch

    from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
    from recon3d_tpu_torch.config import MeshConfig, ScannerConfig
    from recon3d_tpu_torch.mesh import ops as mesh_ops
    from recon3d_tpu_torch.mesh import poisson
    from recon3d_tpu_torch.pipeline.scanner import StreamingScanner
    from recon3d_tpu_torch.utils.types import CameraIntrinsics, compact

    t_phase = time.perf_counter()
    cs = SCANNER
    N = cs["frames"]
    out_dir = tempfile.TemporaryDirectory()
    cfg = ScannerConfig(output_dir=out_dir.name)
    cam = SyntheticRGBDCamera(cs["width"], cs["height"], n_frames=N)
    intr = CameraIntrinsics(cam.fx, cam.fy, cam.cx, cam.cy)
    sc = StreamingScanner(cam, intr, cfg, device=dev)
    # the oriented cloud finalize meshes (its capacity decides K7 + K8)
    oriented = {}
    estimate = sc.normals.estimate_normals

    def keep(pc):
        oriented["pc"] = estimate(pc)
        return oriented["pc"]

    sc.normals.estimate_normals = keep

    def scan():
        sc.start(max_frames=N)
        sc._thread.join(timeout=cs["timeout_s"])
        sc.stop()
        return sc.finalize(output_prefix=os.path.join(out_dir.name, "scan"))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    (mesh, dens, paths), launches = counted(scan, {"K7": 1, "K8": 1})
    scan_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    all_launches["scanner"] = launches
    pc = oriented["pc"]
    t = sc.timer
    stages_ms = {k: round(v * 1e3 / max(t.counts[k], 1), 3) for k, v in t.totals.items()}
    rejected = sc.frames_rejected
    bars = [(sc.frames == N and int(sc.combined.count()) > 500 and len(paths) == 3
             and all(os.path.exists(p) for p in paths),
             f"scanner: frames {sc.frames}, combined {int(sc.combined.count())}, paths {paths}")]

    # the accumulate step's host syncs on one more frame
    cam.n_frames, cam._i = N + 1, N
    frame = cam.grab()
    nxt = sc.capture.capture_point_cloud(frame)
    nxt = compact(nxt, min(nxt.capacity, cfg.processing.capacity // 4))
    _, sync_by_line = sync_sites(lambda: sc._accumulate(sc.combined, nxt))

    # Poisson on the oriented cloud: twice on the card, once on the host
    R = 1 << MeshConfig().poisson_depth
    pts, _, _ = pc.to_numpy()
    origin, scale = poisson.grid_placement(pts, R, device=dev)

    def indicator(p):
        o, s = origin.to(p.points.device), scale.to(p.points.device)
        return poisson._poisson_indicator(p.points, p.normals, p.valid, R, o, s, 1.5)

    t0 = time.perf_counter()
    chi_a, dens_a = indicator(pc)
    torch.cuda.synchronize()
    indicator_ms = (time.perf_counter() - t0) * 1e3
    chi_b, dens_b = indicator(pc)
    host = dataclasses.replace(pc, points=pc.points.cpu(), valid=pc.valid.cpu(),
                               colors=None if pc.colors is None else pc.colors.cpu(),
                               normals=pc.normals.cpu())
    t0 = time.perf_counter()
    chi_h, dens_h = indicator(host)
    host_indicator_ms = (time.perf_counter() - t0) * 1e3
    chi_rerun_equal = torch.equal(chi_a, chi_b) and torch.equal(dens_a, dens_b)
    chi_max = float(chi_h.abs().max())
    chi_vs_cpu = float((chi_a.cpu() - chi_h).abs().max())
    dens_vs_cpu = float(((dens_a.cpu() - dens_h).abs()
                         - 1e-5 * dens_h.abs()).max() / float(dens_h.abs().max()))
    bars.append((chi_rerun_equal, "scanner: Poisson chi differs between two card runs"))
    bars.append((chi_vs_cpu <= 1e-5 * chi_max and dens_vs_cpu <= 1e-6,
                 f"scanner: Poisson chi {chi_vs_cpu} of {chi_max}, densities {dens_vs_cpu} "
                 f"against the host"))

    # the mesh against the scene, over the vertices above the density cull
    keep_v = mesh.vertex_valid & ~mesh_ops.density_mask(dens, MeshConfig().density_quantile)
    d = scene_distance(mesh.vertices[keep_v])
    mesh_median = float(d.median())
    bars.append((mesh_median < float(scale), f"scanner: mesh median {mesh_median} m from the "
                                             f"scene, a Poisson cell {float(scale)} m"))
    emit({"phase": "scanner", "frame": [cs["height"], cs["width"]], "frames": sc.frames,
          "launches": all_launches["scanner"], "scan_s": round(scan_s, 3),
          "frames_rejected": rejected, "combined_points": int(sc.combined.count()),
          "processed_points": int(pc.valid.sum()), "processed_capacity": pc.capacity,
          "stages_ms_per_call": stages_ms, "accumulate_calls": t.counts["accumulate"],
          "accumulate_host_syncs": sum(sync_by_line.values()),
          "accumulate_sync_sites": sync_by_line, "peak_mem_bytes": peak,
          "poisson_depth": MeshConfig().poisson_depth, "poisson_cell_m": float(scale),
          "indicator_ms": round(indicator_ms, 3), "host_indicator_ms": round(host_indicator_ms, 3),
          "chi_rerun_equal": chi_rerun_equal, "chi_vs_cpu_max": chi_vs_cpu, "chi_max": chi_max,
          "dens_vs_cpu_excess": dens_vs_cpu, "mesh_vertices": int(mesh.vertex_valid.sum()),
          "mesh_kept_vertices": int(keep_v.sum()), "mesh_vs_truth_median_m": mesh_median,
          "phase_s": round(time.perf_counter() - t_phase, 3)})
    out_dir.cleanup()
    for ok, what in bars:
        check(ok, what)
    return pc


def cli_phase(dev, counted, all_launches):
    """The cli phase: recon3d_tpu_torch.cli.main in this process, on the
    card: depth at the CLI's defaults (960x540, 3 frames) on an NPZ of
    pipeline_rig() scaled to them (K1 x 2, K2, K3, K4, K6 x 6 a frame; the
    first frame's PNG bitwise DepthPipeline.from_npz(...).process on the
    same pair and rig), fuse at ScannerConfig() (the fuse kernel a frame) with
    --checkpoint, then --resume for more frames, scan (K7 1 and K8 1) and
    offline (the fuse kernel a frame) on a few synthetic frames, inspect and doctor.
    Each command's seconds; every PLY it prints loads."""
    import contextlib
    import io as _io

    import numpy as np
    import torch

    from recon3d_tpu_torch import cli
    from recon3d_tpu_torch.camera.fake import FakeStereoCamera
    from recon3d_tpu_torch.depth.pipeline import DepthPipeline
    from recon3d_tpu_torch.utils import io, native

    t_phase = time.perf_counter()
    cc = CLI
    out_dir = tempfile.TemporaryDirectory()
    root = out_dir.name
    device = ["--device", str(dev)]
    secs, printed = {}, {}

    def run(tag, argv, expected):
        buf = _io.StringIO()

        def call():
            with contextlib.redirect_stdout(buf):
                return cli.main(argv)

        t0 = time.perf_counter()
        rc, launches = counted(call, expected)
        secs[tag] = round(time.perf_counter() - t0, 3)
        printed[tag] = buf.getvalue().strip().splitlines()[-1:]
        check(rc == 0, f"cli {tag}: exit {rc}: {buf.getvalue()[-400:]}")
        all_launches[f"cli_{tag}"] = launches
        return buf.getvalue()

    # depth: the CLI's defaults on a rig scaled to them
    w, h = cc["depth_size"]
    npz = os.path.join(root, "rig.npz")
    pipeline_rig(scale=w / W).save(npz)
    nd = cc["depth_frames"]
    frame_k = {"K1": 2, "K2": 1, "K3": 1, "K4": 1, "K6": 6}
    run("depth", ["depth", "--npz", npz, "--width", str(w), "--height", str(h), "--frames",
                  str(nd), "--out", os.path.join(root, "depth")] + device,
        {k: n * nd for k, n in frame_k.items()})
    pngs = sorted(glob.glob(os.path.join(root, "depth", "disp_*.png")))
    pipe = DepthPipeline.from_npz(npz, (w, h), device=dev)
    check(pipe.plans is not None, "cli: the scaled rig's maps are not row-monotonic")
    cam = FakeStereoCamera(width=w, height=h, focal=float(np.asarray(pipe.params.P1)[0, 0]),
                           baseline=abs(pipe.params.baseline) or 0.06, n_frames=1)
    cam.open()
    disp, _, vis = pipe.process(*cam.grab())
    first = native.png_read(pngs[0])
    want = np.asarray((vis * 255).cpu().numpy(), np.uint8)
    depth_valid = float((disp > 0).float().mean())
    bars = [(len(pngs) == nd and first.shape == (h, w, 3), f"cli depth: {len(pngs)} PNGs"),
            (np.array_equal(first, want), "cli depth: frame 0 differs from the pipeline's"),
            (bool(torch.isfinite(disp).all()) and depth_valid > 0.5,
             f"cli depth: valid share {depth_valid}")]

    # fuse with a checkpoint, then resumed
    ck = os.path.join(root, "fuse.npz")
    nf, nr = cc["fuse_frames"], cc["resume_frames"]
    run("fuse", ["fuse", "--camera", "synthetic", "--frames", str(nf), "--checkpoint", ck,
                 "--output_dir", os.path.join(root, "fuse")] + device, {"fuse": nf})
    text = run("resume", ["fuse", "--camera", "synthetic", "--frames", str(nr), "--resume", ck,
                          "--output_dir", os.path.join(root, "resume")] + device,
               {"fuse": nr})
    bars.append((f"resumed at frame {nf}" in text, f"cli resume: {text[-300:]}"))
    meshes = {}
    for tag in ("fuse", "resume"):
        d = io.read_ply(os.path.join(root, tag, "fused_mesh.ply"))
        meshes[tag] = (len(d["points"]), len(d["triangles"]))
        bars.append((len(d["triangles"]) > 1000 and np.isfinite(d["points"]).all(),
                     f"cli {tag}: mesh {meshes[tag]}"))

    # scan and offline at ScannerConfig() on a few synthetic frames
    run("scan", ["scan", "--camera", "synthetic", "--frames", str(cc["scan_frames"]),
                 "--output_dir", os.path.join(root, "scan")] + device,
        {"K7": 1, "K8": 1})
    scan_plys = sorted(glob.glob(os.path.join(root, "scan", "*.ply")))
    no = cc["offline_frames"]
    text = run("offline", ["offline", "--camera", "synthetic", "--frames", str(no),
                           "--output_dir", os.path.join(root, "offline")] + device,
               {"fuse": no})
    plys = {os.path.basename(p): io.read_ply(p) for p in scan_plys}
    plys["offline"] = io.read_ply(text.split("-> ")[-1].strip())
    bars.append((len(scan_plys) == 3, f"cli scan: wrote {scan_plys}"))
    for name, d in plys.items():
        bars.append((len(d["points"]) > 500 and np.isfinite(d["points"]).all(),
                     f"cli: {name} holds {len(d['points'])} points"))

    # inspect and doctor
    text = run("inspect", ["inspect", "--npz", npz], {})
    bars.append(("Baseline" in text, "cli inspect: no baseline line"))
    text = run("doctor", ["doctor"] + device, {})
    bars.append(("[ok  ] torch device" in text and "[ok  ] kernel library" in text,
                 f"cli doctor: {text}"))
    emit({"phase": "cli", "seconds": secs, "printed": printed,
          "launches": {k: all_launches[f"cli_{k}"] for k in secs},
          "depth_size": [h, w], "depth_valid_share": round(depth_valid, 5),
          "fused_mesh": meshes, "ply_points": {k: len(d["points"]) for k, d in plys.items()},
          "bars_failed": [what for ok, what in bars if not ok],
          "phase_s": round(time.perf_counter() - t_phase, 3)})
    out_dir.cleanup()
    for ok, what in bars:
        check(ok, what)


def parallel_fusion_phase(dev, counted, all_launches, fframes, fintr):
    """The parallel_fusion phase: parallel/fusion.py over an in-process mesh
    of 4 frame shards on the card, 4 of the fusion phase's 640x480 frames
    into FusionConfig()'s 256^3 volume. integrate_frames_exact (the fuse
    kernel twice a frame: the weight pass and the affine pass) against 4
    sequential integrate calls (weights exact, tsdf and color within 1e-5)
    and bitwise against the same call on the plain path; fused_frames_sharded
    of frames 1-4 against frame 0 (the fuse kernel twice a frame; odometry a
    frame) against
    the same chain run frame by frame (poses equal, weights exact, tsdf
    within 1e-5) and its poses against the truth (frames 1-3 within 1 cm,
    as the streaming phase's; frame 4 is printed: 4 steps from the one
    keyframe, odometry may converge elsewhere and still report success)."""
    import numpy as np
    import torch

    from recon3d_tpu_torch.config import FusionConfig
    from recon3d_tpu_torch.fusion import tsdf
    from recon3d_tpu_torch.parallel import fusion as pfusion
    from recon3d_tpu_torch.parallel.mesh import make_mesh
    from recon3d_tpu_torch.registration.odometry import compute_rgbd_odometry
    from recon3d_tpu_torch.utils.types import RGBDImage

    t_phase = time.perf_counter()
    pf = PARALLEL_FUSION
    B, fc = pf["frames"], FusionConfig()
    mesh = make_mesh(pf["shards"], ("frame",), device=dev)
    colors = torch.stack([c for c, _, _ in fframes[:B + 1]])
    depths = torch.stack([d for _, d, _ in fframes[:B + 1]])
    exts = torch.stack([p for _, _, p in fframes[:B]])

    def new_volume(color=True):
        return tsdf.make_volume(fc.grid_resolution, fc.voxel_size, fc.sdf_trunc,
                                origin=FUSION["origin"], with_color=color, device=dev)

    def exact():
        return pfusion.integrate_frames_exact(vol0, depths[:B], exts, fintr, mesh,
                                              colors=colors[:B], depth_trunc=fc.depth_trunc)

    vol0 = new_volume()
    exact()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    live = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out, launches = counted(exact, {"fuse": 2 * B})
    exact_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    all_launches["parallel_fusion"] = launches
    bars = [(not bool(vol0.weight.any()), "parallel_fusion: the caller's volume changed")]
    seq = new_volume()
    t0 = time.perf_counter()
    for b in range(B):
        seq = tsdf.integrate(seq, depths[b], fintr, exts[b], color=colors[b],
                             depth_trunc=fc.depth_trunc)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    err = {k: float((getattr(out, k) - getattr(seq, k)).abs().max())
           for k in ("tsdf", "color")}
    bars.append((torch.equal(out.weight, seq.weight) and max(err.values()) <= 1e-5,
                 f"parallel_fusion: against 4 integrates {err}"))
    with plain_fusion():
        plain, _ = counted(exact, {"K9": 2 * B})
    bars.append((all(torch.equal(getattr(out, k), getattr(plain, k))
                     for k in ("tsdf", "weight", "color")),
                 "parallel_fusion: differs from the plain-path call"))
    del plain, seq, out

    # fused_frames_sharded: frames 1..B tracked against frame 0
    def fused():
        return pfusion.fused_frames_sharded(new_volume(False), colors[0], depths[0], colors[1:],
                                            depths[1:], fintr, mesh,
                                            depth_trunc=fc.depth_trunc)

    t0 = time.perf_counter()
    (fvol, wfc, ok), launches = counted(fused, {"fuse": 2 * B})
    fused_ms = (time.perf_counter() - t0) * 1e3
    all_launches["parallel_fused"] = launches
    key = RGBDImage(color=colors[0], depth=depths[0])
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    chain = new_volume(False)
    poses_equal, drift = True, []
    for b in range(B):
        res = compute_rgbd_odometry(key, RGBDImage(color=colors[b + 1], depth=depths[b + 1]),
                                    fintr)
        w = torch.linalg.inv(torch.where(res.success, res.transformation, eye))
        poses_equal = poses_equal and torch.equal(w, wfc[b])
        chain = tsdf.integrate(chain, depths[b + 1], fintr, torch.linalg.inv(w),
                               depth_trunc=fc.depth_trunc)
        # the extrinsics are camera_from_world = true_pose(k): frame k's
        # pose in frame 0's is true_pose(0) inv(true_pose(k))
        truth = fframes[0][2] @ torch.linalg.inv(fframes[b + 1][2])
        drift.append(float((w[:3, 3] - truth[:3, 3]).norm()))
    f_err = float((fvol.tsdf - chain.tsdf).abs().max())
    bars += [(bool(ok.all()) and poses_equal, "parallel_fusion: fused poses differ"),
             (torch.equal(fvol.weight, chain.weight) and f_err <= 1e-5,
              f"parallel_fusion: fused volume against the chain {f_err}"),
             (max(drift[:3]) < 0.01, f"parallel_fusion: frames 1-3 drift {drift[:3]}")]
    emit({"phase": "parallel_fusion", "frames": B, "shards": mesh.n,
          "resolution": fc.grid_resolution, "frame": [FUSION["height"], FUSION["width"]],
          "launches": {"integrate_frames_exact": all_launches["parallel_fusion"],
                       "fused_frames_sharded": all_launches["parallel_fused"]},
          "exact_ms": round(exact_ms, 3), "sequential_ms": round(seq_ms, 3),
          "fused_ms": round(fused_ms, 3), "peak_mem_bytes": peak,
          "mem_live_before_bytes": live, "exact_extra_peak_bytes": peak - live,
          "volume_bytes": sum(t.numel() * t.element_size()
                              for t in (vol0.tsdf, vol0.weight, vol0.color)),
          "vs_sequential_max": err, "fused_vs_chain_tsdf_max": f_err,
          "fused_drift_m": [round(d, 6) for d in drift], "plain_path_equal": True,
          "bars_failed": [what for ok_, what in bars if not ok_],
          "phase_s": round(time.perf_counter() - t_phase, 3)})
    del fvol, chain
    for ok_, what in bars:
        check(ok_, what)


def scalable_phase(dev, counted, all_launches, fframes, fintr):
    """The scalable phase: fusion/scalable.py at make_scalable_volume()'s
    defaults on the card (voxel 0.004, 8^3 bricks, 4096-brick pool, 16384
    slots, color) fed the fusion phase's 30 frames, maybe_grow after each:
    ms a frame, bricks, grows, drops, the host syncs of one more frame by
    line; extract_triangle_mesh (256^3 windows)
    against the scene; a run saved at frame 15, loaded and continued,
    bitwise the uninterrupted run; the first 2 frames on the host CPU
    against the card's (keys, table and counters equal; tsdf, weight and
    color within 1e-6). No kernel runs on this path."""
    import numpy as np
    import torch

    from recon3d_tpu_torch.fusion import scalable

    t_phase = time.perf_counter()
    cs = SCALABLE
    fields = ("brick_keys", "table", "n_alloc", "n_dropped", "tsdf", "weight", "color")
    log = {"frame_ms": [], "bricks": [], "dropped": [], "capacity": []}

    def run(vol, frames, device=None, record=None):
        for c, d, pose in frames:
            if device is not None:
                c, d, pose = c.to(device), d.to(device), pose.to(device)
            t0 = time.perf_counter()
            vol = scalable.integrate(vol, d, fintr, pose, color=c)
            if record is not None:
                torch.cuda.synchronize()
                record["frame_ms"].append((time.perf_counter() - t0) * 1e3)
                record["bricks"].append(int(vol.n_alloc))
                record["dropped"].append(int(vol.n_dropped))
            vol = scalable.maybe_grow(vol)
            if record is not None:
                record["capacity"].append(vol.capacity)
        return vol

    N = len(fframes)
    first = run(scalable.make_scalable_volume(device=dev), fframes[:cs["host_frames"]])
    vol, launches = counted(lambda: run(scalable.make_scalable_volume(device=dev), fframes,
                                        record=log), {})
    all_launches["scalable"] = launches
    grows = sum(b > a for a, b in zip([4096] + log["capacity"], log["capacity"]))
    # the host syncs of one more frame (integrate + maybe_grow), by line
    c, d, pose = fframes[-1]
    _, frame_syncs = sync_sites(lambda: scalable.maybe_grow(
        scalable.integrate(vol, d, fintr, pose, color=c)))

    # save at frame 15, load, continue: bitwise the uninterrupted run
    half = cs["save_at"]
    part = run(scalable.make_scalable_volume(device=dev), fframes[:half])
    ckpt_dir = tempfile.TemporaryDirectory()
    path = scalable.save_scalable_volume(os.path.join(ckpt_dir.name, "scalable.npz"), part)
    resumed = run(scalable.load_scalable_volume(path, device=dev), fframes[half:])
    resumed_equal = all(torch.equal(getattr(vol, f), getattr(resumed, f)) for f in fields)
    ckpt_bytes = os.path.getsize(path)
    ckpt_dir.cleanup()
    del part, resumed

    # the mesh of the occupied windows against the scene
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh = scalable.extract_triangle_mesh(vol, window=cs["window"])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    verts = mesh.vertices[mesh.vertex_valid]
    mesh_median = float(scene_distance(verts).median())
    windows = len(scalable.occupied_window_origins(vol, cs["window"]))

    # the host CPU on the first frames
    t0 = time.perf_counter()
    host = run(scalable.make_scalable_volume(device="cpu"), fframes[:cs["host_frames"]],
               device="cpu")
    host_s = time.perf_counter() - t0
    same = {f: torch.equal(getattr(first, f).cpu(), getattr(host, f)) for f in fields[:4]}
    host_err = {f: float((getattr(first, f).cpu() - getattr(host, f)).abs().max())
                for f in fields[4:]}
    bars = [(resumed_equal, "scalable: save / load / continue differs from one run"),
            (all(same.values()) and max(host_err.values()) <= 1e-6,
             f"scalable: card against host {same} {host_err}"),
            (int(vol.n_dropped) == 0 and log["bricks"][-1] > 1000,
             f"scalable: bricks {log['bricks'][-1]}, dropped {int(vol.n_dropped)}"),
            (int(mesh.triangle_valid.sum()) > 10000 and mesh_median < 0.004,
             f"scalable: mesh median {mesh_median} m from the scene")]
    emit({"phase": "scalable", "frames": N, "frame": [FUSION["height"], FUSION["width"]],
          "launches": launches, "voxel_size": float(vol.voxel_size), "brick_size": vol.brick_size,
          "frame_ms_median": round(statistics.median(log["frame_ms"]), 3),
          "frame_ms": [round(t, 3) for t in log["frame_ms"]], "bricks": log["bricks"][-1],
          "bricks_per_frame": log["bricks"], "dropped_per_frame": log["dropped"],
          "capacity_final": vol.capacity, "table_final": int(vol.table.shape[0]),
          "grows": grows, "frame_sync_sites": frame_syncs,
          "frame_host_syncs": sum(frame_syncs.values()), "resumed_equal": resumed_equal, "checkpoint_bytes": ckpt_bytes,
          "extract_s": round(extract_s, 3), "windows": windows,
          "mesh_triangles": int(mesh.triangle_valid.sum()), "mesh_vs_truth_median_m": mesh_median,
          "host_frames": cs["host_frames"], "host_s": round(host_s, 3), "host_equal": same,
          "host_max_abs_err": host_err,
          "bars_failed": [what for ok, what in bars if not ok],
          "phase_s": round(time.perf_counter() - t_phase, 3)})
    del vol, mesh, first, host
    for ok, what in bars:
        check(ok, what)


def viewers_phase(dev, counted, all_launches, cloud, fr):
    """The viewers phase: render_points of the scanner phase's processed
    cloud at 960x720 (no kernel) timed and bitwise its host render;
    LiveDepthViewer with a sink on DepthPipeline(pipeline_rig()) at
    1920x1080 over 3 frames of the bench's raw pair (K1 x 2, K2, K3, K4,
    K6 x 6 a frame; the sunk frame bitwise the pipeline's own);
    live_remesh_loop over a 2-frame StreamingScanner at ScannerConfig()'s
    defaults with 2 remeshes (K7 1 and K8 1 each), the camera held before
    frame 2 until the first remesh is shown; each remesh's normals (K7 +
    K8 on the loop's accumulated cloud) bitwise their plain versions on the
    same cloud."""
    import threading

    import numpy as np
    import torch

    from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
    from recon3d_tpu_torch.config import ScannerConfig
    from recon3d_tpu_torch.depth import DepthPipeline
    from recon3d_tpu_torch.pipeline import live, render, visualizer
    from recon3d_tpu_torch.pipeline.scanner import StreamingScanner
    from recon3d_tpu_torch.pointcloud import normals
    from recon3d_tpu_torch.utils.types import CameraIntrinsics

    t_phase = time.perf_counter()
    cv = VIEWERS
    rh, rw = cv["render_size"]
    pts = cloud.points
    cols = cloud.colors if cloud.colors is not None else torch.full_like(pts, 0.75)
    host_pts = pts[cloud.valid].cpu().numpy()
    view = torch.as_tensor(render.orbit_view(host_pts.mean(0), 1.6 * float(
        np.linalg.norm(host_pts.max(0) - host_pts.min(0))), 20.0, -20.0), device=dev)

    def draw():
        return render.render_points(pts, cols, cloud.valid, view, 0.9 * rw, height=rh, width=rw)

    img, launches = counted(draw, {})
    render_ms = cuda_ms(draw, KERNEL_RUNS)
    host_img = render.render_points(pts.cpu(), cols.cpu(), cloud.valid.cpu(), view.cpu(),
                                    0.9 * rw, height=rh, width=rw)
    lit = float((img != np.float32(0.08)).any(-1).float().mean())
    bars = [(torch.equal(img.cpu(), host_img), "viewers: render differs from the host's"),
            (lit > 0.01, f"viewers: {lit} of the image lit")]

    # LiveDepthViewer: the depth pipeline's frames into a sink
    class Replay:
        def __init__(self, img):
            self.img = img

        def read(self):
            return True, (self.img,)

    pipe = DepthPipeline(pipeline_rig(), (W, H), fr["m"], fr["w"], device=dev)
    sunk = []
    viewer = live.LiveDepthViewer(pipe, sink=lambda name, im: sunk.append((name, im)))
    nf = cv["depth_frames"]
    frame_k = {"K1": 2, "K2": 1, "K3": 1, "K4": 1, "K6": 6}
    t0 = time.perf_counter()
    n, launches = counted(lambda: viewer.run(Replay(fr["raw_l"]), Replay(fr["raw_r"]),
                                             max_frames=nf),
                          {k: v * nf for k, v in frame_k.items()})
    viewer_ms = (time.perf_counter() - t0) * 1e3 / nf
    all_launches["viewers_depth"] = launches
    vis = live.host_image(pipe.process(fr["raw_l"], fr["raw_r"])[2])
    want = np.clip(vis * (255.0 if vis.max() <= 1.0 else 1.0), 0, 255).astype(np.uint8)
    bars.append((n == nf and len(sunk) == nf and all(nm == "disparity" for nm, _ in sunk)
                 and np.array_equal(sunk[0][1], want),
                 f"viewers: LiveDepthViewer showed {len(sunk)} frames, not the pipeline's"))
    del pipe, sunk

    # live_remesh_loop: 2 frames, a remesh after each
    out_dir = tempfile.TemporaryDirectory()
    cam = SyntheticRGBDCamera(cv["scan_width"], cv["scan_height"], n_frames=2)
    intr = CameraIntrinsics(cam.fx, cam.fy, cam.cx, cam.cy)
    sc = StreamingScanner(cam, intr, ScannerConfig(output_dir=out_dir.name), device=dev)
    shown = threading.Event()
    grab = cam.grab

    def gated_grab():
        if cam._i == 1:  # frame 2 waits for the first remesh
            shown.wait(cv["timeout_s"])
        return grab()

    cam.grab = gated_grab
    vis3d = visualizer.LiveVisualizer3D(width=rw, height=rh, offscreen=True)
    update = vis3d.update
    remesh_t = []

    def show(mesh):
        remesh_t.append(time.perf_counter())
        ok = update(mesh)
        shown.set()
        return ok

    vis3d.update = show
    # each remesh's K7 + K8 normals, kept with their inputs (the loop's
    # accumulated cloud) to hold against the plain versions afterwards
    grid_normals, remeshed = normals._grid_normals, []

    def recorded(points, valid, radius, G, C):
        out = grid_normals(points, valid, radius, G, C)
        remeshed.append((points.clone(), valid.clone(), radius, G, C, out))
        return out

    normals._grid_normals = recorded
    t0 = time.perf_counter()
    try:
        meshes, launches = counted(lambda: visualizer.live_remesh_loop(sc, vis3d, frames=2),
                                   {"K7": 2, "K8": 2})
    finally:
        normals._grid_normals = grid_normals
    loop_s = time.perf_counter() - t0
    all_launches["live_remesh"] = launches
    tris = [int(m.triangle_valid.sum()) for m in meshes]
    bars.append((len(meshes) == 2 and min(tris) > 1000 and vis3d.frame is not None
                 and vis3d.frame.max() > 0, f"viewers: live_remesh_loop meshes {tris}"))
    remesh_points = [[int(r[1].sum()), r[0].shape[0]] for r in remeshed]  # valid, capacity
    plain_equal = [torch.equal(out, plain_grid_normals(p, v, radius, G, C)[0])
                   for p, v, radius, G, C, out in remeshed]
    bars.append((len(remeshed) == 2 and all(plain_equal),
                 f"viewers: the remeshes' K7 + K8 normals against the plain versions "
                 f"{plain_equal} on {remesh_points} points"))
    del remeshed
    out_dir.cleanup()
    emit({"phase": "viewers", "render_size": [rh, rw], "render_points": int(cloud.valid.sum()),
          "render_ms": round(render_ms, 4), "render_lit_share": round(lit, 5),
          "render_host_equal": True, "depth_viewer_frames": nf,
          "depth_viewer_ms_per_frame": round(viewer_ms, 3),
          "launches": {"depth_viewer": all_launches["viewers_depth"],
                       "live_remesh_loop": all_launches["live_remesh"]},
          "remeshes": len(meshes), "remesh_triangles": tris, "live_remesh_s": round(loop_s, 3),
          "remesh_points": remesh_points, "remesh_k7_k8_plain_equal": plain_equal,
          "bars_failed": [what for ok, what in bars if not ok],
          "phase_s": round(time.perf_counter() - t_phase, 3)})
    for ok, what in bars:
        check(ok, what)


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
    from recon3d_tpu_torch.ops import project_sample, project_sample_cuda, tsdf_fuse_cuda
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
    wrappers = {"K1": warp.remap_two_pass_cuda, "K1 pass": warp.resample_pass,
                "K2": sgm_cuda.cost_fwd_down,
                "K3": sgm_cuda.bwd_accumulate, "K4": sgm_cuda.vfinalize,
                "K5": sgm_cuda.diag_accumulate, "K6": wls_cuda.tridiag_solve,
                "K14 fwd": sgm_cuda.fwd_scan, "K14 down": sgm_cuda.down_accumulate,
                "K7": grid_knn_cuda.pack_cells, "K8": grid_knn_cuda.core_call,
                "K9": project_sample_cuda.sample_images_cuda,
                "fuse": tsdf_fuse_cuda.fuse_voxels_cuda,
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
        headline, {"K1": 2, "K2": 1, "K3": 1, "K4": 1, "K6": 6})
    stats = frame_stats(*timed_frames(headline), "headline")
    # the frame's device busy share and kernel time by name, a frame
    prof, dev_us = device_profile(lambda: [headline() for _ in range(PROFILE_FRAMES)], top=16,
                                  calls=PROFILE_FRAMES)
    # K1's device ms a launch, alone: the profiler's kernel time (2 a frame)
    k1_profiled_ms = round(sum(t for n, t in dev_us.items() if "remap_two_pass_kernel" in n)
                           / 1e3 / (2 * PROFILE_FRAMES), 4) if prof else None
    emit({"phase": "headline_profile", "frames": PROFILE_FRAMES, "per_frame": prof,
          "finalize_ms": finalize_ms(dev_us, PROFILE_FRAMES), "k1_ms": k1_profiled_ms})
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
    # the one-pass entry as its callers use it: the vertical pass, then the
    # horizontal one with the mask, equal to the fused remap
    def one_pass():
        t = warp.resample_pass(raw_l, plan.vy, plan.v_coarse, plan.v_coarse_bits,
                               plan.v_resid_bound, 0)
        return warp.resample_pass(t, plan.hx, plan.h_coarse, plan.h_coarse_bits,
                                  plan.h_resid_bound, 1, plan.valid)

    lg_1, launches = counted(one_pass, {"K1 pass": 2})
    check(torch.equal(lg_1, lg), "one_pass: the two passes differ from the fused remap")
    all_launches["one_pass"] = launches
    del lg_1
    del lg_p, rg_p, u, vp, d_sgm, v_sgm, disp, valid, pc

    # ---- pipeline: DepthPipeline.process on an in-memory rig
    t0 = time.perf_counter()
    pipe = DepthPipeline(pipeline_rig(), (W, H), m, w, device=dev)
    init_s = time.perf_counter() - t0
    check(pipe.plans is not None, "pipeline: the rig's maps are not row-monotonic")
    (p_disp, p_depth, p_vis), launches = counted(
        lambda: pipe.process(raw_l, raw_r), {"K1": 2, "K2": 1, "K3": 1, "K4": 1, "K6": 6})
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
    vol_k, launches = counted(lambda: fuse(frame_ev), {"fuse": cf["frames"]})
    fuse_ms = (time.perf_counter() - t0) * 1e3
    fuse_peak = torch.cuda.max_memory_allocated(dev)
    all_launches["fusion"] = launches
    frame_ms = [a.elapsed_time(b) for a, b in frame_ev]
    # where a frame's time goes: a profiler trace of the last frame's integrate
    c_t, d_t, pose = fframes[-1]
    prof_frame, dev_us = device_profile(lambda: tsdf.integrate(
        vol_k, d_t, fintr, pose, color=c_t, depth_trunc=fcfg.depth_trunc))
    if prof_frame is not None:
        prof_frame["fuse_ms"] = round(sum(t for k, t in dev_us.items()
                                          if "tsdf_fuse" in k) / 1e3, 4)
    # the same 30 frames on the plain path (PyTorch's projection and update, K9)
    with plain_fusion():
        vol_q, launches = counted(fuse, {"K9": cf["frames"]})
    all_launches["fusion_plain"] = launches
    for name in ("tsdf", "weight", "color"):
        check(torch.equal(getattr(vol_k, name), getattr(vol_q, name)),
              f"fusion: {name} differs from the plain path's volume")
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
          "profiled_frame": prof_frame, "plain_path_equal": True,
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
    mesh_q, _ = mesh_chain(vol_q)  # the plain path's volume's mesh
    for f in dataclasses.fields(mesh_k):
        a, b = getattr(mesh_k, f.name), getattr(mesh_q, f.name)
        check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
              f"mesh: {f.name} differs from the plain path's volume's mesh")
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
          "ms_runs": [[round(t, 3) for t in r] for r in mesh_ms], "plain_path_equal": True,
          "profiled_extract": prof_extract, "profiled_chain": prof_chain,
          "vs_truth": scene_truth(verts_m)})
    ply_dir.cleanup()
    del mesh_q, verts_m, vol_q

    registration_phases(dev, counted, timed_frames, all_launches)
    streaming_phase(dev, counted, all_launches)
    calibration_phase(dev, counted, timed_frames, all_launches,
                      dict(raw_l=raw_l, raw_r=raw_r, gl=gl, gr=gr, dt=dt, m=m, w=w,
                           against=against, frame_stats=frame_stats))
    offline_phase(dev, counted, all_launches)
    scan_cloud = scanner_phase(dev, counted, all_launches)
    cli_phase(dev, counted, all_launches)
    parallel_fusion_phase(dev, counted, all_launches, fframes[:PARALLEL_FUSION["frames"] + 1],
                          fintr)
    scalable_phase(dev, counted, all_launches, fframes, fintr)
    viewers_phase(dev, counted, all_launches, scan_cloud, dict(raw_l=raw_l, raw_r=raw_r, m=m, w=w))
    del scan_cloud

    # ---- kernels against their plain versions, on their paths' inputs
    rows = []
    n_el = HP * WP * DP

    # the paths of the cli, parallel_fusion, viewers phases: each kernel's
    # launches there, on every row of the kernel
    later_paths = ("cli_depth", "cli_fuse", "cli_resume", "cli_scan", "cli_offline",
                   "parallel_fusion", "parallel_fused", "viewers_depth", "live_remesh")

    def row(name, source, replaces, launches, err, times, plain_ms, bound, library_ms=None,
            **extra):
        """A kernel row; `times` from kernel_times (its ms is held to the bound)."""
        key = "K1 pass" if name.startswith("K1 resample_pass") else name.split()[0]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches, max_abs_err=err, ms=round(times["ms"], 4),
                         plain_ms=round(plain_ms, 4), bound_ms=round(bound[0], 4),
                         bound_by=bound[1], ops_ceiling=bound[2],
                         library_ms=None if library_ms is None else round(library_ms, 4),
                         **{k: round(v, 4) for k, v in times.items() if k != "ms"},
                         path_launches={p: all_launches[p][key] for p in later_paths
                                        if key in all_launches.get(p, {})}, **extra))

    slice_n = all_launches["slice"]

    # K1 on the headline's raw left image: the fused remap (both passes, one
    # launch; two a frame) and, one row a pass, its one-pass form (the
    # one_pass path). The yardstick is one grid_sample over the same maps:
    # the single-pass bilinear remap, a different function from the
    # two-pass one (on this card gathers are cheap).
    grid = torch.stack([torch.tensor(mx, device=dev) * (2.0 / (W - 1)) - 1.0,
                        torch.tensor(my, device=dev) * (2.0 / (H - 1)) - 1.0], -1)[None]
    grid_ms = run_ms(lambda: torch.nn.functional.grid_sample(
        raw_l[None, None], grid, mode="bilinear", padding_mode="zeros", align_corners=True),
        KERNEL_RUNS)
    library = ("torch.nn.functional.grid_sample, bilinear, zeros, align_corners: the "
               "single-pass remap of the whole frame, not the same function")
    out_k = warp.remap_two_pass_cuda(raw_l, plan)
    out_q = warp.remap_two_pass(raw_l, plan)
    check(torch.equal(out_k, out_q), "K1 differs from its plain version")
    nbytes = 4 * H * W * 4 + H * W + (H + W) * 4
    row("K1 remap_two_pass", "recon3d_tpu_torch/csrc/warp_resample.cu",
        "recon3d_tpu/ops/warp.py:266, recon3d_tpu/ops/warp.py:276",
        all_launches["headline"]["K1"], float((out_k - out_q).abs().max()),
        kernel_times(lambda: warp.remap_two_pass_cuda(raw_l, plan), nbytes, KERNEL_RUNS),
        plain_ms(lambda: warp.remap_two_pass(raw_l, plan)),
        bound_ms(nbytes, 28 * H * W), grid_ms, library=library,
        profiled_ms=k1_profiled_ms)
    t_k = warp.resample_pass(raw_l, plan.vy, plan.v_coarse, plan.v_coarse_bits,
                             plan.v_resid_bound, 0)
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
            all_launches["one_pass"]["K1 pass"] // 2, float((out_k - out_q).abs().max()),
            kernel_times(lambda: warp.resample_pass(*args), nbytes, KERNEL_RUNS),
            plain_ms(lambda: warp.resample_pass_plain(*args)),
            bound_ms(nbytes, 14 * H * W), grid_ms, library=library)
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
        stage_ms["walk" + key] = run_ms(lambda: walk(down, v1_s), KERNEL_RUNS)
        stage_ms["fwd" + key] = run_ms(lambda v: fwd(down, v), KERNEL_RUNS,
                                       lambda: (v1_s.clone(),))
    walk(True, v1_s)
    fwd(True, v1_s)
    check(torch.equal(cost_s, cost_k) and torch.equal(v1_s, v1_k),
          "K2's stages run apart differ from the whole call")
    del cost_s, v1_s
    k2_no_down = lambda: sgm_cuda.cost_fwd_down(  # noqa: E731
        gl, gr, D, 0, m.block_size, m.pre_filter_cap, p1, p2, HP, WP, DP, False, planes=planes)
    nbytes = 6 * H * W * 4 + cost_b + v1_b
    row("K2 cost_fwd_down", "recon3d_tpu_torch/csrc/sgm_cost.cu",
        "recon3d_tpu/depth/sgm_pallas.py:985", slice_n["K2"], err,
        kernel_times(k2, nbytes, KERNEL_RUNS), plain_ms(k2p),
        bound_ms(nbytes, 30 * n_el), ms_without_down=round(run_ms(k2_no_down, KERNEL_RUNS), 4),
        stages_ms={k: round(v, 4) for k, v in stage_ms.items()})

    # K14: the standalone forward scan and the downward scan, on K2's cost
    std_n = all_launches["standalone"]
    v_k = sgm_cuda.fwd_scan(cost_k, p1, p2)
    v_q = sgm_cuda.fwd_scan_plain(cost_k, p1, p2)
    check(torch.equal(v_k, v_q), "K14 forward scan differs from its plain version")
    row("K14 fwd_scan", "recon3d_tpu_torch/csrc/sgm_scan.cu",
        "recon3d_tpu/depth/sgm_pallas.py:1067", std_n["K14 fwd"],
        float((v_k - v_q).abs().max()),
        kernel_times(lambda: sgm_cuda.fwd_scan(cost_k, p1, p2), cost_b + v1_b, KERNEL_RUNS),
        plain_ms(lambda: sgm_cuda.fwd_scan_plain(cost_k, p1, p2)),
        bound_ms(cost_b + v1_b, 8 * n_el))
    d_k = sgm_cuda.down_accumulate(cost_k, v_k.clone(), p1, p2)
    d_q = sgm_cuda.down_accumulate_plain(cost_k, v_k.clone(), p1, p2)
    check(torch.equal(d_k, d_q), "K14 downward scan differs from its plain version")
    check(torch.equal(d_k, v1_k), "K14 fwd + down differ from K2's v1")
    row("K14 down_accumulate", "recon3d_tpu_torch/csrc/sgm_scan.cu",
        "recon3d_tpu/depth/sgm_pallas.py:1077", std_n["K14 down"],
        float((d_k - d_q).abs().max()),
        kernel_times(lambda v: sgm_cuda.down_accumulate(cost_k, v, p1, p2),
                     cost_b + 2 * v1_b, KERNEL_RUNS, lambda: (v_k.clone(),)),
        plain_ms(lambda v: sgm_cuda.down_accumulate_plain(cost_k, v, p1, p2),
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
        kernel_times(lambda v: sgm_cuda.bwd_accumulate(cost_k, v, p1, p2), cost_b + 2 * v1_b,
                     KERNEL_RUNS, lambda: (v1_k.clone(),)),
        plain_ms(lambda v: sgm_cuda.bwd_accumulate_plain(cost_k, v, p1, p2),
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
        kernel_times(lambda: sgm_cuda.vfinalize(cost_k, v3_k, *args),
                     cost_b + v1_b + HP * WP * 8, KERNEL_RUNS),
        plain_ms(lambda: sgm_cuda.vfinalize_plain(cost_k, v3_k, *args)),
        bound_ms(cost_b + v1_b + HP * WP * 8, 16 * n_el),
        ms_without_lr_check=round(run_ms(lambda: sgm_cuda.vfinalize(cost_k, v3_k, *no_lr),
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
            kernel_times(lambda v: sgm_cuda.diag_accumulate(cost8, v, p1, p2_8, vertical),
                         cost_b + 2 * v1_b, KERNEL_RUNS, lambda: (v8.clone(),)),
            plain_ms(lambda v: sgm_cuda.diag_accumulate_plain(cost8, v, p1, p2_8, vertical),
                     lambda: (v8.clone(),)),
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
        kernel_times(lambda v: sgm_sharded.bwd_accumulate_shard(cost_l, v, p1, p2), shard_b,
                     KERNEL_RUNS, lambda: (v1_l.clone(),)),
        plain_ms(lambda v: sgm_cuda.bwd_accumulate_plain(cost_l, v, p1, p2),
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
                kernel_times(lambda v: inplace(shards.cost[last], v, carry, p1, p2_, reverse,
                                               h_l), shard_b + 2 * carry.numel() * 4, KERNEL_RUNS,
                             lambda: (S_l.clone(),)),
                plain_ms(lambda v: plain(shards.cost[last], v, carry, p1, p2_, reverse, h_l),
                         lambda: (S_l.clone(),)),
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
        float((d_k - d_q).abs().max()),
        kernel_times(lambda: sgm_cuda.wta_finalize(S_l, *fin), el * 4 + d_k.numel() * 5,
                     KERNEL_RUNS),
        plain_ms(lambda: sgm_cuda.wta_finalize_plain(S_l, *fin)),
        bound_ms(el * 4 + d_k.numel() * 5, 8 * el), shard=list(S_l.shape),
        ms_without_lr_check=round(run_ms(lambda: sgm_cuda.wta_finalize(S_l, *fin_no_lr),
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
        times.append(kernel_times(lambda: wls_cuda.tridiag_solve(*sp, axis), 5 * H * W * 4,
                                  KERNEL_RUNS))
        plain_times.append(plain_ms(lambda: wls_cuda.tridiag_solve_plain(*sp, axis)))
    row("K6 tridiag_solve", "recon3d_tpu_torch/csrc/wls_tridiag.cu",
        "recon3d_tpu/depth/wls_pallas.py:102", slice_n["K6"], err,
        {k: (times[0][k] + times[1][k]) / 2 for k in times[0]}, sum(plain_times) / 2,
        bound_ms(5 * H * W * 4, 10 * H * W),
        ms_axis1=round(times[0]["ms"], 4), ms_axis0=round(times[1]["ms"], 4))

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
        nbytes = pk_q.numel() * 4 + sp.numel() * 4 + start.numel() * 4
        row(f"K7 pack_cells {shape}", "recon3d_tpu_torch/csrc/grid_pack.cu",
            "recon3d_tpu/ops/grid_knn_pallas.py:319", all_launches[shape]["K7"], 0.0,
            kernel_times(lambda: grid_knn_cuda.pack_cells(sp, start, C_), nbytes, KERNEL_RUNS),
            plain_ms(lambda: grid_knn.pack_plain(sp, start, C_)),
            bound_ms(nbytes, 0), run_ms(lambda: torch.index_select(sp, 0, pos), KERNEL_RUNS),
            library="torch.index_select of the sorted points at the clamped slot positions: "
                    "the placement without occupancy", grid=[G_, C_],
            occupied_slots=int(pk_q[:, 3].sum()),
            **({"scanner_launches": all_launches["scanner"]["K7"]} if shape == "scan_post"
               else {}))
        del pos, slot
        moments_path = "moments_1m" if shape == "normals_1m" else "scan_post_moments"
        for variant, fused, path in (("moments", False, moments_path), ("fused", True, shape)):
            out_k = grid_knn_cuda.core_call(pk_q, r2, G_, C_, fused)
            out_q = grid_knn.core_plain(pk_q, r2, G_, C_, fused)
            cnt = out_k[:, 3 if fused else 0]
            check(torch.equal(out_k, out_q), f"K8 {variant} differs from its plain version "
                  f"({shape}): {float((out_k - out_q).abs().max())}")
            nbytes = pk_q.numel() * 4 + out_k.numel() * 4
            # held to the instruction rate: every addition and product rounds alone
            row(f"K8 core_call {variant} {shape}", "recon3d_tpu_torch/csrc/grid_moments.cu",
                "recon3d_tpu/ops/grid_knn_pallas.py:147", all_launches[path]["K8"], 0.0,
                kernel_times(lambda: grid_knn_cuda.core_call(pk_q, r2, G_, C_, fused), nbytes,
                             KERNEL_RUNS),
                plain_ms(lambda: grid_knn.core_plain(pk_q, r2, G_, C_, fused)),
                bound_ms(nbytes, k8_operations(pk_q, cnt, G_, C_, fused), F32_INSTR_PER_S),
                None, library="none: no single PyTorch call computes it", grid=[G_, C_],
                tile=list(grid_knn_cuda.k8_tile(G_, C_)), bitwise=True,
                **({"scanner_launches": all_launches["scanner"]["K8"]}
                   if (shape, fused) == ("scan_post", True) else {}))
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
    nbytes = vc.numel() * 8 + s_q.numel() * 4 + imgs.numel() * 4
    check(torch.equal(s_k, s_q), "K9 differs from its plain version")
    row("K9 sample_images_at", "recon3d_tpu_torch/csrc/project_sample.cu",
        "recon3d_tpu/ops/project_sample.py:131", all_launches["fusion_plain"]["K9"],
        float((s_k - s_q).abs().max()),
        kernel_times(lambda: project_sample_cuda.sample_images_cuda(vc, uc, imgs), nbytes,
                     KERNEL_RUNS),
        plain_ms(lambda: project_sample.sample_images_plain(vc, uc, imgs)),
        bound_ms(nbytes, 0), run_ms(lambda: imgs[:, vcl, ucl], KERNEL_RUNS),
        library="advanced-index gather imgs[:, vc, uc] (the plain version itself)",
        shape=[*imgs.shape, fcfg.grid_resolution], path="the plain fusion path only")
    del vc, uc, vcl, ucl, imgs, s_k, s_q

    # the fuse kernel at the fusion shape, frame 0 into the fused volume:
    # the fold (integrate) and the contribution (integrate_frames, the
    # sharded fusion's passes), each against the plain path on the card. The
    # bytes: the volume read and written whole (fold) or written (contribution)
    # and the frame read once, portbench/work.py's count.
    R_f = fcfg.grid_resolution
    frame_bytes = cf["height"] * cf["width"] * (4 + 3)
    launches_on = {p: all_launches[p]["fuse"] for p in ("streaming", "offline", "offline_replay")}
    for mode, fold, vox_bytes in (("fold", True, 40), ("contribution", False, 20)):
        fn = lambda: tsdf._fuse_voxels(vol_k, d_t, fintr, pose, c_t,  # noqa: E731
                                       fcfg.depth_trunc, fold=fold)
        if fold:
            plain = lambda: tsdf._combine(vol_k, *tsdf._frame_contrib_plain(  # noqa: E731
                vol_k, d_t, fintr, pose, c_t, fcfg.depth_trunc), 64.0)
        else:
            plain = lambda: tsdf._frame_contrib_plain(  # noqa: E731
                vol_k, d_t, fintr, pose, c_t, fcfg.depth_trunc)
        out_k, out_q = fn(), plain()
        check(all(torch.equal(a, b) for a, b in zip(out_k, out_q)),
              f"the fuse kernel's {mode} differs from the plain path")
        nbytes = vox_bytes * R_f ** 3 + frame_bytes
        row(f"fuse tsdf_fuse_kernel {mode}", "recon3d_tpu_torch/csrc/tsdf_fuse.cu",
            "none (recon3d_tpu/fusion/tsdf.py:_integrate's XLA glue and K9)",
            all_launches["fusion"]["fuse"] if fold else all_launches["parallel_fusion"]["fuse"],
            0.0, kernel_times(fn, nbytes, KERNEL_RUNS), plain_ms(plain), bound_ms(nbytes, 0),
            None, library="none: no single PyTorch call computes it",
            shape=[cf["height"], cf["width"], R_f], bitwise=True,
            **({f"{p}_launches": n for p, n in launches_on.items()} if fold else {}))
        del out_k, out_q
    del vol_k

    emit({"kernels": rows})
    print(smi, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(f"# wall {time.perf_counter() - t_start:.1f} s", file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
