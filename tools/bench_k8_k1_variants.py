#!/usr/bin/env python3
"""Time K8 (csrc/grid_moments.cu) and K1 (csrc/warp_resample.cu) against
variants of their own designs on one CUDA card, at chip_smoke.py's shapes:
K8 on scan_post's table (NormalEstimation()'s G = 128, C = 8 on the chain's
cloud) and normals_1m's (1M unit-cube points, G = 52, C = 16), both
variants; K1 on the headline's raw 1080p image and plan.

    python3 tools/bench_k8_k1_variants.py [--root DIR] [VARIANT ...]  # from the repo's root

--root DIR times the entry points of another checkout's recon3d_tpu_torch
(its "shipped" K8 and its "fused" or "two_pass" K1, whatever that
checkout's kernels are: the parent commit's, say) with this checkout's
timing.

K8 variants (each held bitwise to core_plain before it is timed):
  tile=TX,TY,TZ  the committed kernel with a block owning TX x TY x TZ cells
                 ("shipped": ops/grid_knn_cuda.k8_tile's cube);
  merged         no hit list: each candidate's 16-operation accumulation
                 under its radius test, in the test loop (the parent's
                 divergent branch, on the staged, compacted candidates);
  hits32, hits48 hit lists of 32 or 48 entries a thread instead of 64;
  threads128     blocks of 128 threads instead of 256;
  minblocks3     __launch_bounds__(256, 3): at most 80 registers a thread;
  no_eig, no_sums, no_queries  timing only, not the function (not held to
                 the plain version): without the fused eigen-solve, without
                 the hits' sums, without the queries (the streaming and the
                 staging alone).
(The parent's kernel, a thread a slot, is "shipped" under --root.)
K1 variants (each held bitwise to remap_two_pass):
  fused          the committed kernel: both passes a launch, a block a row;
  two_pass       K1's one-pass form twice (two launches, t through memory);
  rows64, rows256  the fused kernel with 64 or 256 threads a row.
Each source variant is the committed file with text substitutions, built by
its own nvcc (in parallel) into build/kernels/k8k1_variants/ and loaded
with ctypes. Each variant is timed warm (chip_smoke.run_ms: a run of 20
launches behind a spin, over the count) and after an L2 flush
(chip_smoke.cold_ms, median of 20), in turn, twice. Prints one JSON line a
variant and the card's nvidia-smi line.
"""
import ctypes
import importlib.util
import inspect
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "recon3d_tpu_torch" / "csrc"
OUT = ROOT / "build" / "kernels" / "k8k1_variants"
RUNS = 20

K8_SRC, K1_SRC = "grid_moments.cu", "warp_resample.cu"
def _accumulate(p):
    return "".join(f"        m[{i}] = add(m[{i}], {e});\n" for i, e in enumerate(
        ("1.0f", f"{p}.x", f"{p}.y", f"{p}.z", f"mul({p}.x, {p}.x)", f"mul({p}.y, {p}.y)",
         f"mul({p}.z, {p}.z)", f"mul({p}.x, {p}.y)", f"mul({p}.x, {p}.z)", f"mul({p}.y, {p}.z)")))


SOURCE_VARIANTS = {
    "merged": (K8_SRC, [
        ("      if (dd <= a.r2) hits[kK8Threads * n++] = static_cast<unsigned short>(base + i);\n",
         "      if (dd <= a.r2) {\n" + _accumulate("p0") + "      }\n"),
        ("      if (i + 1 < nc && ee <= a.r2)\n"
         "        hits[kK8Threads * n++] = static_cast<unsigned short>(base + i + 1);\n",
         "      if (i + 1 < nc && ee <= a.r2) {\n" + _accumulate("p1") + "      }\n")]),
    "hits32": (K8_SRC, [("constexpr int kHits = 64;", "constexpr int kHits = 32;")]),
    "hits48": (K8_SRC, [("constexpr int kHits = 64;", "constexpr int kHits = 48;")]),
    "threads128": (K8_SRC, [("constexpr int kK8Threads = 256;",
                             "constexpr int kK8Threads = 128;")]),
    "minblocks3": (K8_SRC, [("__launch_bounds__(kK8Threads) grid_moments_kernel",
                             "__launch_bounds__(kK8Threads, 3) grid_moments_kernel")]),
    # timing only, not the function: what each part of the kernel costs
    "no_eig": (K8_SRC, [("        out4[g] = normal_row(m);",
                         "        out4[g] = make_float4(m[0], m[1], m[2], m[3]);")]),
    "no_sums": (K8_SRC, [("  for (int e = 0; e < n; ++e) {\n    const float4 p = halo[",
                          "  for (int e = 0; e < n && m[0] < 0.0f; ++e) {\n    const float4 p = halo[")]),
    "no_queries": (K8_SRC, [("      query_moments(a, s.halo,",
                             "      if (a.r2 < 0.0f) query_moments(a, s.halo,")]),
    "rows64": (K1_SRC, [("constexpr int kRowThreads = 128;", "constexpr int kRowThreads = 64;")]),
    "rows256": (K1_SRC, [("constexpr int kRowThreads = 128;",
                          "constexpr int kRowThreads = 256;")]),
}
K8_TILES = ((2, 2, 2), (3, 3, 3), (4, 4, 4), (3, 3, 4), (2, 4, 8), (4, 4, 8), (8, 8, 8))
TIMING_ONLY = ("no_eig", "no_sums", "no_queries")
K8_VARIANTS = (["shipped"] + [f"tile={','.join(map(str, t))}" for t in K8_TILES]
               + [n for n, (src, _) in SOURCE_VARIANTS.items() if src == K8_SRC])
K1_VARIANTS = ["fused", "two_pass", "rows64", "rows256"]


def build(names):
    """nvcc each source variant (in parallel) into OUT/<name>/lib.so."""
    from recon3d_tpu_torch import kernels

    procs = {}
    for name in names:
        if name not in SOURCE_VARIANTS:
            continue
        src_name, subs = SOURCE_VARIANTS[name]
        text = (CSRC / src_name).read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: substitution not found: {old[:60]!r}")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / src_name).write_text(text)
        procs[name] = subprocess.Popen(
            [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "lib.so"),
             str(d / src_name)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    regs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        regs[name] = [ln.split("Used ")[1].split(",")[0] for ln in out.splitlines()
                      if "Used " in ln and "registers" in ln]
    return regs


def lib_call(lib, fn, argtypes):
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int

    def call(*args):
        import torch

        code = f(*args, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{fn}: CUDA error {code}")
    return call


def k8_tables(dev):
    """(name, pk, r2, G, C) of scan_post and normals_1m, as chip_smoke.py
    builds them."""
    import torch

    import chip_smoke
    from recon3d_tpu_torch.camera.fake import SyntheticRGBDCamera
    from recon3d_tpu_torch.ops import grid_knn_cuda
    from recon3d_tpu_torch.pointcloud import normals
    from recon3d_tpu_torch.pointcloud.backproject import pointcloud_from_rgbd
    from recon3d_tpu_torch.pointcloud_processing import PointCloudProcessing
    from recon3d_tpu_torch.utils.types import CameraIntrinsics

    cam = SyntheticRGBDCamera(chip_smoke.SCAN_W, chip_smoke.SCAN_H)
    cam.open()
    color, depth = cam.grab()
    pc = pointcloud_from_rgbd(torch.tensor(color, device=dev), torch.tensor(depth, device=dev),
                              CameraIntrinsics(cam.fx, cam.fy, cam.cx, cam.cy))
    proc = PointCloudProcessing()
    q = proc.process_point_cloud(pc)
    defaults = inspect.signature(normals.estimate_normals).parameters
    G, C = defaults["grid_size"].default, defaults["cell_capacity"].default
    radius = proc.config.normal_radius
    c1m = chip_smoke.NORMALS_1M
    cube = chip_smoke.unit_cube_cloud(c1m["n"], dev)
    out = []
    for name, pts, valid, r, G_, C_ in (
            ("scan_post", q.points, q.valid, radius, G, C),
            ("normals_1m", cube.points, cube.valid, c1m["radius"], c1m["grid_size"],
             c1m["cell_capacity"])):
        pk, _, _ = grid_knn_cuda.bin_points_packed_cuda(pts, valid, r, G_, C_)
        out.append((name, pk, float(torch.tensor(r, dtype=torch.float32) ** 2), G_, C_))
    return out


def time_pair(fn):
    import chip_smoke

    return round(chip_smoke.run_ms(fn, RUNS), 4), round(chip_smoke.cold_ms(fn, RUNS), 4)


def main():
    import numpy as np
    import torch

    # this checkout's timing helpers, whichever package is timed
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    names = sys.argv[1:] or K8_VARIANTS + K1_VARIANTS
    root = ROOT
    if names[0] == "--root":
        root, names = pathlib.Path(names[1]).resolve(), names[2:]
    sys.path.insert(0, str(root))
    from recon3d_tpu_torch import kernels
    from recon3d_tpu_torch.ops import grid_knn, grid_knn_cuda, warp

    dev = torch.device("cuda", 0)
    kernels.load()
    regs = build(names)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    results = {n: {"variant": n, "checkout": str(root), "warm_ms": [], "cold_ms": [],
                   "registers": regs.get(n)} for n in names}

    def k8_call(n, pk, r2, G, C, fused, out):
        """Variant n's launch on one table (None: the tile does not fit)."""
        if n in SOURCE_VARIANTS:
            f = lib_call(ctypes.CDLL(str(OUT / n / "lib.so")), "r3d_grid_moments",
                         [P, P, I, I, F, I, I, I, I, P])
            tile = grid_knn_cuda.k8_tile(G, C)
            return lambda: f(pk.data_ptr(), out.data_ptr(), G, C, r2, int(fused), *tile) or out
        if n == "shipped":
            return lambda: grid_knn_cuda.core_call(pk, r2, G, C, fused)
        tile = tuple(int(v) for v in n[5:].split(","))
        if grid_knn_cuda.k8_smem_bytes(tile, C) > grid_knn_cuda.K8_MAX_SMEM:
            return None
        return lambda: kernels.launch("r3d_grid_moments", dev, pk.data_ptr(), out.data_ptr(), G,
                                      C, r2, int(fused), *tile) or out

    calls = {}  # name -> [(case, fn)]
    for case, pk, r2, G, C in k8_tables(dev):
        for fused in (False, True):
            ref = grid_knn.core_plain(pk, r2, G, C, fused)
            key = f"{case} {'fused' if fused else 'moments'}"
            for n in names:
                fn = k8_call(n, pk, r2, G, C, fused, torch.empty_like(ref)) \
                    if n in K8_VARIANTS else None
                if fn is None:
                    continue
                out = fn()
                torch.cuda.synchronize()
                if n not in TIMING_ONLY and not torch.equal(out, ref):
                    raise SystemExit(f"{n} {key}: differs from core_plain")
                calls.setdefault(n, []).append((key, fn))
            del ref

    mx, my = chip_smoke.synthetic_maps(chip_smoke.H, chip_smoke.W)
    imx, imy = chip_smoke.inverse_maps(chip_smoke.H, chip_smoke.W)
    rect_l = chip_smoke.bench_scene()[0]
    raw = torch.tensor(chip_smoke.remap_replicate(rect_l.astype(np.float32), imx, imy),
                       device=dev)
    plan = warp.build_remap_plan(mx, my, device=dev)
    ref = warp.remap_two_pass(raw, plan)
    out = torch.empty_like(ref)
    for n in names:
        if n not in K1_VARIANTS:
            continue
        if n == "fused":
            fn = lambda: warp.remap_two_pass_cuda(raw, plan)  # noqa: E731
        elif n == "two_pass":
            fn = lambda: warp.resample_pass(  # noqa: E731
                warp.resample_pass(raw, plan.vy, plan.v_coarse, 0, plan.v_resid_bound, 0),
                plan.hx, plan.h_coarse, 0, plan.h_resid_bound, 1, plan.valid)
        else:
            f = lib_call(ctypes.CDLL(str(OUT / n / "lib.so")), "r3d_remap_two_pass",
                         [P] * 7 + [I] * 4 + [P])
            fn = (lambda f: lambda: f(
                raw.data_ptr(), plan.vy.data_ptr(), plan.hx.data_ptr(), plan.v_coarse.data_ptr(),
                plan.h_coarse.data_ptr(), plan.valid.data_ptr(), out.data_ptr(), chip_smoke.H,
                chip_smoke.W, plan.v_resid_bound, plan.h_resid_bound) or out)(f)
        res = fn()
        torch.cuda.synchronize()
        if not torch.equal(res, ref):
            raise SystemExit(f"{n}: differs from remap_two_pass")
        calls[n] = [("headline 1080p", fn)]

    for _ in range(2):  # in turn, twice
        for n, cases in calls.items():
            warm, cold = {}, {}
            for key, fn in cases:
                warm[key], cold[key] = time_pair(fn)
            results[n]["warm_ms"].append(warm)
            results[n]["cold_ms"].append(cold)
    for n in names:
        print(json.dumps(results[n]), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
