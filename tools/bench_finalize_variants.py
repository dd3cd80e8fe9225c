#!/usr/bin/env python3
"""Time K4 and K12 (csrc/sgm_vfinalize.cu) against variants of their own
source on one CUDA card, at the headline shape (1088, 1920, 128) and the
row-sharded shape (320, 1920, 128).

    python3 tools/bench_finalize_variants.py      # from the repository root

Each variant is the committed source with one text substitution:
  final      as committed;
  cols8      8 columns a block (two blocks a SM) instead of 16;
  loop       the right view's diagonal as a loop over the columns that reach
             the target instead of all columns unrolled and masked;
  store      a plain store in place of the right view's atomicMin (timing
             only: the LR check is then wrong, so no bitwise check).
Each is built by its own nvcc (in parallel) into build/kernels/variants/
and timed in its own process: median CUDA-event ms of 20 launches with and
without the LR check (no right view), after one checked launch. Prints one
JSON line a variant and the card's nvidia-smi line.
"""
import ctypes
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "recon3d_tpu_torch" / "csrc"
OUT = ROOT / "build" / "kernels" / "variants"
VARIANTS = {
    "final": [],
    "cols8": [("constexpr int kFinCols = 16;", "constexpr int kFinCols = 8; "),
              ("__launch_bounds__(kFinThreads, 1)", "__launch_bounds__(kFinThreads, 2)")],
    "loop": [("""#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g >= g_lo && g <= g_hi) m = fminf(m, row[g * (DP + 1)]);""",
              "    for (int g = g_lo; g <= g_hi; ++g) m = fminf(m, row[g * (DP + 1)]);")],
    "store": [("""      atomicMin(a.plane + static_cast<long long>(y0 + ystep * r) * a.WP + x,
                __float_as_int(m));""",
               "      a.plane[static_cast<long long>(y0 + ystep * r) * a.WP + x] = __float_as_int(m);")],
}


def build_all():
    from recon3d_tpu_torch import kernels

    procs = {}
    for name, subs in VARIANTS.items():
        src = (CSRC / "sgm_vfinalize.cu").read_text()
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
            src = src.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "sgm_vfinalize.cu").write_text(src)
        shutil.copy(CSRC / "sgm_scan.cuh", d)
        procs[name] = subprocess.Popen(
            [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "sgm_vfinalize.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")


def time_variant(name):
    import torch

    import chip_smoke
    from recon3d_tpu_torch import kernels
    from recon3d_tpu_torch.depth import sgm_cuda

    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    for fn in ("r3d_vfinalize", "r3d_wta_finalize"):
        getattr(lib, fn).argtypes = kernels.SIGNATURES[fn]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream

    def cuda_ms(fn, runs=20):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return round(statistics.median(times), 4)

    H, W, D = chip_smoke.H, chip_smoke.W, chip_smoke.D
    rect_l, rect_r, *_ = chip_smoke.bench_scene()
    gl, gr = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (rect_l, rect_r))
    HP, WP, DP = sgm_cuda.padded_shape(H, W, D)
    p1, p2 = 200.0, 2400.0  # tuned(): 8 and 96 x 5^2
    cost, v = sgm_cuda.cost_fwd_down(gl, gr, D, 0, 5, 63, p1, p2, HP, WP, DP)
    v3 = sgm_cuda.bwd_accumulate(cost, v, p1, p2)
    S = sgm_cuda._scan_plain(cost, v3, torch.empty_like(v3), 0, True, 2 * p1, 2 * p2)
    S = S[HP - 320:].contiguous()  # the last shard's rows of the row-sharded frame
    refs = (sgm_cuda.vfinalize_plain(cost, v3, p1, p2, D, 10, 1, True, W, "up"),
            sgm_cuda.wta_finalize_plain(S, D, 10, 1, True, W))
    outs = [sgm_cuda._finalize_outputs(h, WP, dev) for h in (HP, 320)]

    def k4(md):
        d, val, plane = outs[0]
        code = lib.r3d_vfinalize(cost.data_ptr(), v3.data_ptr(), d.data_ptr(), val.data_ptr(),
                                 plane.data_ptr(), HP, WP, DP, D, W, 2 * p1, 2 * p2, 1, 10, md,
                                 1, stream)
        assert code == 0, code

    def k12(md):
        d, val, plane = outs[1]
        code = lib.r3d_wta_finalize(S.data_ptr(), d.data_ptr(), val.data_ptr(),
                                    plane.data_ptr(), 320, WP, DP, D, W, 10, md, 1, stream)
        assert code == 0, code

    k4(1)
    k12(1)
    torch.cuda.synchronize()
    res = {"variant": name}
    if name != "store":
        res["bitwise"] = all(torch.equal(o[0], r[0]) and torch.equal(o[1] > 0, r[1])
                             for o, r in zip(outs, refs))
    res.update(k4_ms=cuda_ms(lambda: k4(1)), k4_ms_without_lr_check=cuda_ms(lambda: k4(-1)),
               k12_ms=cuda_ms(lambda: k12(1)), k12_ms_without_lr_check=cuda_ms(lambda: k12(-1)))
    print(json.dumps(res), flush=True)


def main():
    if len(sys.argv) > 1:
        time_variant(sys.argv[1])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bench_finalize_variants: no CUDA device", file=sys.stderr)
        return 1
    build_all()
    for rnd in range(2):  # the variants in turns, twice
        for name in VARIANTS:
            subprocess.run([sys.executable, __file__, name], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
