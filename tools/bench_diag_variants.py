#!/usr/bin/env python3
"""Time K5 and K11 (csrc/sgm_diag.cu) against variants of their own source
on one CUDA card, at the accurate frame's shape (1088, 1920, 128) and the
row-sharded frame's shard (320, 1920, 128).

    python3 tools/bench_diag_variants.py [VARIANT ...]   # from the repository root

Each variant is the committed source with text substitutions:
  final          as committed: a warp carries one walker of each direction,
                 a chunk of 8 steps (4 at D = 256) of one, then of the
                 other; each adds its path row into v with float4
                 atomicAdd (red.global.add.v4.f32), no v load, no wait;
  interleaved    the first design: both walkers' steps interleaved, step by
                 step, within each chunk;
  bulk           each path row staged in shared memory and added by one TMA
                 bulk reduction (cp.reduce.async.bulk .add.f32) in place of
                 the lanes' float4 atomics;
  red_scalar     four scalar atomicAdds for each float4 one;
  plain_rmw      a plain load, add and store in place of the reductions
                 (timing only: the crossing paths race, so it is not exact);
  chunk4         4 steps (2 at D = 256) a chunk instead of 8 (4);
  chunk16        16 steps (8 at D = 256) a chunk;
  blocks64       2 warps a block (8 blocks a SM) instead of 4;
  lagged         no reductions: each walker reads v, adds and writes it
                 back, the b-walker (the path from x + 1) 8 steps behind
                 its warp's a-walker and waiting, through release / acquire
                 flags, for the a-walkers that wrote its next chunk's
                 elements; one cooperative launch (every walker resident);
  lagged16       lagged with the b-walker 16 steps behind;
  lagged_fences  lagged16 with a fence by every lane and volatile flags in
                 place of release / acquire;
  two_launch     lagged's path for volumes too wide for one launch: the
                 a-walkers, then the b-walkers, as two launches (two
                 passes over v, no wait).
Each is built by its own nvcc (in parallel) into build/kernels/diag_variants/
and timed in its own process: median CUDA-event ms of 20 launches in place
on the same volumes (integer sums stay below 2^24), after one launch on
fresh volumes held bitwise to the plain version. The accurate preset's
penalties (P1 = 200, P2 = 3200) on bench.py's rectified pair; the shard is
the frame's last 320 rows (264 real) with the carries of the 320 rows
above it. Prints one JSON line a variant, whether ncu is on the machine
(DRAM bytes are not measured without it), and the card's nvidia-smi line.
"""
import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "recon3d_tpu_torch" / "csrc"
OUT = ROOT / "build" / "kernels" / "diag_variants"
SHARD, H_REAL = 320, 264
KERNEL_START = "// The volumes, the row order and the carry planes of one call.\nstruct DiagPass {"
INTERLEAVED_START = "template <int K>\n__global__ void __launch_bounds__(kDiagThreads, 4) diag_pair_kernel("
KERNEL_END = "}  // namespace r3d"
RED_V4 = """    atomicAdd(reinterpret_cast<float4*>(p + k), make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));"""


def _reduce_with(body):
    return [(RED_V4, body)]


# the bulk reductions: a shared ring of a chunk's rows a walker
BULK = [
    ("""                                           long long plane, int t0, int lane) {""",
     """                                           long long plane, int t0, int lane,
                                           float (*slots)[32 * K]) {"""),
    ("""    red_add<K>(a.v + (static_cast<long long>(y) * a.WP + x) * DP + lane * K, carry);""",
     """    if (lane == 0) asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(2 * CH - 1) : "memory");
    __syncwarp();
    store_f32<K>(&slots[j][lane * K], carry);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      asm volatile(
          "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;" ::"l"(
              a.v + (static_cast<long long>(y) * a.WP + x) * DP),
          "r"(static_cast<unsigned>(__cvta_generic_to_shared(&slots[j][0]))), "n"(DP * 4)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }"""),
    ("""  constexpr int CH = diag_chunk<K>();
  const int w""", """  constexpr int CH = diag_chunk<K>();
  __shared__ __align__(128) float ring[kDiagThreads / 32][2][CH][32 * K];
  const int w"""),
    ("""    walk_chunk<K, CH>(a, ca, xa, 1, 0, s0, lane);
    walk_chunk<K, CH>(a, cb, xb, -1, plane, s0, lane);
  }
""", """    walk_chunk<K, CH>(a, ca, xa, 1, 0, s0, lane, ring[threadIdx.x >> 5][0]);
    walk_chunk<K, CH>(a, cb, xb, -1, plane, s0, lane, ring[threadIdx.x >> 5][1]);
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
"""),
]
# the first design: both walkers step by step within a chunk
INTERLEAVED = """constexpr int kWalkers = 2;  // one walker of each direction a warp

template <int K>
__global__ void __launch_bounds__(kDiagThreads, 4) diag_pair_kernel(
    const int16_t* __restrict__ cost, float* __restrict__ v, const float* __restrict__ carry_in,
    float* __restrict__ carry_out, int HP, int WP, float p1, float p2, int reverse, int h_last) {
  constexpr int DP = 32 * K;
  constexpr int CH = diag_chunk<K>();
  constexpr int NW = kWalkers;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= WP * 2 / NW) return;  // warp-uniform: whole warps leave together
  // the walkers' columns and directions (+1: the path from x - 1)
  int x[NW], dx[NW];
  if constexpr (NW == 2) {
    x[0] = x[1] = warp;
    dx[0] = 1;
    dx[1] = -1;
  } else {  // one walker a warp: two warps of each direction a block of four
    x[0] = ((warp >> 2) << 1) | (warp & 1);
    dx[0] = (warp & 2) ? -1 : 1;
  }
  const int dy = reverse ? -1 : 1;
  const int y0 = reverse ? HP - 1 : 0;
  const int entry_row = reverse ? h_last : 0;  // where carry_in enters
  const int snap_row = reverse ? 0 : h_last;   // whose carries go out
  const long long plane = static_cast<long long>(WP) * DP;
  float carry[NW][K];
#pragma unroll
  for (int n = 0; n < NW; ++n) zero<K>(carry[n]);
  for (int s0 = 0; s0 < HP; s0 += CH) {  // HP is a multiple of CH
    // issue the chunk's cost loads before its dependent recurrence steps
    float c[CH][NW][K];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const long long row = static_cast<long long>(y0 + dy * (s0 + j)) * WP;
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        int xj = x[n] + dx[n] * j;  // j < CH <= WP: at most one wrap
        xj += xj >= WP ? -WP : (xj < 0 ? WP : 0);
        load_cost<K>(cost + (row + xj) * DP + lane * K, c[j][n]);
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int y = y0 + dy * (s0 + j);  // the same for every walker
      const long long row = static_cast<long long>(y) * WP;
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        if (x[n] == (dx[n] > 0 ? 0 : WP - 1)) zero<K>(carry[n]);  // the zeroed entering column
        if (carry_in != nullptr && y == entry_row) {
          const int xs = x[n] - dx[n];
          if (xs >= 0 && xs < WP)
            load_f32<K>(carry_in + (dx[n] > 0 ? 0 : plane) + static_cast<long long>(xs) * DP +
                            lane * K,
                        carry[n]);
          else
            zero<K>(carry[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < NW; ++n) path_step<K>(carry[n], c[j][n], p1, p2, lane);
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        red_add<K>(v + (row + x[n]) * DP + lane * K, carry[n]);
        if (carry_out != nullptr && y == snap_row)
          store_f32<K>(carry_out + (dx[n] > 0 ? 0 : plane) + static_cast<long long>(x[n]) * DP +
                           lane * K,
                       carry[n]);
        x[n] += dx[n];
        x[n] += x[n] == WP ? -WP : (x[n] < 0 ? WP : 0);
      }
    }
  }
}

inline int launch_diag_pair(const int16_t* cost, float* v, const float* carry_in,
                            float* carry_out, int HP, int WP, int DP, float p1, float p2,
                            int reverse, int h_real, cudaStream_t stream) {
  if ((DP != 128 && DP != 256) || HP < 1 || HP % 8 != 0 || WP < 8 || WP % 2 != 0 ||
      h_real < 1 || h_real > HP)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (WP * 2 / kWalkers * 32 + kDiagThreads - 1) / kDiagThreads;
  if (DP == 128)
    diag_pair_kernel<4><<<blocks, kDiagThreads, 0, stream>>>(cost, v, carry_in, carry_out, HP,
                                                             WP, p1, p2, reverse, h_real - 1);
  else
    diag_pair_kernel<8><<<blocks, kDiagThreads, 0, stream>>>(cost, v, carry_in, carry_out, HP,
                                                             WP, p1, p2, reverse, h_real - 1);
  R3D_LAUNCH_CHECK();
  return 0;
}

"""


# the lagged design: every piece from the kernel to the launcher replaced
LAGGED = """constexpr int kLag = 8;

// v through L2 only: another SM's walker wrote it
template <int K>
__device__ __forceinline__ void load_f32_cg(const float* p, float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p + k));
    v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
  }
}

// The volumes, the row order and the carry planes of one call.
struct DiagPass {
  const int16_t* cost;
  float* v;
  const float* carry_in;  // nullptr for K5
  float* carry_out;       // nullptr for K5
  int WP, y0, dy, entry_row, snap_row;
  float p1, p2;
};

// CH steps of one walker (direction dx, carry plane at `plane`) from step
// t0: v[y, x] += its path value, in place.
template <int K, int CH>
__device__ __forceinline__ void walk_chunk(const DiagPass& a, float (&carry)[K], int& x, int dx,
                                           long long plane, int t0, int lane) {
  constexpr int DP = 32 * K;
  float c[CH][K], acc[CH][K];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    int xj = x + dx * j;  // j < CH <= WP: at most one wrap
    xj += xj >= a.WP ? -a.WP : (xj < 0 ? a.WP : 0);
    const long long off =
        (static_cast<long long>(a.y0 + a.dy * (t0 + j)) * a.WP + xj) * DP + lane * K;
    load_cost<K>(a.cost + off, c[j]);
    load_f32_cg<K>(a.v + off, acc[j]);
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int y = a.y0 + a.dy * (t0 + j);  // the same for every lane
    if (x == (dx > 0 ? 0 : a.WP - 1)) zero<K>(carry);  // the zeroed entering column
    if (a.carry_in != nullptr && y == a.entry_row) {
      const int xs = x - dx;
      if (xs >= 0 && xs < a.WP)
        load_f32<K>(a.carry_in + plane + static_cast<long long>(xs) * DP + lane * K, carry);
      else
        zero<K>(carry);
    }
    path_step<K>(carry, c[j], a.p1, a.p2, lane);
    float o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = carry[k] + acc[j][k];
    store_f32<K>(a.v + (static_cast<long long>(y) * a.WP + x) * DP + lane * K, o);
    if (a.carry_out != nullptr && y == a.snap_row)
      store_f32<K>(a.carry_out + plane + static_cast<long long>(x) * DP + lane * K, carry);
    x += dx;
    x += x == a.WP ? -a.WP : (x < 0 ? a.WP : 0);
  }
}

// This warp's a-walker has written its first `steps` steps.
__device__ __forceinline__ void publish(int* flag, int steps, int lane) {
  __syncwarp();
  if (lane == 0) asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(flag), "r"(steps) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int f;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(f) : "l"(p) : "memory");
  return f;
}

// Wait until the a-walkers that b-walker w meets at its steps t0 .. t0 +
// CH - 1 have written them: at step t that is a-walker (w - 2t) mod WP.
template <int CH>
__device__ __forceinline__ void wait_for_a(const int* progress, int w, int t0, int WP,
                                           int lane) {
  int i = 0, need = 0;
  if (lane < CH) {
    i = (w - 2 * (t0 + lane)) % WP;
    i += i < 0 ? WP : 0;
    need = t0 + lane + 1;
  }
  for (int spins = 0;; ++spins) {
    const bool ready =
        lane >= CH || load_acquire(progress + i) >= need;
    if (__all_sync(kFullMask, ready)) break;
    if (spins == (1 << 22)) __trap();  // fail the launch rather than hang
    __nanosleep(32);
  }
  __syncwarp();
}

// dirs 3: both walkers of each warp, b kLag steps behind a (a cooperative
// launch); 1 or 2: the a- or the b-walkers alone.
template <int K>
__global__ void __launch_bounds__(kDiagThreads, 4) diag_pair_kernel(
    const int16_t* __restrict__ cost, float* v, const float* __restrict__ carry_in,
    float* __restrict__ carry_out, int* progress, int HP, int WP, float p1, float p2,
    int reverse, int h_last, int dirs) {
  constexpr int CH = diag_chunk<K>();
  static_assert(kLag % CH == 0 && kLag >= CH, "b starts on a chunk, a chunk or more behind");
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= WP) return;  // warp-uniform: whole warps leave together
  const DiagPass a{cost, v, carry_in, carry_out, WP, reverse ? HP - 1 : 0, reverse ? -1 : 1,
                   reverse ? h_last : 0, reverse ? 0 : h_last, p1, p2};
  const long long plane = static_cast<long long>(WP) * 32 * K;
  const int lag = dirs == 3 ? kLag : 0;
  float ca[K], cb[K];
  zero<K>(ca);
  zero<K>(cb);
  int xa = w, xb = w;
  for (int c0 = 0; c0 < HP + lag; c0 += CH) {  // HP is a multiple of CH
    if ((dirs & 1) && c0 < HP) {
      walk_chunk<K, CH>(a, ca, xa, 1, 0, c0, lane);
      if (dirs == 3) publish(progress + w, c0 + CH, lane);
    }
    const int t0 = c0 - lag;
    if ((dirs & 2) && t0 >= 0) {
      if (dirs == 3) wait_for_a<CH>(progress, w, t0, WP, lane);
      walk_chunk<K, CH>(a, cb, xb, -1, plane, t0, lane);
    }
  }
}

__device__ int g_progress[1 << 14];

inline int launch_diag_pair(const int16_t* cost, float* v, const float* carry_in,
                            float* carry_out, int HP, int WP, int DP, float p1, float p2,
                            int reverse, int h_real, cudaStream_t stream) {
  int* progress = nullptr;
  if (WP > (1 << 14) || cudaGetSymbolAddress(reinterpret_cast<void**>(&progress), g_progress))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((DP != 128 && DP != 256) || HP < 1 || HP % 8 != 0 || WP < 8 || h_real < 1 ||
      h_real > HP)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const int16_t*, float*, const float*, float*, int*, int, int, float, float, int,
                 int, int) = DP == 128 ? diag_pair_kernel<4> : diag_pair_kernel<8>;
  int blocks = (WP * 32 + kDiagThreads - 1) / kDiagThreads, h_last = h_real - 1, dirs = 3;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDiagThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks <= per_sm * sms) {  // every walker resident at once
    e = cudaMemsetAsync(progress, 0, sizeof(int) * WP, stream);
    void* args[] = {&cost, &v, &carry_in, &carry_out, &progress, &HP,
                    &WP,   &p1, &p2,      &reverse,   &h_last,   &dirs};
    if (e == cudaSuccess)
      e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                      dim3(kDiagThreads), args, 0, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {  // too wide: the a-walkers, then the b-walkers
    for (int d = 1; d <= 2; ++d) {
      kernel<<<blocks, kDiagThreads, 0, stream>>>(cost, v, carry_in, carry_out, progress, HP, WP,
                                                  p1, p2, reverse, h_last, d);
      R3D_LAUNCH_CHECK();
    }
  }
  R3D_LAUNCH_CHECK();
  return 0;
}

"""
VARIANTS = {
    "final": [],
    "interleaved": [((INTERLEAVED_START, KERNEL_END), INTERLEAVED)],
    "bulk": BULK,
    "red_scalar": _reduce_with("""    for (int i = 0; i < 4; ++i) atomicAdd(p + k + i, v[k + i]);"""),
    "plain_rmw": _reduce_with("""  {
    float4 o = __ldcg(reinterpret_cast<const float4*>(p + k));
    o.x += v[k]; o.y += v[k + 1]; o.z += v[k + 2]; o.w += v[k + 3];
    *reinterpret_cast<float4*>(p + k) = o;
  }"""),
    "chunk4": [("return K == 4 ? 8 : 4;", "return K == 4 ? 4 : 2;")],
    "chunk16": [("return K == 4 ? 8 : 4;", "return K == 4 ? 16 : 8;")],
    "blocks64": [("constexpr int kDiagThreads = 128;", "constexpr int kDiagThreads = 64;"),
                 ("__launch_bounds__(kDiagThreads, 4)", "__launch_bounds__(kDiagThreads, 8)")],
    "lagged": [((KERNEL_START, KERNEL_END), LAGGED)],
    "lagged16": [((KERNEL_START, KERNEL_END), LAGGED.replace("kLag = 8;", "kLag = 16;"))],
    "lagged_fences": [((KERNEL_START, KERNEL_END), LAGGED.replace("kLag = 8;", "kLag = 16;").replace(
        """  __syncwarp();
  if (lane == 0) asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(flag), "r"(steps) : "memory");""",
        """  __threadfence();
  __syncwarp();
  if (lane == 0) *reinterpret_cast<volatile int*>(flag) = steps;""").replace(
        "lane >= CH || load_acquire(progress + i) >= need;",
        "lane >= CH || *reinterpret_cast<const volatile int*>(progress + i) >= need;").replace(
        """    __nanosleep(32);
  }
  __syncwarp();""", """    __nanosleep(32);
  }
  __threadfence();"""))],
    "two_launch": [((KERNEL_START, KERNEL_END),
                    LAGGED.replace("if (blocks <= per_sm * sms) {", "if (false) {"))],
}
TIMING_ONLY = {"plain_rmw"}  # not exact by design: no bitwise check


def substitute(src, subs):
    """The source with each (old, new) replaced; old is a string that occurs
    once, or a (start, end) pair of markers whose span from start to just
    before end is replaced."""
    for old, new in subs:
        if isinstance(old, tuple):
            start, end = old
            if src.count(start) != 1 or src.count(end) != 1:
                raise RuntimeError(f"the source no longer holds {start!r} .. {end!r}")
            i, j = src.index(start), src.index(end)
            src = src[:i] + new + src[j:]
        else:
            if src.count(old) != 1:
                raise RuntimeError(f"the source no longer holds {old!r}")
            src = src.replace(old, new)
    return src


def build_all(names):
    from recon3d_tpu_torch import kernels

    procs = {}
    for name in names:
        subs = VARIANTS[name]
        src = substitute((CSRC / "sgm_diag.cu").read_text(), subs)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "sgm_diag.cu").write_text(src)
        shutil.copy(CSRC / "sgm_scan.cuh", d)
        procs[name] = subprocess.Popen(
            [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "lib.so"),
             str(d / "sgm_diag.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)


def time_variant(name):
    import torch

    import chip_smoke
    from recon3d_tpu_torch import kernels
    from recon3d_tpu_torch.depth import sgm_cuda

    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    for fn in ("r3d_diag_accumulate", "r3d_diag_carry"):
        getattr(lib, fn).argtypes = kernels.SIGNATURES[fn]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream

    def cuda_ms(fn, runs=20):
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
    p1, p2 = 200.0, 3200.0  # accurate(): 8 and 128 x 5^2
    cost, v = sgm_cuda.cost_fwd_down(gl, gr, D, 0, 5, 63, p1, p2, HP, WP, DP)
    v3 = sgm_cuda.bwd_accumulate(cost, v, p1, p2)
    cost_s, v_s = (t[HP - SHARD:].contiguous() for t in (cost, v3))
    zero = torch.zeros((2, WP, DP), device=dev)
    carry = sgm_cuda.diag_carry_plain(cost[HP - 2 * SHARD:HP - SHARD].contiguous(),
                                      v3[HP - 2 * SHARD:HP - SHARD].clone(), zero, p1, p2,
                                      False, SHARD)[1]
    carry_out = torch.empty_like(carry)

    def k5(vol, reverse):
        code = lib.r3d_diag_accumulate(cost.data_ptr(), vol.data_ptr(), HP, WP, DP, 2 * p1,
                                       2 * p2, reverse, stream)
        assert code == 0, code

    def k11(vol, reverse):
        code = lib.r3d_diag_carry(cost_s.data_ptr(), vol.data_ptr(), carry.data_ptr(),
                                  carry_out.data_ptr(), SHARD, WP, DP, 2 * p1, 2 * p2, reverse,
                                  H_REAL, stream)
        assert code == 0, code

    res = {"variant": name, "bitwise": None if name in TIMING_ONLY else True}
    for reverse in (0, 1):
        vertical = "up" if reverse else "down"
        out = v3.clone()
        k5(out, reverse)
        torch.cuda.synchronize()
        if res["bitwise"] is not None:
            res["bitwise"] &= torch.equal(out, sgm_cuda.diag_accumulate_plain(
                cost, v3.clone(), p1, p2, vertical))
        res[f"k5_{vertical}_ms"] = cuda_ms(lambda: k5(out, reverse))
        out = v_s.clone()
        k11(out, reverse)
        torch.cuda.synchronize()
        if res["bitwise"] is not None:
            ref, cref = sgm_cuda.diag_carry_plain(cost_s, v_s.clone(), carry, p1, p2,
                                                  bool(reverse), H_REAL)
            res["bitwise"] &= torch.equal(out, ref) and torch.equal(carry_out, cref)
        res[f"k11_{vertical}_ms"] = cuda_ms(lambda: k11(out, reverse))
    print(json.dumps(res), flush=True)


def main():
    if sys.argv[1:2] == ["--one"]:
        time_variant(sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bench_diag_variants: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    build_all(names)
    for rnd in range(2):  # the variants in turns, twice
        for name in names:
            subprocess.run([sys.executable, __file__, "--one", name], check=True)
    ncu = shutil.which("ncu")
    print(json.dumps({"ncu": ncu, "dram_bytes": "not measured: " + (
        "this tool does not run ncu" if ncu else "no ncu on this machine")}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
