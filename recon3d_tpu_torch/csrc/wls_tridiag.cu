// K6: Thomas tridiagonal solves of the Fast Global Smoother (WLS refine).
//
// Replaces recon3d_tpu/depth/wls_pallas.py:_solve (kernel body
// _mk_tridiag_kernel, pallas_call at wls_pallas.py:102). Same function: per
// system -wl[i] u[i-1] + diag[i] u[i] - wr[i] u[i+1] = rhs[i] with
// wl[0] = wr[n-1] = 0, solved by a forward elimination into the cp / dp
// factor planes and a back substitution.
//
// Bound on the H100: each line's dependent chain, not the bytes (4 input
// planes, the output and the cp / dp scratch: ~0.012 ms at 1080p). A line
// is 1080 or 1920 sequential steps of mul, add, clamp, IEEE division and
// mul, each step waiting for the one before, so a line takes the same time
// however many lines run beside it. The design keeps everything else off
// that chain. A block owns 32 consecutive lines. Its first warp solves them,
// one line a lane, reading only shared memory; the block's seven other
// warps copy. The four coefficient planes come in chunks of kSteps steps,
// staged with cp.async and double-buffered: each round the solving warp
// works on chunk k while the copying warps stage chunk k + 1 in and write
// chunk k - 1's cp / dp back, and one barrier a round hands the buffers
// over. The back substitution stages cp / dp in again the same way, last
// chunk first. A tile is copied coalesced whatever the axis: along the row
// for the vertical solve (axis 0, one line a column, tile stored
// step-major) and along each line for the horizontal solve (axis 1, one
// line a row, tile stored line-major with a padded row, so the solving
// warp's reads of one step hit 32 distinct banks). The solving warp reads
// a group of kGroup steps' coefficients before their recurrence steps.
// Ragged edges (a line count that is not a multiple of 32, a length that is
// not a multiple of kSteps) are masked copies, never early exits.
//
// Every output keeps the plain version's arithmetic and order: the
// __f*_rn intrinsics (no contraction into fused multiply-adds), the
// |den| < 1e-12 clamp, the IEEE division 1 / den, then the multiplies. Only
// where the data lives and which thread does the work changed. The
// division (reciprocal, correction and a range check) is most of a step.
#include <cuda_runtime.h>

#include <atomic>
#include <climits>

namespace r3d {

constexpr int kLines = 32;                  // lines a block: one a lane of the solving warp
constexpr int kSteps = 64;                  // steps of one staged chunk
constexpr int kCopiers = 7;                 // warps that stage tiles in and write them back
constexpr int kThreads = 32 * (1 + kCopiers);
constexpr int kPerCopier = (kLines * kSteps + 32 * kCopiers - 1) / (32 * kCopiers);
constexpr int kGroup = 16;                  // steps whose tile reads are issued together
constexpr int kTile = kLines * (kSteps + 1);  // floats of one tile (padded line-major)
constexpr int kSmemBytes = 12 * kTile * 4;    // 2 x 4 coefficient + 2 x 2 factor tiles

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Where element (line l, step t) of a chunk sits in its tile: step-major
// for the vertical solve, line-major with a padded row for the horizontal
// one, so the solving warp's reads of one step hit 32 distinct banks.
template <int AXIS>
__device__ __forceinline__ int tix(int l, int t) {
  return AXIS == 0 ? t * kLines + l : l * (kSteps + 1) + t;
}

// Element e of a chunk in the order that is contiguous in the planes:
// consecutive lines for the vertical solve, consecutive steps for the
// horizontal one, so each copying warp's access is one coalesced segment.
template <int AXIS>
__device__ __forceinline__ void element(int e, int& l, int& t) {
  if (AXIS == 0) {
    l = e % kLines;
    t = e / kLines;
  } else {
    t = e % kSteps;
    l = e / kSteps;
  }
}

// One chunk of a block's lines: element (l, t) is at base + l * sys +
// t * step of each plane; nl lines and nt steps are real.
struct Chunk {
  int base, sys, step, nl, nt;
};

// The copying warps (c = 0 .. 32 kCopiers - 1) stage tiles a of a chunk of
// planes src[a] into dst + a kTile; masked elements are zero-filled.
template <int AXIS, int N>
__device__ __forceinline__ void stage_in(float* dst, const float* const (&src)[N],
                                         const Chunk& ch, int c) {
#pragma unroll
  for (int r = 0; r < kPerCopier; ++r) {
    const int e = c + r * 32 * kCopiers;
    int l, t;
    element<AXIS>(e, l, t);
    const bool ok = e < kLines * kSteps && l < ch.nl && t < ch.nt;
    const int o = ok ? ch.base + l * ch.sys + t * ch.step : 0;
#pragma unroll
    for (int a = 0; a < N; ++a)
      if (e < kLines * kSteps) cp_async4(dst + a * kTile + tix<AXIS>(l, t), src[a] + o, ok);
  }
}

// ... and write tiles src + a kTile back to planes dst[a].
template <int AXIS, int N>
__device__ __forceinline__ void write_back(float* const (&dst)[N], const float* src,
                                           const Chunk& ch, int c) {
#pragma unroll
  for (int r = 0; r < kPerCopier; ++r) {
    const int e = c + r * 32 * kCopiers;
    int l, t;
    element<AXIS>(e, l, t);
    if (e < kLines * kSteps && l < ch.nl && t < ch.nt) {
      const int o = ch.base + l * ch.sys + t * ch.step;
#pragma unroll
      for (int a = 0; a < N; ++a) dst[a][o] = src[a * kTile + tix<AXIS>(l, t)];
    }
  }
}

// The solving warp's forward elimination over kGroup steps from t0 of a
// chunk: coefficient tiles in (wl, wr, diag, rhs), factor tiles out (cp,
// dp). The group's tile reads are issued before its recurrence steps, so
// only the recurrence's own latency is on the chain. A full group (TAIL
// false) runs without per-step bounds checks; the tail group reads padding
// past nt and skips those steps.
template <int AXIS, bool TAIL>
__device__ __forceinline__ void eliminate(const float* __restrict__ in, float* __restrict__ out,
                                          int t0, int nt, int lane, float& cpv, float& dpv) {
  float wl[kGroup], wr[kGroup], dg[kGroup], rh[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int i = tix<AXIS>(lane, t0 + g);
    wl[g] = in[i];
    wr[g] = in[kTile + i];
    dg[g] = in[2 * kTile + i];
    rh[g] = in[3 * kTile + i];
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    if (!TAIL || t0 + g < nt) {
      float den = __fadd_rn(dg[g], __fmul_rn(wl[g], cpv));
      if (fabsf(den) < 1e-12f) den = 1e-12f;
      const float inv = __fdiv_rn(1.0f, den);
      cpv = __fmul_rn(-wr[g], inv);
      dpv = __fmul_rn(__fadd_rn(rh[g], __fmul_rn(wl[g], dpv)), inv);
      const int i = tix<AXIS>(lane, t0 + g);
      out[i] = cpv;
      out[kTile + i] = dpv;
    }
  }
}

// ... and its back substitution over kGroup steps from t0, last step first:
// factor tiles in (cp, dp), the solution tile out.
template <int AXIS, bool TAIL>
__device__ __forceinline__ void substitute(const float* __restrict__ in, float* __restrict__ out,
                                           int t0, int nt, int lane, float& u) {
  float cp[kGroup], dp[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int i = tix<AXIS>(lane, t0 + g);
    cp[g] = in[i];
    dp[g] = in[kTile + i];
  }
#pragma unroll
  for (int g = kGroup - 1; g >= 0; --g) {
    if (!TAIL || t0 + g < nt) {
      u = __fsub_rn(dp[g], __fmul_rn(cp[g], u));
      out[tix<AXIS>(lane, t0 + g)] = u;
    }
  }
}

// The solving warp's work on one chunk of nt steps, in groups.
template <int AXIS>
__device__ __forceinline__ void eliminate_chunk(const float* in, float* out, int nt, int lane,
                                                float& cpv, float& dpv) {
  int t0 = 0;
  for (; t0 + kGroup <= nt; t0 += kGroup) eliminate<AXIS, false>(in, out, t0, nt, lane, cpv, dpv);
  if (t0 < nt) eliminate<AXIS, true>(in, out, t0, nt, lane, cpv, dpv);
}

template <int AXIS>
__device__ __forceinline__ void substitute_chunk(const float* in, float* out, int nt, int lane,
                                                 float& u) {
  int t0 = (nt - 1) / kGroup * kGroup;
  if (t0 + kGroup > nt) {
    substitute<AXIS, true>(in, out, t0, nt, lane, u);
    t0 -= kGroup;
  }
  for (; t0 >= 0; t0 -= kGroup) substitute<AXIS, false>(in, out, t0, nt, lane, u);
}

template <int AXIS>
__global__ void __launch_bounds__(kThreads) tridiag_kernel(
    const float* __restrict__ wl, const float* __restrict__ wr, const float* __restrict__ diag,
    const float* __restrict__ rhs, float* __restrict__ out, float* cp, float* dp, int len,
    int count, int step, int sys) {
  // forward: coefficient tiles 0-3 / 4-7 (chunk k even / odd), factor tiles
  // 8-9 / 10-11; back substitution: factor tiles 0-1 / 2-3, solution tiles
  // 4 / 5
  extern __shared__ float sm[];
  const bool solver = threadIdx.x < 32;
  const int lane = threadIdx.x & 31, c = threadIdx.x - 32;
  const int l0 = blockIdx.x * kLines;
  const int chunks = (len + kSteps - 1) / kSteps;
  auto chunk = [&](int k) {
    return Chunk{l0 * sys + k * kSteps * step, sys, step, min(kLines, count - l0),
                 min(kSteps, len - k * kSteps)};
  };

  // Each round the solving warp works on chunk k while the copying warps
  // stage chunk k + 1 in and write chunk k - 1's results back; one barrier
  // a round hands the buffers over.
  const float* const coef[4] = {wl, wr, diag, rhs};
  float* const fac_out[2] = {cp, dp};
  if (!solver) {
    stage_in<AXIS>(sm, coef, chunk(0), c);
    cp_async_wait_all();
  }
  __syncthreads();
  float cpv = 0.0f, dpv = 0.0f;
  for (int k = 0; k < chunks; ++k) {
    if (solver) {
      eliminate_chunk<AXIS>(sm + (k & 1) * 4 * kTile, sm + (8 + 2 * (k & 1)) * kTile,
                            chunk(k).nt, lane, cpv, dpv);
    } else {
      if (k + 1 < chunks) stage_in<AXIS>(sm + ((k + 1) & 1) * 4 * kTile, coef, chunk(k + 1), c);
      if (k > 0) write_back<AXIS>(fac_out, sm + (8 + 2 * ((k - 1) & 1)) * kTile, chunk(k - 1), c);
      cp_async_wait_all();
    }
    __syncthreads();
  }
  if (!solver)
    write_back<AXIS>(fac_out, sm + (8 + 2 * ((chunks - 1) & 1)) * kTile, chunk(chunks - 1), c);
  __syncthreads();  // orders the cp / dp writes before they are staged in again below

  const float* const fac[2] = {cp, dp};
  float* const res[1] = {out};
  if (!solver) {
    stage_in<AXIS>(sm, fac, chunk(chunks - 1), c);
    cp_async_wait_all();
  }
  __syncthreads();
  float u = 0.0f;
  for (int k = chunks - 1, j = 0; k >= 0; --k, ++j) {
    if (solver) {
      substitute_chunk<AXIS>(sm + (j & 1) * 2 * kTile, sm + (4 + (j & 1)) * kTile,
                             chunk(k).nt, lane, u);
    } else {
      if (k > 0) stage_in<AXIS>(sm + ((j + 1) & 1) * 2 * kTile, fac, chunk(k - 1), c);
      if (j > 0) write_back<AXIS>(res, sm + (4 + ((j - 1) & 1)) * kTile, chunk(k + 1), c);
      cp_async_wait_all();
    }
    __syncthreads();
  }
  if (!solver) write_back<AXIS>(res, sm + (4 + ((chunks - 1) & 1)) * kTile, chunk(0), c);
}

}  // namespace r3d

// All planes (n, m) f32, row-major, n * m < 2^31. axis 0 solves down each
// column, axis 1 along each row. cp and dp are (n, m) scratch. Returns a
// cudaError_t code.
extern "C" int r3d_tridiag(const float* wl, const float* wr, const float* diag, const float* rhs,
                           float* out, float* cp, float* dp, int n, int m, int axis,
                           cudaStream_t stream) {
  if (n < 1 || m < 1 || static_cast<long long>(n) * m > INT_MAX || (axis != 0 && axis != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int len = axis == 0 ? n : m;
  const int count = axis == 0 ? m : n;
  auto kernel = axis == 0 ? r3d::tridiag_kernel<0> : r3d::tridiag_kernel<1>;
  // Above 48 KB of dynamic shared memory only when the kernel says so. The
  // attribute persists, so it is set once per instance and device (a bit a
  // device), not on every launch.
  static std::atomic<unsigned long long> attribute_set[2];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (!(attribute_set[axis].load() & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             r3d::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_set[axis].fetch_or(bit);
  }
  kernel<<<(count + r3d::kLines - 1) / r3d::kLines, r3d::kThreads, r3d::kSmemBytes, stream>>>(
      wl, wr, diag, rhs, out, cp, dp, len, count, axis == 0 ? m : 1, axis == 0 ? 1 : m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* r3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
