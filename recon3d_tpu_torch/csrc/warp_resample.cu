// K1: the two-pass rectification warp, both passes in one kernel, and its
// one-pass form.
//
// Replaces recon3d_tpu/ops/warp.py:remap_two_pass_pallas (kernel body
// _mk_resample_kernel, pallas_calls at warp.py:266 and :276). Same function:
// a pass samples along `axis`, out[i] = fma(1 - frac, a0, frac * a1), where
//   resid = (coord[i] - i) - coarse[line]     (f32, in that order)
//   rf = floor(resid), frac = resid - rf,
//   a0 = src[(i + coarse + rf) mod n]      if -R     <= rf <= R + 1, else 0,
//   a1 = src[(i + coarse + rf + 1) mod n]  if -R - 1 <= rf <= R,     else 0,
// n the line length and R the plan's residual bound. The TPU has no gather,
// so it built `base` = src rolled by the per-line coarse shift from a
// log2 ladder of masked rolls and picked the taps from a plane sweep of
// 2R + 2 rolls; the rolls wrap, which is the `mod n` here (the wrapped taps
// are the ones plan.valid masks). On Hopper a gather is cheap: each thread
// reads its two taps directly. The vertical pass (axis 0) takes a
// per-column coarse shift (W,), the horizontal pass (axis 1) a per-row one
// (H,); the horizontal pass also applies plan.valid.
//
// remap_two_pass_kernel runs both passes: a block owns an output row y. It
// samples row y of the intermediate t over the full width into shared
// memory (the vertical pass: each column's taps come from src rows near
// y + coarse), then samples that row for the horizontal pass, wrapped taps
// and all, applies plan.valid and writes the row, 4 pixels a thread with
// 16-byte loads and stores where the width allows. t never reaches device
// memory: a remap reads src, vy, hx and valid and writes out once (35.3 MB
// at 1080p against the two passes' 52 MB), in one launch.
//
// Bound on the H100: bytes. Every operation rounds as the plain PyTorch
// version's do: separate f32 subtractions and products (__fsub_rn /
// __fmul_rn, never contracted) and one fused multiply-add for the
// interpolation, the one XLA forms from (1 - frac) * a0 + frac * a1 and
// ops/image.py:fma computes. So the kernels match the plain version, and
// the JAX package, bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace r3d {

constexpr int kRowThreads = 128;

// One sample of a line: i the position along it, n its length, c its coarse
// shift, R the residual bound; the taps are line[k * step].
__device__ __forceinline__ float sample_line(const float* line, int step, int i, int n, int c,
                                             float coord, int R) {
  const float resid = __fsub_rn(__fsub_rn(coord, static_cast<float>(i)), static_cast<float>(c));
  const float rf = floorf(resid);
  const float frac = __fsub_rn(resid, rf);
  const int r = static_cast<int>(rf);
  int k = i + c + r;  // tap 0 along the line, wrapped like a roll
  if (static_cast<unsigned>(k) >= static_cast<unsigned>(n)) {
    k %= n;
    if (k < 0) k += n;
  }
  const int k1 = k + 1 == n ? 0 : k + 1;
  const float a0 = (r >= -R && r <= R + 1) ? line[k * step] : 0.0f;
  const float a1 = (r >= -R - 1 && r <= R) ? line[k1 * step] : 0.0f;
  return __fmaf_rn(__fsub_rn(1.0f, frac), a0, __fmul_rn(frac, a1));
}

// One pass over a 2-D grid: x across blocks of 256, y across the grid's rows.
__global__ void __launch_bounds__(256) resample_kernel(
    const float* __restrict__ src, const float* __restrict__ coord,
    const int* __restrict__ coarse, const uint8_t* __restrict__ valid, float* __restrict__ out,
    int H, int W, int axis, int resid_bound) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    const long long p = static_cast<long long>(y) * W + x;
    float v = axis == 0
                  ? sample_line(src + x, W, y, H, coarse[x], coord[p], resid_bound)
                  : sample_line(src + static_cast<long long>(y) * W, 1, x, W, coarse[y], coord[p],
                                resid_bound);
    if (valid != nullptr && valid[p] == 0) v = 0.0f;
    out[p] = v;
  }
}

// Both passes, a block a row (a grid-stride loop over rows); kVec: W % 4 == 0
// and 16-byte aligned planes, 4 pixels a thread.
template <bool kVec>
__global__ void __launch_bounds__(kRowThreads) remap_two_pass_kernel(
    const float* __restrict__ src, const float* __restrict__ vy, const float* __restrict__ hx,
    const int* __restrict__ v_coarse, const int* __restrict__ h_coarse,
    const uint8_t* __restrict__ valid, float* __restrict__ out, int H, int W, int v_bound,
    int h_bound) {
  extern __shared__ float t[];  // row y of the intermediate, W floats
  for (int y = blockIdx.x; y < H; y += gridDim.x) {
    const long long row = static_cast<long long>(y) * W;
    if (kVec) {
      for (int g = threadIdx.x; g < W / 4; g += kRowThreads) {
        const float4 cy = reinterpret_cast<const float4*>(vy + row)[g];
        const int4 c = reinterpret_cast<const int4*>(v_coarse)[g];
        const int x = 4 * g;
        t[x] = sample_line(src + x, W, y, H, c.x, cy.x, v_bound);
        t[x + 1] = sample_line(src + x + 1, W, y, H, c.y, cy.y, v_bound);
        t[x + 2] = sample_line(src + x + 2, W, y, H, c.z, cy.z, v_bound);
        t[x + 3] = sample_line(src + x + 3, W, y, H, c.w, cy.w, v_bound);
      }
    } else {
      for (int x = threadIdx.x; x < W; x += kRowThreads)
        t[x] = sample_line(src + x, W, y, H, v_coarse[x], vy[row + x], v_bound);
    }
    __syncthreads();
    const int c = h_coarse[y];
    if (kVec) {
      for (int g = threadIdx.x; g < W / 4; g += kRowThreads) {
        const float4 cx = reinterpret_cast<const float4*>(hx + row)[g];
        const uchar4 ok = reinterpret_cast<const uchar4*>(valid + row)[g];
        const int x = 4 * g;
        float4 o;
        o.x = ok.x ? sample_line(t, 1, x, W, c, cx.x, h_bound) : 0.0f;
        o.y = ok.y ? sample_line(t, 1, x + 1, W, c, cx.y, h_bound) : 0.0f;
        o.z = ok.z ? sample_line(t, 1, x + 2, W, c, cx.z, h_bound) : 0.0f;
        o.w = ok.w ? sample_line(t, 1, x + 3, W, c, cx.w, h_bound) : 0.0f;
        reinterpret_cast<float4*>(out + row)[g] = o;
      }
    } else {
      for (int x = threadIdx.x; x < W; x += kRowThreads)
        out[row + x] = valid[row + x] ? sample_line(t, 1, x, W, c, hx[row + x], h_bound) : 0.0f;
    }
    __syncthreads();  // t is rewritten for the next row
  }
}

}  // namespace r3d

// src, coord, out (H, W) f32; coarse (W,) int32 for axis 0, (H,) for axis 1;
// valid (H, W) uint8 or null (then no mask). Returns a cudaError_t code.
extern "C" int r3d_resample(const float* src, const float* coord, const int* coarse,
                            const uint8_t* valid, float* out, int H, int W, int axis,
                            int resid_bound, cudaStream_t stream) {
  if (H < 1 || W < 1 || static_cast<long long>(H) * W > INT_MAX || (axis != 0 && axis != 1) ||
      resid_bound < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + 255) / 256, H < 65535 ? H : 65535);
  r3d::resample_kernel<<<grid, 256, 0, stream>>>(src, coord, coarse, valid, out, H, W, axis,
                                                  resid_bound);
  return static_cast<int>(cudaGetLastError());
}

// src, vy, hx, out (H, W) f32; v_coarse (W,), h_coarse (H,) int32; valid
// (H, W) uint8 (bool); the plan's residual bounds. One launch: both passes.
// Returns a cudaError_t code.
extern "C" int r3d_remap_two_pass(const float* src, const float* vy, const float* hx,
                                  const int* v_coarse, const int* h_coarse, const uint8_t* valid,
                                  float* out, int H, int W, int v_bound, int h_bound,
                                  cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(W) * sizeof(float);
  if (H < 1 || W < 1 || static_cast<long long>(H) * W > INT_MAX || v_bound < 0 || h_bound < 0 ||
      smem > 226 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t planes = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(vy) |
                           reinterpret_cast<uintptr_t>(hx) | reinterpret_cast<uintptr_t>(out) |
                           reinterpret_cast<uintptr_t>(v_coarse);
  const bool vec = W % 4 == 0 && planes % 16 == 0 && reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  auto kernel = vec ? r3d::remap_two_pass_kernel<true> : r3d::remap_two_pass_kernel<false>;
  // Above 48 KB of dynamic shared memory (W > 12288) only when the kernel
  // says so; set once per instance and device.
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> attribute_set[2];
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
    if (!(attribute_set[vec].load() & bit)) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 226 * 1024);
      if (e != cudaSuccess) return static_cast<int>(e);
      attribute_set[vec].fetch_or(bit);
    }
  }
  kernel<<<H < 65535 ? H : 65535, r3d::kRowThreads, smem, stream>>>(
      src, vy, hx, v_coarse, h_coarse, valid, out, H, W, v_bound, h_bound);
  return static_cast<int>(cudaGetLastError());
}
