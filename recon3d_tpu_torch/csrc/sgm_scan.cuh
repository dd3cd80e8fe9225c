// SGM path scans shared by the cost (K2), backward (K3), standalone (K14)
// and vertical + finalize (K4, path_step only) kernels. Plain C interface, no
// PyTorch headers.
//
// One warp owns one scanline (a row for the horizontal paths, a column for
// the vertical ones) and walks it step by step with the carry in registers.
// The D = 32 * K disparities of a step are split over the lanes, lane l
// holding d = K*l .. K*l + K-1, so a step's cost and path values are one
// coalesced 64/128-bit access per lane. The d +- 1 neighbours come from
// __shfl_up/down_sync, the min over d from a butterfly of __shfl_xor_sync.
// Every lane of the warp runs every step: padded lanes and padded lines
// carry masked values, never an early exit, so the full-mask shuffles are
// always reached by all 32 lanes.
//
// The recurrence is recon3d_tpu/depth/sgm_pallas.py:_path_step
// (sgm_pallas.py:97-110): integer-valued f32 whose sums stay below 2^24, so
// every implementation of it agrees bitwise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace r3d {

constexpr unsigned kFullMask = 0xffffffffu;
// sgm_pallas._BIG: the d-1 / d+1 value beyond the first and last lane
constexpr float kPathEdge = 65535.0f;
// steps whose loads are issued together before their recurrence runs
constexpr int kScanChunk = 8;

#define R3D_LAUNCH_CHECK()                               \
  do {                                                   \
    cudaError_t e_ = cudaGetLastError();                 \
    if (e_ != cudaSuccess) return static_cast<int>(e_);  \
  } while (0)

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

template <int K>
__device__ __forceinline__ void load_cost(const int16_t* p, float (&c)[K]) {
  if constexpr (K == 4) {
    const short4 v = *reinterpret_cast<const short4*>(p);
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  } else {
    static_assert(K == 8, "D must be 128 or 256");
    const int4 v = *reinterpret_cast<const int4*>(p);
    const short* s = reinterpret_cast<const short*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = s[k];
  }
}

template <int K>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + k);
    v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
  }
}

template <int K>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; k += 4)
    *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

// carry <- c + min(carry, m + P2, carry[d-1] + P1, carry[d+1] + P1) - m
template <int K>
__device__ __forceinline__ void path_step(float (&carry)[K], const float (&c)[K],
                                          float p1, float p2, int lane) {
  float m = carry[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = fminf(m, carry[k]);
  m = warp_min(m);
  float below = __shfl_up_sync(kFullMask, carry[K - 1], 1);
  float above = __shfl_down_sync(kFullMask, carry[0], 1);
  if (lane == 0) below = kPathEdge;
  if (lane == 31) above = kPathEdge;
  float out[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float dm = (k == 0) ? below : carry[k - 1];
    const float dp = (k == K - 1) ? above : carry[k + 1];
    const float cand = fminf(fminf(carry[k], m + p2), fminf(dm, dp) + p1);
    out[k] = c[k] + cand - m;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) carry[k] = out[k];
}

// One path over `lines` scanlines of `steps` steps each. Element (line, s)
// of the (., ., D) volumes starts at line * line_stride + s * step_stride.
// Writes out = L (acc == nullptr) or out = L + acc; out may alias acc (the
// in-place accumulate of the backward and downward paths).
template <int K>
__global__ void __launch_bounds__(128) path_scan_kernel(
    const int16_t* __restrict__ cost, const float* acc, float* out,
    int lines, int steps, long long line_stride, long long step_stride,
    float p1, float p2, int reverse) {
  const int line = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (line >= lines) return;  // warp-uniform: whole warps leave together
  const long long base = line * line_stride + lane * K;
  float carry[K];
#pragma unroll
  for (int k = 0; k < K; ++k) carry[k] = 0.0f;
  for (int s0 = 0; s0 < steps; s0 += kScanChunk) {
    // issue the chunk's loads before its dependent recurrence steps
    float c[kScanChunk][K], a[kScanChunk][K];
#pragma unroll
    for (int j = 0; j < kScanChunk; ++j) {
      const int s = reverse ? steps - 1 - (s0 + j) : s0 + j;
      const long long off = base + s * step_stride;
      load_cost<K>(cost + off, c[j]);
      if (acc != nullptr) load_f32<K>(acc + off, a[j]);
    }
#pragma unroll
    for (int j = 0; j < kScanChunk; ++j) {
      const int s = reverse ? steps - 1 - (s0 + j) : s0 + j;
      path_step<K>(carry, c[j], p1, p2, lane);
      float o[K];
#pragma unroll
      for (int k = 0; k < K; ++k) o[k] = (acc != nullptr) ? carry[k] + a[j][k] : carry[k];
      store_f32<K>(out + base + s * step_stride, o);
    }
  }
}

// Horizontal path along every row of (HP, WP, DP) volumes.
inline int launch_hscan(const int16_t* cost, const float* acc, float* out, int HP, int WP,
                        int DP, float p1, float p2, int reverse, cudaStream_t stream) {
  const int blocks = (HP * 32 + 127) / 128;
  const long long line = static_cast<long long>(WP) * DP;
  if (DP == 128)
    path_scan_kernel<4><<<blocks, 128, 0, stream>>>(cost, acc, out, HP, WP, line, DP, p1, p2, reverse);
  else
    path_scan_kernel<8><<<blocks, 128, 0, stream>>>(cost, acc, out, HP, WP, line, DP, p1, p2, reverse);
  R3D_LAUNCH_CHECK();
  return 0;
}

// Downward path along every column of (HP, WP, DP) volumes, added onto acc.
inline int launch_vscan(const int16_t* cost, float* acc, int HP, int WP, int DP, float p1,
                        float p2, cudaStream_t stream) {
  const int blocks = (WP * 32 + 127) / 128;
  const long long row = static_cast<long long>(WP) * DP;
  if (DP == 128)
    path_scan_kernel<4><<<blocks, 128, 0, stream>>>(cost, acc, acc, WP, HP, DP, row, p1, p2, 0);
  else
    path_scan_kernel<8><<<blocks, 128, 0, stream>>>(cost, acc, acc, WP, HP, DP, row, p1, p2, 0);
  R3D_LAUNCH_CHECK();
  return 0;
}

}  // namespace r3d
