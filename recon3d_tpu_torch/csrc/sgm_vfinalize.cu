// K4: last vertical SGM path + WTA finalize.
//
// Replaces recon3d_tpu/depth/sgm_pallas.py:aggregate_and_finalize's fused
// vertical-scan + finalize (kernel body _mk_vfinalize_kernel with
// _finalize_body, pallas_call at sgm_pallas.py:1135). Same function: S =
// v3 + L_up (L_down in 3-direction mode); per pixel the WTA disparity with
// ties to the smallest d, parabolic subpixel, the uniqueness ratio, the
// right-view WTA over S_R(x, d) = S(x + d, d) and the left-right check.
//
// Bound on the H100: bytes. The vertical path reads the cost (535 MB) and
// v3 (1.07 GB) and writes S over v3; the finalize reads S once more. The TPU
// kept S in VMEM; a (1920, 128) f32 row is 983 KB, beyond the 227 KB of
// shared memory, so here S goes to device memory and three launches follow:
//   1. the vertical path (sgm_scan.cuh), S written in place over v3;
//   2. one warp per pixel, 8 consecutive pixels a warp: lane l holds
//      d = l + 32k, so the row read S(x, .) is coalesced and the right-view
//      diagonal read S(x + d, d) (one word in each of 32 columns) is reused
//      from L1 / L2 by the neighbouring pixels; a warp min of cost * PK + d
//      gives the minimum and its smallest argmin in one reduction (the
//      TPU's packing);
//   3. one thread per pixel: the left-right check against the right-view
//      disparity at x - d0, which lies outside the pixel's own warp.
//
// K12: r3d_wta_finalize runs launches 2 and 3 alone on a given S. It
// replaces recon3d_tpu/depth/sgm_pallas.py:wta_finalize (kernel
// _mk_wta_kernel, pallas_call at sgm_pallas.py:537), the row-local finalize
// of the row-sharded path, whose paths are all aggregated before it. S is
// read only. Bound on the H100: bytes, reading S once (315 MB for a 1080p
// shard).
#include "sgm_scan.cuh"

namespace r3d {

constexpr float kPackLimit = 16777216.0f;  // 2^24: packed values stay exact
constexpr int kPixelsPerWarp = 8;

template <int K>
__global__ void __launch_bounds__(256) wta_kernel(
    const float* __restrict__ S, float* __restrict__ disp, int* __restrict__ d0_out,
    int* __restrict__ valid0, int* __restrict__ dR_out, int HP, int WP, int d_real,
    int w_real, float PK, int uniqueness_ratio, int do_subpixel, int lr_check) {
  constexpr int DP = 32 * K;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long npix = static_cast<long long>(HP) * WP;
  const float inv_pk = 1.0f / PK;
  const float clamp = kPackLimit / PK - 1.0f;
  for (int i = 0; i < kPixelsPerWarp; ++i) {
    const long long p = static_cast<long long>(warp) * kPixelsPerWarp + i;
    if (p >= npix) return;  // warp-uniform
    const int x = static_cast<int>(p % WP);
    const float* s = S + p * DP;
    float P[K];
    float mp = kPackLimit;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      P[k] = __fadd_rn(__fmul_rn(fminf(s[d], clamp), PK), static_cast<float>(d));
      mp = fminf(mp, P[k]);
    }
    mp = warp_min(mp);
    const float d0f = mp - floorf(mp * inv_pk) * PK;
    const float best = (mp - d0f) * inv_pk;
    const int d0 = static_cast<int>(d0f);

    float dv = d0f;
    if (do_subpixel) {
      const int d0c = min(max(d0, 1), d_real - 2);
      const float cm = fminf(s[d0c - 1], clamp);
      const float cp = fminf(s[d0c + 1], clamp);
      const float denom = fmaxf(__fsub_rn(__fadd_rn(cm, cp), 2.0f * best), 1e-6f);
      const float delta = fminf(fmaxf(__fdiv_rn(cm - cp, 2.0f * denom), -0.5f), 0.5f);
      if (d0 >= 1 && d0 <= d_real - 2) dv = __fadd_rn(static_cast<float>(d0c), delta);
    }

    bool ok = x >= d0;
    if (uniqueness_ratio > 0) {
      float ms = kPackLimit;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (abs(lane + 32 * k - d0) > 1) ms = fminf(ms, P[k]);
      ms = warp_min(ms);
      const float second = floorf(ms * inv_pk);
      ok = ok && (second * 100.0f > best * (100.0f + static_cast<float>(uniqueness_ratio)));
    }

    if (lr_check) {
      // right-view WTA at column x: min over d of S(x + d, d), same row
      float mr = kPackLimit;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane + 32 * k;
        if (x + d < w_real)
          mr = fminf(mr, __fadd_rn(__fmul_rn(fminf(S[(p + d) * DP + d], clamp), PK),
                                   static_cast<float>(d)));
      }
      mr = warp_min(mr);
      if (lane == 0) dR_out[p] = static_cast<int>(mr - floorf(mr * inv_pk) * PK);
    }
    if (lane == 0) {
      disp[p] = dv;
      d0_out[p] = d0;
      valid0[p] = ok ? 1 : 0;
    }
  }
}

__global__ void lr_check_kernel(const int* __restrict__ d0, const int* __restrict__ valid0,
                                const int* __restrict__ dR, int* __restrict__ valid,
                                long long npix, int max_diff, int lr_check) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  int ok = valid0[p];
  if (lr_check && ok) {  // ok implies x >= d0, so p - d0 stays in the row
    const int d = d0[p];
    ok = abs(d - dR[p - d]) <= max_diff;
  }
  valid[p] = ok;
}

// Launches 2 and 3 on S: disp (HP, WP) f32 and valid (HP, WP) int32; d0,
// valid0 and dR are (HP, WP) int32 scratch.
inline int launch_finalize(const float* S, float* disp, int* valid, int* d0, int* valid0,
                           int* dR, int HP, int WP, int DP, int d_real, int w_real,
                           int uniqueness_ratio, int max_diff, int do_subpixel,
                           cudaStream_t stream) {
  const long long npix = static_cast<long long>(HP) * WP;
  const int lr = max_diff >= 0;
  const float pk = static_cast<float>(DP);  // 1 << bit_length(DP - 1)
  const long long warps = (npix + kPixelsPerWarp - 1) / kPixelsPerWarp;
  const int blocks = static_cast<int>((warps * 32 + 255) / 256);
  if (DP == 128)
    wta_kernel<4><<<blocks, 256, 0, stream>>>(S, disp, d0, valid0, dR, HP, WP, d_real, w_real,
                                              pk, uniqueness_ratio, do_subpixel, lr);
  else
    wta_kernel<8><<<blocks, 256, 0, stream>>>(S, disp, d0, valid0, dR, HP, WP, d_real, w_real,
                                              pk, uniqueness_ratio, do_subpixel, lr);
  R3D_LAUNCH_CHECK();
  lr_check_kernel<<<static_cast<int>((npix + 255) / 256), 256, 0, stream>>>(
      d0, valid0, dR, valid, npix, max_diff, lr);
  R3D_LAUNCH_CHECK();
  return 0;
}

}  // namespace r3d

// cost (HP, WP, DP) int16; v (HP, WP, DP) f32 holds v3 and is overwritten
// with S. disp (HP, WP) f32 and valid (HP, WP) int32 are the outputs; d0,
// valid0 and dR are (HP, WP) int32 scratch. p1, p2 in x2 cost units;
// max_diff < 0 turns the left-right check off. Returns a cudaError_t code.
extern "C" int r3d_vfinalize(const int16_t* cost, float* v, float* disp, int* valid, int* d0,
                             int* valid0, int* dR, int HP, int WP, int DP, int d_real,
                             int w_real, float p1, float p2, int reverse, int uniqueness_ratio,
                             int max_diff, int do_subpixel, cudaStream_t stream) {
  if ((DP != 128 && DP != 256) || HP % r3d::kScanChunk != 0 || d_real < 3 || d_real > DP ||
      w_real > WP)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = r3d::launch_vscan(cost, v, HP, WP, DP, p1, p2, reverse, stream);
  if (err != 0) return err;
  return r3d::launch_finalize(v, disp, valid, d0, valid0, dR, HP, WP, DP, d_real, w_real,
                              uniqueness_ratio, max_diff, do_subpixel, stream);
}

// K12. S (HP, WP, DP) f32, read only; the other arguments as r3d_vfinalize's.
extern "C" int r3d_wta_finalize(const float* S, float* disp, int* valid, int* d0, int* valid0,
                                int* dR, int HP, int WP, int DP, int d_real, int w_real,
                                int uniqueness_ratio, int max_diff, int do_subpixel,
                                cudaStream_t stream) {
  if ((DP != 128 && DP != 256) || d_real < 3 || d_real > DP || w_real > WP)
    return static_cast<int>(cudaErrorInvalidValue);
  return r3d::launch_finalize(S, disp, valid, d0, valid0, dR, HP, WP, DP, d_real, w_real,
                              uniqueness_ratio, max_diff, do_subpixel, stream);
}
