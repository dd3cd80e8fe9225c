// K5: a diagonal pair of SGM paths accumulated in place onto the path volume.
//
// Replaces recon3d_tpu/depth/sgm_pallas.py:_mk_diag_down_kernel (pallas_call
// at sgm_pallas.py:1111), the downward pair of 8-direction mode: down-right,
// whose carry at (y, x) comes from (y - 1, x - 1), and down-left, from
// (y - 1, x + 1), both added onto v3. The same launcher, run bottom to top,
// adds the upward pair (from (y + 1, x -+ 1)), which the TPU fused into its
// finalize kernel's sweep (sgm_pallas.py:611-627); here it runs before K4,
// whose kernel is unchanged. Path values are integer-valued f32 and every
// partial sum stays below 2^24, so the order of the additions does not
// change a bit.
//
// The TPU swept full-width bands top to bottom with the two (W, D) carries
// shifted one column a row (_shift_cols, the entering column zeroed). Each
// diagonal line x - y = const (x + y = const for the other direction) is an
// independent scan, so here one warp owns one line: it enters at the first
// row or at the side column the path comes from, with the zero carry
// _shift_cols gives it, and walks to the last row or the far side. The scan
// step is sgm_scan.cuh's (d over the lanes, warp shuffles for d +- 1 and the
// min). Padded rows and columns hold zero cost, so a line that enters
// through them (the right padding, for the pair's right-to-left path) keeps
// a zero carry until it reaches the image, as the TPU's did.
//
// The two paths of a pair cross: both would read-modify-write v at the same
// (y, x). They run as two launches on one stream, one direction each, so the
// second starts after the first has finished, and within a launch every
// element belongs to exactly one line.
//
// Bound on the H100: bytes. A launch reads the cost (535 MB at 1080p /
// D = 128) and v (1.07 GB) and writes v back. Only HP + WP - 1 = 3007 lines
// are in flight, each up to 1088 dependent steps, so the scan's latency
// rather than its bytes is expected to set the time; loads of 8 steps are
// issued before their recurrence steps, as in the straight scans.
#include "sgm_scan.cuh"

namespace r3d {

template <int K>
__global__ void __launch_bounds__(128) diag_scan_kernel(
    const int16_t* __restrict__ cost, float* __restrict__ v, int HP, int WP, float p1,
    float p2, int dx, int reverse) {
  constexpr int DP = 32 * K;
  const int line = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (line >= HP + WP - 1) return;  // warp-uniform: whole warps leave together
  const int dy = reverse ? -1 : 1;
  const int first_row = reverse ? HP - 1 : 0;
  // lines 0 .. WP-1 enter at the first row, the rest at the side column
  int y0 = first_row, x0 = line;
  if (line >= WP) {
    y0 = first_row + dy * (line - WP + 1);
    x0 = dx > 0 ? 0 : WP - 1;
  }
  const int len = min(reverse ? y0 + 1 : HP - y0, dx > 0 ? WP - x0 : x0 + 1);
  const long long step = (static_cast<long long>(dy) * WP + dx) * DP;
  const long long base = (static_cast<long long>(y0) * WP + x0) * DP + lane * K;
  float carry[K];
#pragma unroll
  for (int k = 0; k < K; ++k) carry[k] = 0.0f;
  for (int s0 = 0; s0 < len; s0 += kScanChunk) {
    // issue the chunk's loads before its dependent recurrence steps; the
    // bound on s is the same for every lane of the warp
    float c[kScanChunk][K], a[kScanChunk][K];
#pragma unroll
    for (int j = 0; j < kScanChunk; ++j) {
      if (s0 + j < len) {
        const long long off = base + (s0 + j) * step;
        load_cost<K>(cost + off, c[j]);
        load_f32<K>(v + off, a[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kScanChunk; ++j) {
      if (s0 + j < len) {
        path_step<K>(carry, c[j], p1, p2, lane);
        float o[K];
#pragma unroll
        for (int k = 0; k < K; ++k) o[k] = carry[k] + a[j][k];
        store_f32<K>(v + base + (s0 + j) * step, o);
      }
    }
  }
}

}  // namespace r3d

// cost (HP, WP, DP) int16; v (HP, WP, DP) f32 updated in place with both
// diagonal paths of one vertical direction (reverse 0: the downward pair,
// 1: the upward pair). p1, p2 in x2 cost units. Returns a cudaError_t code.
extern "C" int r3d_diag_accumulate(const int16_t* cost, float* v, int HP, int WP, int DP,
                                   float p1, float p2, int reverse, cudaStream_t stream) {
  if ((DP != 128 && DP != 256) || HP < 1 || WP < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = ((HP + WP - 1) * 32 + 127) / 128;
  for (int dx = 1; dx >= -1; dx -= 2) {  // one launch per direction: the paths cross
    if (DP == 128)
      r3d::diag_scan_kernel<4><<<blocks, 128, 0, stream>>>(cost, v, HP, WP, p1, p2, dx, reverse);
    else
      r3d::diag_scan_kernel<8><<<blocks, 128, 0, stream>>>(cost, v, HP, WP, p1, p2, dx, reverse);
    R3D_LAUNCH_CHECK();
  }
  return 0;
}
