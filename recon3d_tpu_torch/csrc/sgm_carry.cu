// K10: one row shard's vertical path with a relayed carry plane in and out.
//
// Replaces recon3d_tpu/depth/sgm_pallas.py:vscan_carry (kernel
// _mk_vscan_io_kernel, pallas_call at sgm_pallas.py:385), a building block
// of the row-sharded relay (recon3d_tpu/depth/sgm_sharded.py). Same
// function: out = acc + L over a shard's (HP, WP, DP) volumes, where the
// path enters the shard with the neighbouring shard's carry and hands its
// own on:
//   down  the carry entering row 0 is carry_in, and carry_out is the carry
//         after row h_real - 1, the shard's last real row; the rows below it
//         go on from there;
//   up    the rows below h_real - 1 are swept first from a zero carry, the
//         carry entering row h_real - 1 is REPLACED by carry_in, and
//         carry_out is the carry after row 0.
// Every row is written, the dead ones past h_real too. The diagonal pair of
// the same relay (K11) is csrc/sgm_diag.cu's one-pass kernel.
//
// The design is the port's per-line scan (sgm_scan.cuh): one warp owns one
// line, with D over the lanes. The scan takes a column shift dx (a diagonal
// line's carry comes from (y -+ 1, x - dx), with carry_in[x - dx] at the
// entry row and zero where x - dx leaves the image); K10 runs it with
// dx = 0 (a copy written for dx = 0 alone measured slower on the H100).
//
// Bound on the H100: bytes. A call reads the cost (157 MB for a 1080p
// shard, (320, 1920, 128) int16) and acc (315 MB) and writes out over acc;
// the carry planes are 1 MB each. The scan's dependent steps (320 a line)
// are expected to set the time, as in the straight scans.
#include "sgm_scan.cuh"

namespace r3d {

template <int K>
__global__ void __launch_bounds__(128) carry_scan_kernel(
    const int16_t* __restrict__ cost, float* __restrict__ v,
    const float* __restrict__ carry_in, float* __restrict__ carry_out, int HP, int WP,
    float p1, float p2, int dx, int reverse, int h_last) {
  constexpr int DP = 32 * K;
  const int line = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (line >= (dx == 0 ? WP : HP + WP - 1)) return;  // warp-uniform
  const int dy = reverse ? -1 : 1;
  const int first_row = reverse ? HP - 1 : 0;
  // lines 0 .. WP-1 enter at the first row, the rest at the side column
  int y0 = first_row, x0 = line;
  if (line >= WP) {
    y0 = first_row + dy * (line - WP + 1);
    x0 = dx > 0 ? 0 : WP - 1;
  }
  const int rows = reverse ? y0 + 1 : HP - y0;
  const int len = dx == 0 ? rows : min(rows, dx > 0 ? WP - x0 : x0 + 1);
  const int entry_row = reverse ? h_last : 0;  // where carry_in enters
  const int snap_row = reverse ? 0 : h_last;   // whose carry goes out
  const long long step = (static_cast<long long>(dy) * WP + dx) * DP;
  const long long base = (static_cast<long long>(y0) * WP + x0) * DP + lane * K;
  float carry[K];
#pragma unroll
  for (int k = 0; k < K; ++k) carry[k] = 0.0f;
  for (int s0 = 0; s0 < len; s0 += kScanChunk) {
    // issue the chunk's loads before its dependent recurrence steps; every
    // condition below is the same for all lanes of the warp
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
      const int s = s0 + j;
      if (s < len) {
        const int y = y0 + dy * s;
        const int x = x0 + dx * s;
        if (y == entry_row) {
          const int xs = x - dx;
          if (xs >= 0 && xs < WP) {
            load_f32<K>(carry_in + static_cast<long long>(xs) * DP + lane * K, carry);
          } else {
#pragma unroll
            for (int k = 0; k < K; ++k) carry[k] = 0.0f;
          }
        }
        path_step<K>(carry, c[j], p1, p2, lane);
        float o[K];
#pragma unroll
        for (int k = 0; k < K; ++k) o[k] = carry[k] + a[j][k];
        store_f32<K>(v + base + s * step, o);
        if (y == snap_row)
          store_f32<K>(carry_out + static_cast<long long>(x) * DP + lane * K, carry);
      }
    }
  }
}

inline int launch_carry_scan(const int16_t* cost, float* v, const float* carry_in,
                             float* carry_out, int HP, int WP, int DP, float p1, float p2,
                             int dx, int reverse, int h_real, cudaStream_t stream) {
  if ((DP != 128 && DP != 256) || HP < 1 || WP < 1 || h_real < 1 || h_real > HP)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lines = dx == 0 ? WP : HP + WP - 1;
  const int blocks = (lines * 32 + 127) / 128;
  if (DP == 128)
    carry_scan_kernel<4><<<blocks, 128, 0, stream>>>(cost, v, carry_in, carry_out, HP, WP, p1,
                                                     p2, dx, reverse, h_real - 1);
  else
    carry_scan_kernel<8><<<blocks, 128, 0, stream>>>(cost, v, carry_in, carry_out, HP, WP, p1,
                                                     p2, dx, reverse, h_real - 1);
  R3D_LAUNCH_CHECK();
  return 0;
}

}  // namespace r3d

// K10. cost (HP, WP, DP) int16; v (HP, WP, DP) f32 holds acc and is
// overwritten with acc + L_vert; carry_in, carry_out (WP, DP) f32, distinct
// buffers. reverse 0: the downward path, 1: the upward path. p1, p2 in x2
// cost units. Returns a cudaError_t code.
extern "C" int r3d_vscan_carry(const int16_t* cost, float* v, const float* carry_in,
                               float* carry_out, int HP, int WP, int DP, float p1, float p2,
                               int reverse, int h_real, cudaStream_t stream) {
  return r3d::launch_carry_scan(cost, v, carry_in, carry_out, HP, WP, DP, p1, p2, 0, reverse,
                                h_real, stream);
}
