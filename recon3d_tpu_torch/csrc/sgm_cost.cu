// K2: cost volume + forward-horizontal path + downward path.
//
// Replaces recon3d_tpu/depth/sgm_pallas.py:cost_fwd_down (kernel body
// _mk_cost_fwd_kernel, pallas_call at sgm_pallas.py:985). Same function:
// the x2-scaled Birchfield-Tomasi cost on the six prefiltered planes, its
// block_size x block_size box sum, INVALID_COST on windows that touch an
// out-of-range sample and on padded disparity lanes, zero on padded rows
// and columns, stored as 16-bit; then v1 = L_fwd (+ L_down) in f32.
//
// Bound on the H100: bytes. At 1080p / D = 128 the step writes a
// (1088, 1920, 128) int16 cost (535 MB) and f32 v1 (1.07 GB), and the down
// path reads v1 back and writes it again. The TPU fused the three stages to
// keep the volume in VMEM; here they are three launches (cost, then the
// forward and downward scans of sgm_scan.cuh), simple first. The cost stage
// walks each row segment with one thread per disparity and keeps the
// window's 2r+1 column sums in a ring in shared memory, so each output reads
// 2r+1 plane samples per plane instead of (2r+1)^2. The sums run in the
// plain version's order (rows top to bottom, then columns left to right), so
// the cost matches it bitwise on any f32 input, integer or not.
//
// The stored costs are truncated to integers of at most 12800, so int16
// holds them and every path sum after them is exact; the scans widen them to
// f32 in registers.
#include "sgm_scan.cuh"

namespace r3d {

constexpr float kInvalidCost = 12800.0f;  // sgm_pallas.INVALID_COST
constexpr int kCostTile = 64;             // columns per block
constexpr int kMaxBlock = 11;             // largest block_size (config.py)

__global__ void __launch_bounds__(256) cost_kernel(
    const float* __restrict__ lv, const float* __restrict__ llo, const float* __restrict__ lhi,
    const float* __restrict__ rv, const float* __restrict__ rlo, const float* __restrict__ rhi,
    int16_t* __restrict__ cost, int H, int W, int WP, int DP, int d_real, int block_size,
    int min_disp) {
  __shared__ float ring[kMaxBlock * 256];  // column sums, one ring per disparity
  const int d = threadIdx.x;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kCostTile;
  const int r = block_size / 2;
  int16_t* out = cost + (static_cast<long long>(y) * WP + x0) * DP + d;

  if (y >= H || d >= d_real) {
    const int16_t fill = (y >= H) ? 0 : static_cast<int16_t>(kInvalidCost);
    for (int i = 0; i < kCostTile; ++i) {
      const int x = x0 + i;
      out[static_cast<long long>(i) * DP] = (x >= W) ? 0 : fill;
    }
    return;
  }

  // x2 BT cost of the box column at image column xx (edge-replicated),
  // summed over the window's rows (edge-replicated). Out-of-range samples
  // count 0; every window touching one is replaced by kInvalidCost below.
  auto column = [&](int xx) -> float {
    xx = min(max(xx, 0), W - 1);
    const int xr = xx - min_disp - d;
    if (xr < 0) return 0.0f;
    float s = 0.0f;
    for (int dy = -r; dy <= r; ++dy) {
      const long long row = static_cast<long long>(min(max(y + dy, 0), H - 1)) * W;
      const float L = 2.0f * lv[row + xx], Llo = 2.0f * llo[row + xx], Lhi = 2.0f * lhi[row + xx];
      const float R = 2.0f * rv[row + xr], Rlo = 2.0f * rlo[row + xr], Rhi = 2.0f * rhi[row + xr];
      const float c_ltr = fmaxf(0.0f, fmaxf(L - Rhi, Rlo - L));
      const float c_rtl = fmaxf(0.0f, fmaxf(R - Lhi, Llo - R));
      s += fminf(c_ltr, c_rtl);
    }
    return s;
  };

  // ring slot of image column c is (c - (x0 - r)) mod block_size; `first`
  // is the slot of the window's first column x - r
  for (int t = 0; t < block_size; ++t) ring[t * 256 + d] = column(x0 - r + t);
  int first = 0;
  for (int i = 0; i < kCostTile; ++i) {
    const int x = x0 + i;
    if (i > 0) {  // slide the window: column x + r takes the slot of column x - r - 1
      ring[first * 256 + d] = column(x + r);
      first = first + 1 == block_size ? 0 : first + 1;
    }
    // the window's column sums added left to right, as the plain version's
    // box does: on non-integer gray levels (a warped pair) a rolling
    // add-and-subtract would round differently and move the truncated cost
    int slot = first;
    float c = ring[slot * 256 + d];
    for (int t = 1; t < block_size; ++t) {
      slot = slot + 1 == block_size ? 0 : slot + 1;
      c += ring[slot * 256 + d];
    }
    if (x < min_disp + d + r) c = kInvalidCost;
    if (x >= W) c = 0.0f;
    out[static_cast<long long>(i) * DP] = static_cast<int16_t>(c);
  }
}

}  // namespace r3d

// Planes are (H, W) f32 prefiltered values and BT bounds (unscaled);
// cost is (HP, WP, DP) int16, v1 (HP, WP, DP) f32, both written whole.
// p1, p2 are in x2 cost units. Returns a cudaError_t code, 0 on success.
extern "C" int r3d_cost_fwd_down(const float* lv, const float* llo, const float* lhi,
                                 const float* rv, const float* rlo, const float* rhi,
                                 int16_t* cost, float* v1, int H, int W, int HP, int WP, int DP,
                                 int d_real, int block_size, int min_disp, float p1, float p2,
                                 int with_down, cudaStream_t stream) {
  if ((DP != 128 && DP != 256) || WP % r3d::kCostTile != 0 || HP % r3d::kScanChunk != 0 ||
      block_size < 1 || block_size > r3d::kMaxBlock || H > HP || W > WP)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(WP / r3d::kCostTile, HP);
  r3d::cost_kernel<<<grid, DP, 0, stream>>>(lv, llo, lhi, rv, rlo, rhi, cost, H, W, WP, DP,
                                            d_real, block_size, min_disp);
  R3D_LAUNCH_CHECK();
  int err = r3d::launch_hscan(cost, nullptr, v1, HP, WP, DP, p1, p2, 0, stream);
  if (err != 0 || !with_down) return err;
  return r3d::launch_vscan(cost, v1, HP, WP, DP, p1, p2, 0, stream);
}
