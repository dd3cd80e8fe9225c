// K2: cost volume + forward-horizontal path + downward path.
//
// Replaces recon3d_tpu/depth/sgm_pallas.py:cost_fwd_down (kernel body
// _mk_cost_fwd_kernel, pallas_call at sgm_pallas.py:985). Same function:
// the x2-scaled Birchfield-Tomasi cost on the six prefiltered planes, its
// block_size x block_size box sum, INVALID_COST on windows that touch an
// out-of-range sample and on padded disparity lanes, zero on padded rows
// and columns, stored as 16-bit; then v1 = L_fwd (+ L_down) in f32.
//
// Bound on the H100: bytes for the function (the six planes in, cost and
// v1 out once: 0.49 ms at 1080p / D = 128), ~4.3 GB for this two-launch
// design (1.29 ms at 3.35 TB/s): the walk writes the int16 cost (535 MB)
// and L_down into v1 (1.07 GB), and the forward scan reads both and writes
// v1 (2.67 GB). The TPU fused all three stages in VMEM. The forward scan
// runs near the memory rate; the walk is bound by its instructions and its
// shared-memory traffic (the BT cost of every column and disparity, the
// column sums read back by every window), a barrier a row, not its bytes.
//
// 1. The walk (cost_walk_kernel) computes the cost once per pixel and runs
//    the downward path in the same pass. A block owns a strip of S output
//    columns and walks down all rows. Warp w evaluates column x0 - r + w
//    (the strip plus r halo columns on each side, evaluated again by the
//    neighbouring blocks): each row it computes the BT cost of the row
//    entering the window once, keeps the last block_size rows' values in a
//    register ring and forms their column sum in the plain version's order
//    (rows y-r .. y+r top to bottom, the image's first and last rows
//    standing in for the rows beyond them). After one barrier a row, the
//    warps of the S output columns add block_size column sums left to right
//    (never a running add-and-subtract: on non-integer gray that rounds
//    otherwise), store the row's int16 cost and take one step of the
//    downward path on it (sgm_scan.cuh's path_step, d over the lanes), which
//    they write to v1. Each row's six plane segments (the strip and its
//    halo, plus the D-column reach of the right view) are prefetched into
//    registers two rows ahead and staged in shared memory one row ahead.
// 2. One forward scan (sgm_scan.cuh's launch_hscan) adds L_fwd onto v1.
//    IEEE addition commutes, so L_fwd + L_down has the plain version's
//    bits. Without the downward path (the row-sharded frame, whose vertical
//    paths are relayed) the walk writes no v1 and the scan writes L_fwd.
//
// The stored costs are truncated to integers of at most 12800, so int16
// holds them and every path sum after them is exact. sgm_scan.cu (K14)
// still shares sgm_scan.cuh's launch_hscan with K2's forward scan and K3.
#include <type_traits>

#include "sgm_scan.cuh"

namespace r3d {

constexpr float kInvalidCost = 12800.0f;  // sgm_pallas.INVALID_COST
constexpr int kMaxBlock = 11;             // largest block_size (config.py)

// The walk's geometry at D = 32 K and an odd block size BS.
template <int K, int BS>
struct Walk {
  static constexpr int DP = 32 * K;
  static constexpr int R = BS / 2;
  static constexpr int S = K == 4 ? 16 : 8;   // output columns of a block
  static constexpr int NC = S + 2 * R;        // columns evaluated: one warp each
  static constexpr int NR = NC + DP - 1;      // right-view columns they reach
  static constexpr int NSTAGE = 3 * NC + 3 * NR;  // staged floats of one row
  static constexpr int THREADS = 32 * NC;
  static constexpr int PER = (NSTAGE + THREADS - 1) / THREADS;  // staged floats a thread
};

template <int K, int BS>
__global__ void __launch_bounds__(Walk<K, BS>::THREADS) cost_walk_kernel(
    const float* __restrict__ lv, const float* __restrict__ llo, const float* __restrict__ lhi,
    const float* __restrict__ rv, const float* __restrict__ rlo, const float* __restrict__ rhi,
    int16_t* __restrict__ cost, float* __restrict__ v1, int H, int W, int HP, int WP,
    int d_real, int min_disp, float p1, float p2) {
  using G = Walk<K, BS>;
  constexpr int R = G::R, NC = G::NC, NR = G::NR, DP = G::DP, PER = G::PER;
  __shared__ float rows[2][G::NSTAGE];           // doubled plane segments of one row
  __shared__ __align__(16) float csum[2][NC][DP];  // column sums of one row
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int x0 = blockIdx.x * G::S;
  const int lbase = x0 - R;                      // image column of staged left column 0
  const int rbase = x0 - R - min_disp - DP + 1;  // and of staged right column 0

  // This thread's staged floats: [left v, lo, hi: NC each][right v, lo, hi:
  // NR each], at edge-clamped columns.
  const float* src[PER];
  int slot[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = tid + e * G::THREADS;
    slot[e] = i < G::NSTAGE ? i : -1;
    const int left = i < 3 * NC, j = left ? i : i - 3 * NC, n = left ? NC : NR;
    const float* plane = left ? (j < NC ? lv : j < 2 * NC ? llo : lhi)
                              : (j < NR ? rv : j < 2 * NR ? rlo : rhi);
    src[e] = plane + min(max((left ? lbase : rbase) + j % n, 0), W - 1);
  }
  float pre[PER];
  auto fetch = [&](int s) {  // the plane row step s evaluates: y = s + r, clamped
    const long long row = static_cast<long long>(min(max(s + R, 0), H - 1)) * W;
#pragma unroll
    for (int e = 0; e < PER; ++e) pre[e] = slot[e] >= 0 ? __ldg(src[e] + row) : 0.0f;
  };
  auto put = [&](int b) {
#pragma unroll
    for (int e = 0; e < PER; ++e)
      if (slot[e] >= 0) rows[b][slot[e]] = 2.0f * pre[e];
  };

  // step s evaluates row s + r into the ring and, from s = 0 on, outputs
  // row s; the first 2r steps fill the ring with the rows above row r
  const int s0 = -2 * R;
  fetch(s0);
  put(0);
  if (s0 + 1 < H) fetch(s0 + 1);
  __syncthreads();

  const int cc = min(max(lbase + w, 0), W - 1);  // this warp's column, edge-clamped
  const bool live = cc >= lbase;  // false only in a strip wholly right of the image
  // staged right-view index of (cc, d = 0): the sample at cc - min_disp - d
  // is Rv[jw - d]
  const int jw = (live ? cc : lbase) - min_disp - rbase;
  float ring[BS][K];
#pragma unroll
  for (int t = 0; t < BS; ++t)
#pragma unroll
    for (int k = 0; k < K; ++k) ring[t][k] = 0.0f;
  const int x = x0 + w;
  const bool writes = w < G::S && x < WP;
  const int dk = K * lane;  // the output layout: lane l holds d = K l .. K l + K - 1
  float carry[K];
#pragma unroll
  for (int k = 0; k < K; ++k) carry[k] = 0.0f;

#pragma unroll BS  // the ring's shifts then cost no moves
  for (int s = s0, b = 0; s < HP; ++s, b ^= 1) {
    if (s < H) {
      // x2 BT cost of (row s + r, column cc, d = lane + 32 k); out-of-range
      // samples count 0 (every window touching one is INVALID below)
      const float* rw = rows[b];
      const float L = rw[w], Llo = rw[NC + w], Lhi = rw[2 * NC + w];
      const float* Rv = rw + 3 * NC;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane + 32 * k;
        const int j = jw - d;  // in range for every d, so no lane branches
        const float Rr = Rv[j], Rlo = Rv[NR + j], Rhi = Rv[2 * NR + j];
        const float c_ltr = fmaxf(0.0f, fmaxf(L - Rhi, Rlo - L));
        const float c_rtl = fmaxf(0.0f, fmaxf(Rr - Lhi, Llo - Rr));
        const float v = live && cc - min_disp - d >= 0 ? fminf(c_ltr, c_rtl) : 0.0f;
#pragma unroll
        for (int t = 0; t + 1 < BS; ++t) ring[t][k] = ring[t + 1][k];
        ring[BS - 1][k] = v;
        float sum = ring[0][k];
#pragma unroll
        for (int t = 1; t < BS; ++t) sum = __fadd_rn(sum, ring[t][k]);
        csum[b][w][d] = sum;
      }
      if (s + 1 < H) put(b ^ 1);
      if (s + 2 < H) fetch(s + 2);
    }
    __syncthreads();
    if (s >= 0 && writes) {  // warp-uniform: the path step's shuffles see all lanes
      float c[K];
      if (s >= H || x >= W) {
#pragma unroll
        for (int k = 0; k < K; ++k) c[k] = 0.0f;
      } else {
        load_f32<K>(&csum[b][w][dk], c);
#pragma unroll
        for (int t = 1; t < BS; ++t) {
          float n[K];
          load_f32<K>(&csum[b][w + t][dk], n);
#pragma unroll
          for (int k = 0; k < K; ++k) c[k] = __fadd_rn(c[k], n[k]);
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (dk + k >= d_real || x < min_disp + dk + k + R) c[k] = kInvalidCost;
      }
      const long long off = (static_cast<long long>(s) * WP + x) * DP + dk;
      short q[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        q[k] = static_cast<int16_t>(c[k]);
        c[k] = q[k];
      }
      if constexpr (K == 4) {
        *reinterpret_cast<short4*>(cost + off) = make_short4(q[0], q[1], q[2], q[3]);
      } else {
        int4 v;
        short* p = reinterpret_cast<short*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k] = q[k];
        *reinterpret_cast<int4*>(cost + off) = v;
      }
      if (v1 != nullptr) {
        path_step<K>(carry, c, p1, p2, lane);
        store_f32<K>(v1 + off, carry);
      }
    }
  }
}

template <int K, int BS>
int launch_walk(const float* const* planes, int16_t* cost, float* v1, int H, int W, int HP,
                int WP, int d_real, int min_disp, float p1, float p2, cudaStream_t stream) {
  using G = Walk<K, BS>;
  cost_walk_kernel<K, BS><<<(WP + G::S - 1) / G::S, G::THREADS, 0, stream>>>(
      planes[0], planes[1], planes[2], planes[3], planes[4], planes[5], cost, v1, H, W, HP, WP,
      d_real, min_disp, p1, p2);
  R3D_LAUNCH_CHECK();
  return 0;
}

template <int K>
int launch_walk(const float* const* planes, int16_t* cost, float* v1, int H, int W, int HP,
                int WP, int d_real, int block_size, int min_disp, float p1, float p2,
                cudaStream_t stream) {
  auto launch = [&](auto bs) {
    return launch_walk<K, decltype(bs)::value>(planes, cost, v1, H, W, HP, WP, d_real,
                                               min_disp, p1, p2, stream);
  };
  switch (block_size) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 3: return launch(std::integral_constant<int, 3>{});
    case 5: return launch(std::integral_constant<int, 5>{});
    case 7: return launch(std::integral_constant<int, 7>{});
    case 9: return launch(std::integral_constant<int, 9>{});
    case 11: return launch(std::integral_constant<int, 11>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace r3d

// Stage 1, the walk: cost (HP, WP, DP) int16 written whole and, with
// with_down, v1 = L_down (HP, WP, DP) f32 (v1 is not touched without it).
// Planes are (H, W) f32 prefiltered values and BT bounds (unscaled);
// block_size is odd in [1, 11]; p1, p2 are in x2 cost units. Returns a
// cudaError_t code, 0 on success.
extern "C" int r3d_cost_walk(const float* lv, const float* llo, const float* lhi,
                             const float* rv, const float* rlo, const float* rhi, int16_t* cost,
                             float* v1, int H, int W, int HP, int WP, int DP, int d_real,
                             int block_size, int min_disp, float p1, float p2, int with_down,
                             cudaStream_t stream) {
  if ((DP != 128 && DP != 256) || block_size < 1 || block_size > r3d::kMaxBlock ||
      block_size % 2 == 0 || H < 1 || W < 1 || H > HP || W > WP || min_disp < 0 ||
      d_real < 1 || d_real > DP)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* planes[6] = {lv, llo, lhi, rv, rlo, rhi};
  float* down = with_down ? v1 : nullptr;
  if (DP == 128)
    return r3d::launch_walk<4>(planes, cost, down, H, W, HP, WP, d_real, block_size, min_disp,
                               p1, p2, stream);
  return r3d::launch_walk<8>(planes, cost, down, H, W, HP, WP, d_real, block_size, min_disp, p1,
                             p2, stream);
}

// Stage 2, the forward scan: v1 = L_fwd + v1 with with_down (v1 holds
// L_down), else v1 = L_fwd.
extern "C" int r3d_cost_fwd(const int16_t* cost, float* v1, int HP, int WP, int DP, float p1,
                            float p2, int with_down, cudaStream_t stream) {
  if ((DP != 128 && DP != 256) || WP % r3d::kScanChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return r3d::launch_hscan(cost, with_down ? v1 : nullptr, v1, HP, WP, DP, p1, p2, 0, stream);
}

// Both stages: cost (HP, WP, DP) int16 and v1 = L_fwd (+ L_down) f32, both
// written whole.
extern "C" int r3d_cost_fwd_down(const float* lv, const float* llo, const float* lhi,
                                 const float* rv, const float* rlo, const float* rhi,
                                 int16_t* cost, float* v1, int H, int W, int HP, int WP, int DP,
                                 int d_real, int block_size, int min_disp, float p1, float p2,
                                 int with_down, cudaStream_t stream) {
  if (WP % r3d::kScanChunk != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = r3d_cost_walk(lv, llo, lhi, rv, rlo, rhi, cost, v1, H, W, HP, WP, DP, d_real,
                                block_size, min_disp, p1, p2, with_down, stream);
  if (err != 0) return err;
  return r3d_cost_fwd(cost, v1, HP, WP, DP, p1, p2, with_down, stream);
}
