// K5 and K11: a diagonal pair of SGM paths added onto the path volume in one
// pass, on a whole frame (K5) or on one row shard with relayed carry planes
// (K11).
//
// K5 replaces recon3d_tpu/depth/sgm_pallas.py:_mk_diag_down_kernel
// (pallas_call at sgm_pallas.py:1111), the downward pair of 8-direction
// mode: down-right, whose carry at (y, x) comes from (y - 1, x - 1), and
// down-left, from (y - 1, x + 1), both added onto v3. The same launcher, run
// bottom to top, adds the upward pair (from (y + 1, x -+ 1)), which the TPU
// fused into its finalize kernel's sweep (sgm_pallas.py:611-627); here it
// runs before K4, whose kernel is unchanged. K11 replaces
// sgm_pallas.py:diag_carry (kernel _mk_diag_io_kernel, pallas_call at
// sgm_pallas.py:343): the same pair on one shard's (HP, WP, DP) volumes,
// entering with the neighbouring shard's (2, WP, DP) carries and handing
// its own on:
//   down  the carries entering row 0 are carry_in, shifted one column, and
//         carry_out holds the carries after row h_real - 1;
//   up    the rows below h_real - 1 are swept first from zero carries, the
//         carries entering row h_real - 1 are REPLACED by carry_in, shifted,
//         and carry_out holds the carries after row 0.
// Plane 0 is the path from x - 1, plane 1 the path from x + 1.
//
// Walkers on a helix. The TPU swept full-width bands with the two (W, D)
// carries shifted one column a row (_shift_cols, the entering column
// zeroed). Here a walker of the path from x - 1 starts at column x0 of the
// first row and, at step s, is at x = (x0 + s) mod WP; where it wraps from
// WP - 1 to 0 its carry restarts from zero, which is exactly the column
// _shift_cols zeroes. The path from x + 1 walks x = (x0 - s) mod WP and
// restarts where it wraps to WP - 1. So WP walkers a direction walk all HP
// rows one row a step, all of them on the same rows, and one warp carries
// one walker of each direction, a chunk of 8 steps (4 at D = 256) of one,
// then of the other (D over the lanes, the recurrence sgm_scan.cuh's
// path_step). At 1080p that is 1920 warps, all resident at once (four
// blocks of four warps a SM need at most 128 registers a thread, which
// __launch_bounds__ holds them to, at D = 256 too).
//
// One pass over v, which is never loaded. The two paths cross, so each
// walker adds its path row into v[y, x] with a reduction performed in L2:
// a float4 atomicAdd a lane, whose result is unused, so it compiles to one
// red.global.add.v4.f32 (sm_90). The two additions to an element arrive
// within a chunk of each other, while its row is in the 50 MB L2 (about 34
// rows of v and cost at 1080p): device memory sees v read once and written
// once, and the second walker's cost read mostly hits L2. The vector
// reductions need 16-byte aligned addresses: rows are DP floats apart, a
// lane's K floats start at lane * K, a multiple of 4, and the wrapper
// checks that v starts on a 16-byte boundary.
//
// Why an unordered sum is still exact and the same from run to run: every
// path value is an integer-valued f32 (int16 costs, penalties that are
// whole numbers of x2 cost units, which the wrapper checks) and every
// partial sum stays below 2^24 (eight paths at the accurate preset: 8 x
// (12800 + 2 x 3200) = 153,600), so additions in any order give the same
// bits as the plain version's v + L_a + L_b.
//
// Bound on the H100: bytes. A call must read the cost (535 MB at 1080p /
// D = 128; 157 MB on a (320, 1920, 128) shard) and v (1.07 GB / 315 MB)
// and write v: 2.67 GB, 0.80 ms at 3.35 TB/s. What sets the time is the
// L2's reduction rate. Running one walker's chunk, then the other's, took
// K5 from 2.1 ms (both walkers' steps interleaved) to 1.35 ms on the H100;
// tools/bench_diag_variants.py measures this design against the others
// tried: TMA bulk reductions from shared memory, scalar atomics, the
// interleaved walkers, one direction a launch, and a b-walker that waits on
// flags for the a-walkers and adds with a plain read-modify-write.
#include "sgm_scan.cuh"

namespace r3d {

constexpr int kDiagThreads = 128;

// steps whose cost loads are issued together before their recurrence
template <int K>
__host__ __device__ constexpr int diag_chunk() {
  return K == 4 ? 8 : 4;
}

template <int K>
__device__ __forceinline__ void red_add(float* p, const float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; k += 4)
    atomicAdd(reinterpret_cast<float4*>(p + k), make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
}

template <int K>
__device__ __forceinline__ void zero(float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.0f;
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
// t0: v[y, x] += its path row, reduced in L2.
template <int K, int CH>
__device__ __forceinline__ void walk_chunk(const DiagPass& a, float (&carry)[K], int& x, int dx,
                                           long long plane, int t0, int lane) {
  constexpr int DP = 32 * K;
  float c[CH][K];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    int xj = x + dx * j;  // j < CH <= WP: at most one wrap
    xj += xj >= a.WP ? -a.WP : (xj < 0 ? a.WP : 0);
    load_cost<K>(
        a.cost + (static_cast<long long>(a.y0 + a.dy * (t0 + j)) * a.WP + xj) * DP + lane * K,
        c[j]);
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
    red_add<K>(a.v + (static_cast<long long>(y) * a.WP + x) * DP + lane * K, carry);
    if (a.carry_out != nullptr && y == a.snap_row)
      store_f32<K>(a.carry_out + plane + static_cast<long long>(x) * DP + lane * K, carry);
    x += dx;
    x += x == a.WP ? -a.WP : (x < 0 ? a.WP : 0);
  }
}

template <int K>
__global__ void __launch_bounds__(kDiagThreads, 4) diag_pair_kernel(
    const int16_t* __restrict__ cost, float* __restrict__ v, const float* __restrict__ carry_in,
    float* __restrict__ carry_out, int HP, int WP, float p1, float p2, int reverse, int h_last) {
  constexpr int CH = diag_chunk<K>();
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= WP) return;  // warp-uniform: whole warps leave together
  const DiagPass a{cost, v, carry_in, carry_out, WP, reverse ? HP - 1 : 0, reverse ? -1 : 1,
                   reverse ? h_last : 0, reverse ? 0 : h_last, p1, p2};
  const long long plane = static_cast<long long>(WP) * 32 * K;
  float ca[K], cb[K];  // the path from x - 1 (plane 0) and from x + 1 (plane 1)
  zero<K>(ca);
  zero<K>(cb);
  int xa = w, xb = w;
  for (int s0 = 0; s0 < HP; s0 += CH) {  // HP is a multiple of CH
    walk_chunk<K, CH>(a, ca, xa, 1, 0, s0, lane);
    walk_chunk<K, CH>(a, cb, xb, -1, plane, s0, lane);
  }
}

inline int launch_diag_pair(const int16_t* cost, float* v, const float* carry_in,
                            float* carry_out, int HP, int WP, int DP, float p1, float p2,
                            int reverse, int h_real, cudaStream_t stream) {
  if ((DP != 128 && DP != 256) || HP < 1 || HP % 8 != 0 || WP < 8 || h_real < 1 ||
      h_real > HP)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (WP * 32 + kDiagThreads - 1) / kDiagThreads;
  if (DP == 128)
    diag_pair_kernel<4><<<blocks, kDiagThreads, 0, stream>>>(cost, v, carry_in, carry_out, HP,
                                                             WP, p1, p2, reverse, h_real - 1);
  else
    diag_pair_kernel<8><<<blocks, kDiagThreads, 0, stream>>>(cost, v, carry_in, carry_out, HP,
                                                             WP, p1, p2, reverse, h_real - 1);
  R3D_LAUNCH_CHECK();
  return 0;
}

}  // namespace r3d

// K5. cost (HP, WP, DP) int16; v (HP, WP, DP) f32 updated in place with both
// diagonal paths of one vertical direction (reverse 0: the downward pair,
// 1: the upward pair). p1, p2 in x2 cost units. Returns a cudaError_t code.
extern "C" int r3d_diag_accumulate(const int16_t* cost, float* v, int HP, int WP, int DP,
                                   float p1, float p2, int reverse, cudaStream_t stream) {
  return r3d::launch_diag_pair(cost, v, nullptr, nullptr, HP, WP, DP, p1, p2, reverse, HP,
                               stream);
}

// K11. As K5 on one shard, in place on v, with (2, WP, DP) f32 carries in and
// out (distinct buffers) and the shard's real rows h_real.
extern "C" int r3d_diag_carry(const int16_t* cost, float* v, const float* carry_in,
                              float* carry_out, int HP, int WP, int DP, float p1, float p2,
                              int reverse, int h_real, cudaStream_t stream) {
  return r3d::launch_diag_pair(cost, v, carry_in, carry_out, HP, WP, DP, p1, p2, reverse, h_real,
                               stream);
}
