// K4: last vertical SGM path fused with the WTA finalize. K12: the same
// finalize of a given S.
//
// K4 replaces recon3d_tpu/depth/sgm_pallas.py:aggregate_and_finalize's fused
// vertical-scan + finalize (kernel body _mk_vfinalize_kernel with
// _finalize_body, pallas_call at sgm_pallas.py:1135). K12 replaces
// recon3d_tpu/depth/sgm_pallas.py:wta_finalize (kernel _mk_wta_kernel,
// pallas_call at sgm_pallas.py:537), the row-local finalize of the
// row-sharded path, whose paths are all aggregated before it. Same function:
// S = v3 + L_up (L_down in 3-direction mode; K12 is given S); per pixel the
// WTA disparity with ties to the smallest d, parabolic subpixel, the
// uniqueness ratio, the right-view WTA over S_R(x, d) = S(x + d, d) for
// x + d < w_real and the left-right check against dR(x - d0). A min of
// cost * PK + d gives the minimum and its smallest argmin in one value (the
// TPU's packing); every packed value is an integer below 2^24, so the
// arithmetic is exact and the kernels agree bitwise with their plain
// versions.
//
// Bound on the H100: bytes. K4 must read the int16 cost (535 MB at 1080p /
// D = 128) and v3 (1.07 GB) once: 0.48 ms. K12 must read S once (315 MB for
// a 1080p shard): 0.095 ms. The TPU kept each band of S in VMEM and
// finalized it as the scan produced it; here S never reaches device memory
// either, and v3 is read only.
//
// Design. A block owns kFinCols = 16 consecutive columns, one warp each (at
// 1920 columns 120 blocks of 512 threads, one a SM), and walks the rows in
// chunks of R rows (8 at D = 128, 4 at D = 256), bottom to top for "up", top
// to bottom for "down". Two feeders put a chunk's S rows into a
// shared-memory tile (R x 16 x DP floats, double-buffered, 128 KB):
//   ScanFeed (K4): each warp runs its column's path with the carry in
//     registers (sgm_scan.cuh's path_step), adding v3, and stores the rows;
//   MemFeed (K12): each warp copies its column's rows of S, coalesced; the
//     rows are independent, so gridDim.y splits them over more blocks.
// Both load the next chunk into registers before the block finalizes the
// current tile, so device reads stay in flight through the finalize. One
// device function, finalize_tile, then serves both:
//   - the left view, local to a pixel: 8 threads a pixel, each reading 4K
//     of its DP values from the tile (8 threads cover 128 contiguous bytes:
//     no bank conflict), packing them once (d as a float offset: no integer
//     conversion), the min and the second min combined over the 8 with three
//     shuffles each; subpixel from the tile; disp and, in `valid`, d0 where
//     the pixel passed (x >= d0, uniqueness) or -1. The packed values P go
//     back into the tile over S;
//   - the right view, which needs other blocks' columns: for each row and
//     each target x in [c0 - DP + 1, c0 + 15] one thread takes the min of
//     P(x + d, d) over the block's columns (the tile's diagonal, unrolled
//     and masked: consecutive targets read consecutive words), then merges
//     it into an (HP, WP) plane with one integer atomicMin per target, ~9 a
//     pixel, not one per (x, d). A min over the packed values, as their
//     non-negative int32 bits, is order free; the plane starts above every
//     packed value (bytes 0x7f), read back as 2^24 (no column reached it:
//     dR = 0, as the plain version).
// A second launch (lr_check_kernel) does the LR check against the complete
// plane and writes valid as 0 / 1.
//
// What was measured on the card (PERF.md §6, tools/bench_finalize_variants.py):
// without the LR check the kernel runs at the card's read rate; the right
// view cost what its instructions cost (a pack with an integer conversion
// a value, a loop of dependent reads), not its atomics, which is why P is
// packed once and the diagonal unrolled; 8 columns a block made K4 slower. A
// slot exchange gathered by the LR kernel in place of the atomics was
// slower too (more bytes).
#include <atomic>

#include "sgm_scan.cuh"

namespace r3d {

constexpr float kPackLimit = 16777216.0f;  // 2^24: packed values stay exact
constexpr int kPackLimitBits = 0x4B800000;  // the bits of 2^24
constexpr int kFinCols = 16;                // columns a block: one warp each
constexpr int kFinThreads = 32 * kFinCols;
constexpr int kMemChunks = 8;               // K12: chunks a block

template <int K>
struct Fin {
  static constexpr int DP = 32 * K;
  static constexpr int R = K == 4 ? 8 : 4;                // rows a chunk
  static constexpr int TILE = R * kFinCols * DP;          // floats of one tile
  static constexpr int SMEM = 2 * TILE * sizeof(float);   // two tiles
};

struct FinArgs {
  float* disp;  // (HP, WP) f32
  int* valid;   // (HP, WP) int32: d0 or -1 here, 0 / 1 after lr_check_kernel
  int* plane;   // (HP, WP) int32: the right view's packed minimum, as bits
  int HP, WP, d_real, w_real, uniqueness_ratio, do_subpixel, lr;
  float pk;     // 1 << bit_length(DP - 1) = DP
};

__device__ __forceinline__ float pack(float s, float clamp, float pk, float d) {
  return __fadd_rn(__fmul_rn(fminf(s, clamp), pk), d);
}

__device__ __forceinline__ float group8_min(float v) {  // over lanes l ^ 1, 2, 4
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v = fminf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Finalizes the `rows` rows of a tile (row r is image row y0 + ystep * r) of
// the block's columns [c0, c0 + kFinCols). Every thread of the block calls it.
template <int K>
__device__ __forceinline__ void finalize_tile(float* tile, const FinArgs& a, int c0, int y0,
                                              int ystep, int rows) {
  constexpr int DP = Fin<K>::DP, R = Fin<K>::R, G = kFinCols;
  const float pk = a.pk, inv_pk = 1.0f / pk, clamp = kPackLimit / pk - 1.0f;
  const int tid = threadIdx.x, q = tid & 7;
  const float dq = static_cast<float>(4 * q);  // d = dq + 32 i + e, exact in f32

  // Left view. Rows past `rows` (a ragged last chunk of K12) are computed on
  // stale tile data and not written, so that every lane reaches the shuffles.
  // Each pixel's packed values P go back into the tile over S for the right
  // view.
  constexpr int PIX = kFinThreads / 8;  // pixels a pass
#pragma unroll
  for (int pass = 0; pass < R * G / PIX; ++pass) {
    const int pix = pass * PIX + (tid >> 3);
    const int r = pix / G, x = c0 + pix % G;
    float* s = tile + pix * DP;
    float P[4 * K];
    float mp = kPackLimit;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(s + 4 * (q + 8 * i));
      const float d = dq + static_cast<float>(32 * i);
      P[4 * i] = pack(v.x, clamp, pk, d);
      P[4 * i + 1] = pack(v.y, clamp, pk, d + 1.0f);
      P[4 * i + 2] = pack(v.z, clamp, pk, d + 2.0f);
      P[4 * i + 3] = pack(v.w, clamp, pk, d + 3.0f);
#pragma unroll
      for (int e = 0; e < 4; ++e) mp = fminf(mp, P[4 * i + e]);
    }
    mp = group8_min(mp);
    const float d0f = mp - floorf(mp * inv_pk) * pk;
    const float best = (mp - d0f) * inv_pk;
    const int d0 = static_cast<int>(d0f);

    float dv = d0f;
    if (a.do_subpixel) {
      const int d0c = min(max(d0, 1), a.d_real - 2);
      const float cm = fminf(s[d0c - 1], clamp);
      const float cp = fminf(s[d0c + 1], clamp);
      const float denom = fmaxf(__fsub_rn(__fadd_rn(cm, cp), 2.0f * best), 1e-6f);
      const float delta = fminf(fmaxf(__fdiv_rn(cm - cp, 2.0f * denom), -0.5f), 0.5f);
      if (d0 >= 1 && d0 <= a.d_real - 2) dv = __fadd_rn(static_cast<float>(d0c), delta);
    }

    bool ok = x >= d0;
    if (a.uniqueness_ratio > 0) {
      float ms = kPackLimit;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (abs(4 * (q + 8 * i) + e - d0) > 1) ms = fminf(ms, P[4 * i + e]);
      ms = group8_min(ms);
      const float second = floorf(ms * inv_pk);
      ok = ok && (second * 100.0f > best * (100.0f + static_cast<float>(a.uniqueness_ratio)));
    }
    __syncwarp();  // the pixel's subpixel reads of S are done
#pragma unroll
    for (int i = 0; i < K; ++i)
      *reinterpret_cast<float4*>(s + 4 * (q + 8 * i)) =
          make_float4(P[4 * i], P[4 * i + 1], P[4 * i + 2], P[4 * i + 3]);
    if (q == 0 && r < rows) {
      const long long p = static_cast<long long>(y0 + ystep * r) * a.WP + x;
      a.disp[p] = dv;
      a.valid[p] = ok ? d0 : -1;
    }
  }

  // Right view: the block's share of min over d of P(x + d, d) for the
  // targets x = c0 - DP + 1 + u, u in [0, G + DP - 1), from columns x + d =
  // c0 + g < w_real (so d = g + DP - 1 - u), read from the tile's P.
  if (!a.lr) return;
  __syncthreads();  // every pixel's P is in the tile
  constexpr int U = G + DP - 1;
  for (int it = tid; it < R * U; it += kFinThreads) {
    const int r = it / U, u = it - r * U;
    const int x = c0 - DP + 1 + u;
    if (r >= rows || x < 0) continue;
    const float* row = tile + r * G * DP + DP - 1 - u;  // column g's d at g * (DP + 1)
    const int g_lo = max(0, u - DP + 1), g_hi = min(min(G - 1, u), a.w_real - 1 - c0);
    float m = kPackLimit;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g >= g_lo && g <= g_hi) m = fminf(m, row[g * (DP + 1)]);
    if (m < kPackLimit)
      atomicMin(a.plane + static_cast<long long>(y0 + ystep * r) * a.WP + x,
                __float_as_int(m));
  }
}

// K4's feeder: the warp of column `column` runs the last vertical path down
// (or up) its column; a chunk's R steps become R rows of S = L + v3.
template <int K>
struct ScanFeed {
  struct Params {
    const int16_t* cost;
    const float* v3;
    float p1, p2;
    int reverse;
  };
  static constexpr int DP = Fin<K>::DP, R = Fin<K>::R;
  const int16_t* cost;
  const float* v3;
  long long col, row;  // offset of this lane's (0, column, K * lane); row stride
  float p1, p2;
  int HP, reverse, lane;
  float carry[K];
  unsigned cw[R][K / 2];  // the chunk's raw int16 cost pairs
  float a[R][K];          // the chunk's v3

  __device__ ScanFeed(const Params& p, const FinArgs& f, int column, int lane_)
      : cost(p.cost), v3(p.v3), col(static_cast<long long>(column) * DP + K * lane_),
        row(static_cast<long long>(f.WP) * DP), p1(p.p1), p2(p.p2), HP(f.HP),
        reverse(p.reverse), lane(lane_) {
#pragma unroll
    for (int k = 0; k < K; ++k) carry[k] = 0.0f;
  }
  __device__ int y(int pos) const { return reverse ? HP - 1 - pos : pos; }
  __device__ int ystep() const { return reverse ? -1 : 1; }

  __device__ void load(int chunk) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long long off = col + y(chunk * R + j) * row;
      if constexpr (K == 4) {
        const uint2 w = __ldcs(reinterpret_cast<const uint2*>(cost + off));
        cw[j][0] = w.x;
        cw[j][1] = w.y;
      } else {
        const uint4 w = __ldcs(reinterpret_cast<const uint4*>(cost + off));
        cw[j][0] = w.x;
        cw[j][1] = w.y;
        cw[j][2] = w.z;
        cw[j][3] = w.w;
      }
#pragma unroll
      for (int k = 0; k < K; k += 4) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(v3 + off + k));
        a[j][k] = v.x;
        a[j][k + 1] = v.y;
        a[j][k + 2] = v.z;
        a[j][k + 3] = v.w;
      }
    }
  }

  // dst: this lane's K floats of the tile's row 0; rows are kFinCols * DP apart
  __device__ void store(float* dst, int /*chunk*/) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float c[K];
#pragma unroll
      for (int k = 0; k < K / 2; ++k) {
        c[2 * k] = static_cast<float>(static_cast<int16_t>(cw[j][k] & 0xffffu));
        c[2 * k + 1] = static_cast<float>(static_cast<int16_t>(cw[j][k] >> 16));
      }
      path_step<K>(carry, c, p1, p2, lane);
      float o[K];
#pragma unroll
      for (int k = 0; k < K; ++k) o[k] = carry[k] + a[j][k];
      store_f32<K>(dst + j * kFinCols * DP, o);
    }
  }
};

// K12's feeder: the warp of column `column` copies its rows of S.
template <int K>
struct MemFeed {
  struct Params {
    const float* S;
  };
  static constexpr int DP = Fin<K>::DP, R = Fin<K>::R;
  const float* S;
  long long col, row;
  int HP;
  float a[R][K];

  __device__ MemFeed(const Params& p, const FinArgs& f, int column, int lane)
      : S(p.S), col(static_cast<long long>(column) * DP + K * lane),
        row(static_cast<long long>(f.WP) * DP), HP(f.HP) {}
  __device__ int y(int pos) const { return pos; }
  __device__ int ystep() const { return 1; }

  __device__ void load(int chunk) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int yy = chunk * R + j;
      if (yy >= HP) break;
#pragma unroll
      for (int k = 0; k < K; k += 4) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(S + col + yy * row + k));
        a[j][k] = v.x;
        a[j][k + 1] = v.y;
        a[j][k + 2] = v.z;
        a[j][k + 3] = v.w;
      }
    }
  }

  __device__ void store(float* dst, int chunk) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (chunk * R + j >= HP) break;
      store_f32<K>(dst + j * kFinCols * DP, a[j]);
    }
  }
};

// Block (bx, by) owns columns [16 bx, 16 bx + 16) and chunks [by * per,
// by * per + per). Tile t % 2 is written in round t and finalized after that
// round's first barrier; the next write to it, in round t + 2, comes after
// round t + 1's first barrier, which every thread reaches only once done
// with round t's finalize. (With the LR check the finalize has a second
// barrier, between its left and right views.)
template <int K, class Feed>
__global__ void __launch_bounds__(kFinThreads, 1)
    finalize_kernel(const typename Feed::Params fp, const FinArgs a, int per) {
  constexpr int DP = Fin<K>::DP, R = Fin<K>::R;
  extern __shared__ float4 smem4[];
  float* tiles = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kFinCols;
  const int lo = blockIdx.y * per;
  const int hi = min((a.HP + R - 1) / R, lo + per);
  Feed feed(fp, a, c0 + warp, lane);
  if (lo < hi) feed.load(lo);
  for (int chunk = lo; chunk < hi; ++chunk) {
    float* tile = tiles + (chunk & 1) * Fin<K>::TILE;
    feed.store(tile + warp * DP + K * lane, chunk);
    if (chunk + 1 < hi) feed.load(chunk + 1);
    __syncthreads();
    finalize_tile<K>(tile, a, c0, feed.y(chunk * R), feed.ystep(), min(R, a.HP - chunk * R));
  }
}

// The LR check against the complete right-view plane; valid becomes 0 / 1.
__global__ void lr_check_kernel(const int* __restrict__ plane, int* __restrict__ valid,
                                long long npix, float pk, int max_diff, int lr) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const int w = valid[p];  // d0, or -1 where the left view rejected the pixel
  int ok = w >= 0;
  if (lr && ok) {  // ok implies x >= d0, so p - d0 stays in the row
    const float mr = __int_as_float(min(plane[p - w], kPackLimitBits));
    ok = abs(w - static_cast<int>(mr - floorf(mr * (1.0f / pk)) * pk)) <= max_diff;
  }
  valid[p] = ok;
}

template <int K, class Feed>
int launch_finalize(const typename Feed::Params& fp, const FinArgs& a, int per, int max_diff,
                    cudaStream_t stream) {
  auto kernel = finalize_kernel<K, Feed>;
  // Above 48 KB of dynamic shared memory only when the kernel says so. The
  // attribute persists, so it is set once per instance and device (a bit a
  // device), not on every launch.
  static std::atomic<unsigned long long> attribute_set;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (!(attribute_set.load() & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Fin<K>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_set.fetch_or(bit);
  }
  const long long npix = static_cast<long long>(a.HP) * a.WP;
  if (a.lr) {
    e = cudaMemsetAsync(a.plane, 0x7f, npix * sizeof(int), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int chunks = (a.HP + Fin<K>::R - 1) / Fin<K>::R;
  const dim3 grid(a.WP / kFinCols, (chunks + per - 1) / per);
  kernel<<<grid, kFinThreads, Fin<K>::SMEM, stream>>>(fp, a, per);
  R3D_LAUNCH_CHECK();
  lr_check_kernel<<<static_cast<int>((npix + 255) / 256), 256, 0, stream>>>(
      a.plane, a.valid, npix, a.pk, max_diff, a.lr);
  R3D_LAUNCH_CHECK();
  return 0;
}

inline bool finalize_shape_ok(int HP, int WP, int DP, int d_real, int w_real) {
  return (DP == 128 || DP == 256) && HP >= 1 && WP >= 1 && WP % kFinCols == 0 && d_real >= 3 &&
         d_real <= DP && w_real <= WP;
}

}  // namespace r3d

// K4. cost (HP, WP, DP) int16 and v3 (HP, WP, DP) f32, both read only.
// disp (HP, WP) f32 and valid (HP, WP) int32 are the outputs; plane is
// (HP, WP) int32 scratch. p1, p2 in x2 cost units; reverse: the upward
// path; max_diff < 0 turns the left-right check off. Returns a cudaError_t
// code.
extern "C" int r3d_vfinalize(const int16_t* cost, const float* v3, float* disp, int* valid,
                             int* plane, int HP, int WP, int DP, int d_real, int w_real,
                             float p1, float p2, int reverse, int uniqueness_ratio,
                             int max_diff, int do_subpixel, cudaStream_t stream) {
  if (!r3d::finalize_shape_ok(HP, WP, DP, d_real, w_real) || HP % r3d::kScanChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const r3d::FinArgs a{disp, valid, plane, HP, WP, d_real, w_real, uniqueness_ratio,
                       do_subpixel, max_diff >= 0, static_cast<float>(DP)};
  const int all = HP;  // every chunk in one block: the carry runs down the column
  if (DP == 128)
    return r3d::launch_finalize<4, r3d::ScanFeed<4>>({cost, v3, p1, p2, reverse}, a, all,
                                                     max_diff, stream);
  return r3d::launch_finalize<8, r3d::ScanFeed<8>>({cost, v3, p1, p2, reverse}, a, all,
                                                   max_diff, stream);
}

// K12. S (HP, WP, DP) f32, read only; the other arguments as r3d_vfinalize's.
extern "C" int r3d_wta_finalize(const float* S, float* disp, int* valid, int* plane, int HP,
                                int WP, int DP, int d_real, int w_real, int uniqueness_ratio,
                                int max_diff, int do_subpixel, cudaStream_t stream) {
  if (!r3d::finalize_shape_ok(HP, WP, DP, d_real, w_real))
    return static_cast<int>(cudaErrorInvalidValue);
  const r3d::FinArgs a{disp, valid, plane, HP, WP, d_real, w_real, uniqueness_ratio,
                       do_subpixel, max_diff >= 0, static_cast<float>(DP)};
  if (DP == 128)
    return r3d::launch_finalize<4, r3d::MemFeed<4>>({S}, a, r3d::kMemChunks, max_diff, stream);
  return r3d::launch_finalize<8, r3d::MemFeed<8>>({S}, a, r3d::kMemChunks, max_diff, stream);
}
