// K8: radius-ball moments over the 27 neighboring cells of the voxel-grid
// table and, fused, the smallest eigenvector of their covariance (normals).
//
// Replaces recon3d_tpu/ops/grid_knn_pallas.py:moments_pallas_core /
// normals_pallas_core (kernel _mk_kernel(G, C, fuse_eig), pallas_call at
// grid_knn_pallas.py:147). Same function: for every slot q of the packed
// (G^3 * C, 4) table [x, y, z, occupancy] (ops/grid_knn.py), over the
// occupied slots p of the cells (x+dx, y+dy, z+dz) inside the grid,
//   w = (|q - p|^2 <= r2) * occ(q) * occ(p),
//   [cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz] = sum of
//   w * [1, px, py, pz, px px, py py, pz pz, px py, px pz, py pz];
// with fuse_eig the moments are normalized by max(cnt, 1) into the
// raw-moment covariance E[p p^T] - E[p] E[p]^T and its smallest
// eigenvector is solved as pointcloud/normals.py:_eig6_channels solves it
// (12 safeguarded Newton steps on the normalized characteristic cubic, then
// the largest cross product of rows of C - lam I), writing [nx, ny, nz, cnt].
// Occupancy is 0 or 1, as the pack writes it.
//
// The TPU walked x-slabs in order, staged each (dy, dz) offset's candidates
// with one lane roll and reduced candidates over sublanes, a query row at a
// time, with accumulators in VMEM. On Hopper a block owns a tile of
// TX x TY x TZ cells (a grid-stride loop over tiles, so the row of an empty
// slot is solved once a block):
//  1. it reads the tile's query slots, row by row of contiguous z-cells
//     (coalesced 16-byte loads), writes the fused row of every empty slot at
//     once (coalesced 16-byte stores; the moments variant zeroes the tile's
//     rows, 16 bytes a lane) and lists the occupied queries. A tile without
//     one stops here: nearly every tile of a sparse scan (99.9 % of the slots
//     of scan_post are empty);
//  2. otherwise it stages the tile and its one-cell halo in shared memory,
//     each cell's occupied slots compacted in slot order (a warp ballot a
//     cell) with their count, so holes anywhere in a cell cost nothing;
//  3. a thread a query: a test pass over the 27 cells' staged candidates,
//     two a step, lists each hit in a per-thread list in shared memory; the
//     list is summed in order (when it might overflow, and at the end):
//     the plain version's sums in its order, without the divergent
//     16-operation branch of a merged loop.
// Index math is 32-bit from the tile grid; only global offsets are 64-bit.
//
// Bound on the H100: bytes on a sparse table (read once, write once), the
// instruction rate on a dense one: every addition and product rounds on its
// own (__f*_rn, no contraction into fused multiply-adds), so each is one
// instruction, and a candidate test is 9 of them besides its load and list
// update.
//
// The radius arrives as a runtime scalar (the TPU read it from SMEM). Every
// operation rounds once, in the order of the plain version
// (grid_knn.moments_plain: offsets dx, dy, dz in -1..1, then candidates
// c' = 0..C-1), so the kernel agrees with it bitwise, counts included.
// Skipping an empty or out-of-radius candidate is exact: the plain version
// adds +0.0 there, and an accumulator that starts at +0.0 never becomes -0.0.
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

namespace r3d {

constexpr int kK8Threads = 256;
constexpr int kK8Warps = kK8Threads / 32;
constexpr int kK8MaxSmem = 226 * 1024;  // of the 227 KB opt-in, room for the static part

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// pointcloud/normals.py:_eig6_channels, op for op.
__device__ void eig6(float xx, float yy, float zz, float xy, float xz, float yz, float* v) {
  const float q = dvd(add(add(xx, yy), zz), 3.0f);
  const float bxx = sub(xx, q), byy = sub(yy, q), bzz = sub(zz, q);
  const float p2 = dvd(add(add(add(mul(bxx, bxx), mul(byy, byy)), mul(bzz, bzz)),
                           mul(2.0f, add(add(mul(xy, xy), mul(xz, xz)), mul(yz, yz)))),
                       6.0f);
  const float p = __fsqrt_rn(fmaxf(p2, 1e-30f));
  const float detB = add(sub(mul(bxx, sub(mul(byy, bzz), mul(yz, yz))),
                             mul(xy, sub(mul(xy, bzz), mul(yz, xz)))),
                         mul(xz, sub(mul(xy, yz), mul(byy, xz))));
  const float d = clampf(dvd(detB, fmaxf(mul(mul(p, p), p), 1e-30f)), -2.0f, 2.0f);
  float mu = -2.0f;
#pragma unroll
  for (int it = 0; it < 12; ++it) {
    const float f = sub(mul(mu, sub(mul(mu, mu), 3.0f)), d);
    const float fp = mul(3.0f, sub(mul(mu, mu), 1.0f));
    mu = clampf(sub(mu, dvd(f, fmaxf(fp, 1e-12f))), -2.0f, -1.0f);
  }
  const float lam = add(q, mul(p, mu));
  const float axx = sub(xx, lam), ayy = sub(yy, lam), azz = sub(zz, lam);
  const float c01[3] = {sub(mul(xy, yz), mul(xz, ayy)), sub(mul(xz, xy), mul(axx, yz)),
                        sub(mul(axx, ayy), mul(xy, xy))};
  const float c02[3] = {sub(mul(xy, azz), mul(xz, yz)), sub(mul(xz, xz), mul(axx, azz)),
                        sub(mul(axx, yz), mul(xy, xz))};
  const float c12[3] = {sub(mul(ayy, azz), mul(yz, yz)), sub(mul(yz, xz), mul(xy, azz)),
                        sub(mul(xy, yz), mul(ayy, xz))};
  const float n01 = add(add(mul(c01[0], c01[0]), mul(c01[1], c01[1])), mul(c01[2], c01[2]));
  const float n02 = add(add(mul(c02[0], c02[0]), mul(c02[1], c02[1])), mul(c02[2], c02[2]));
  const float n12 = add(add(mul(c12[0], c12[0]), mul(c12[1], c12[1])), mul(c12[2], c12[2]));
  const bool use02 = n02 > n01;
  const bool use12 = n12 > fmaxf(n01, n02);
  const float* c = use12 ? c12 : (use02 ? c02 : c01);
  const float norm = __fsqrt_rn(add(add(mul(c[0], c[0]), mul(c[1], c[1])), mul(c[2], c[2])));
  const bool ok = norm > 1e-12f;
  const float inv = dvd(1.0f, fmaxf(norm, 1e-12f));
  v[0] = ok ? mul(c[0], inv) : 0.0f;
  v[1] = ok ? mul(c[1], inv) : 0.0f;
  v[2] = ok ? mul(c[2], inv) : 1.0f;
}

// The fused row [nx, ny, nz, cnt] of moments m (grid_knn.normals_from_moments).
__device__ float4 normal_row(const float* m) {
  const float nn = fmaxf(m[0], 1.0f);
  const float mx = dvd(m[1], nn), my = dvd(m[2], nn), mz = dvd(m[3], nn);
  float v[3];
  eig6(sub(dvd(m[4], nn), mul(mx, mx)), sub(dvd(m[5], nn), mul(my, my)),
       sub(dvd(m[6], nn), mul(mz, mz)), sub(dvd(m[7], nn), mul(mx, my)),
       sub(dvd(m[8], nn), mul(mx, mz)), sub(dvd(m[9], nn), mul(my, mz)), v);
  return make_float4(v[0], v[1], v[2], m[0]);
}

struct K8Args {
  const float4* pk;
  float* out;
  int G, C, TX, TY, TZ;
  int ntx, nty, ntz, n_tiles;
  int S;  // staged float4s a halo cell: C + 1 when C is even (fewer bank conflicts), else C
  float r2;
  int fuse;
};

// Shared memory of a block, carved from the dynamic allocation.
struct K8Smem {
  float4* halo;          // (TX+2)(TY+2)(TZ+2) cells x S: each cell's occupied slots, compacted
  int* cnt;              // occupied slots of each halo cell
  int* qlist;            // the tile's occupied query slots (tile-local index)
  unsigned short* hits;  // a thread's hits (halo indices), kHits a thread, interleaved
};

constexpr int kHits = 64;

__host__ __device__ inline int k8_halo_cells(int TX, int TY, int TZ) {
  return (TX + 2) * (TY + 2) * (TZ + 2);
}

__host__ __device__ inline size_t k8_smem_bytes(int TX, int TY, int TZ, int C, int S) {
  const size_t hc = k8_halo_cells(TX, TY, TZ), tq = static_cast<size_t>(TX) * TY * TZ * C;
  return hc * S * 16 + hc * 4 + tq * 4 + kK8Threads * kHits * 2;
}

// Adds the listed hits to the moments, in list order.
__device__ __forceinline__ void add_hits(const float4* __restrict__ halo,
                                         const unsigned short* __restrict__ hits, int n,
                                         float* m) {
  for (int e = 0; e < n; ++e) {
    const float4 p = halo[hits[e * kK8Threads]];
    m[0] = add(m[0], 1.0f);
    m[1] = add(m[1], p.x);
    m[2] = add(m[2], p.y);
    m[3] = add(m[3], p.z);
    m[4] = add(m[4], mul(p.x, p.x));
    m[5] = add(m[5], mul(p.y, p.y));
    m[6] = add(m[6], mul(p.z, p.z));
    m[7] = add(m[7], mul(p.x, p.y));
    m[8] = add(m[8], mul(p.x, p.z));
    m[9] = add(m[9], mul(p.y, p.z));
  }
}

// The moments of query q over the staged cells around halo cell hc, for a
// whole warp (every lane calls it; a lane without a query has NaN
// coordinates, which pass no test). The test pass lists each hit's halo
// index (two candidates a step, for two independent chains); the list is
// summed in order when a lane's might overflow with the next cell (the
// warp together) and at the end.
__device__ __forceinline__ void query_moments(const K8Args& a, const float4* __restrict__ halo,
                                              const int* __restrict__ cnt,
                                              const int* __restrict__ off,
                                              unsigned short* __restrict__ hits, int hc, float4 q,
                                              float* m) {
  const bool per_pair = a.C > kHits / 2;  // a cell may not fit: check every step
  int n = 0;
#pragma unroll 1
  for (int k = 0; k < 27; ++k) {
    const int cell = hc + off[k];
    const int base = cell * a.S, nc = cnt[cell];
    for (int i = 0; i < nc; i += 2) {
      const float4 p0 = halo[base + i], p1 = halo[base + i + 1];  // i + 1 may be past nc
      const float d0 = sub(q.x, p0.x), d1 = sub(q.y, p0.y), d2 = sub(q.z, p0.z);
      const float e0 = sub(q.x, p1.x), e1 = sub(q.y, p1.y), e2 = sub(q.z, p1.z);
      const float dd = add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2));
      const float ee = add(add(mul(e0, e0), mul(e1, e1)), mul(e2, e2));
      if (dd <= a.r2) hits[kK8Threads * n++] = static_cast<unsigned short>(base + i);
      if (i + 1 < nc && ee <= a.r2)
        hits[kK8Threads * n++] = static_cast<unsigned short>(base + i + 1);
      if (per_pair && n > kHits - 2) {
        add_hits(halo, hits, n, m);
        n = 0;
      }
    }
    if (!per_pair && __any_sync(0xffffffffu, n > kHits - a.C)) {
      add_hits(halo, hits, n, m);
      n = 0;
    }
  }
  add_hits(halo, hits, n, m);
}

// Zeroes n floats at dst: scalar stores up to a 16-byte boundary, then
// float4 stores, then the tail; one warp.
__device__ __forceinline__ void warp_zero_row(float* dst, int n, int lane) {
  const int head = min(static_cast<int>((4 - (reinterpret_cast<size_t>(dst) >> 2 & 3)) & 3), n);
  if (lane < head) dst[lane] = 0.0f;
  const int nv = (n - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int v = lane; v < nv; v += 32) d4[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int t0 = head + 4 * nv;
  if (lane < n - t0) dst[t0 + lane] = 0.0f;
}

__global__ void __launch_bounds__(kK8Threads) grid_moments_kernel(K8Args a) {
  extern __shared__ float4 smem[];
  const int HX = a.TX + 2, HY = a.TY + 2, HZ = a.TZ + 2, HC = HX * HY * HZ;
  K8Smem s;
  s.halo = smem;
  s.cnt = reinterpret_cast<int*>(smem + HC * a.S);
  s.qlist = s.cnt + HC;
  s.hits = reinterpret_cast<unsigned short*>(s.qlist + a.TX * a.TY * a.TZ * a.C);
  __shared__ int s_nq, s_off[27];
  __shared__ float4 s_empty;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G, C = a.C;
  if (tid < 27) s_off[tid] = ((tid / 9 - 1) * HY + (tid / 3 % 3 - 1)) * HZ + (tid % 3 - 1);
  // The row of an empty slot: the fused finish of zero moments, once a block.
  if (tid == 0 && a.fuse) {
    const float zero[10] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    s_empty = normal_row(zero);
  }
  float4* out4 = reinterpret_cast<float4*>(a.out);
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int tz = tile % a.ntz, txy = tile / a.ntz;
    const int x0 = txy / a.nty * a.TX, y0 = txy % a.nty * a.TY, z0 = tz * a.TZ;
    const int nx = min(a.TX, G - x0), ny = min(a.TY, G - y0), nz = min(a.TZ, G - z0);
    const int row_len = nz * C, nslots = nx * ny * row_len;
    __syncthreads();  // the previous tile is done with shared memory and s_nq
    if (tid == 0) s_nq = 0;
    __syncthreads();

    // 1. the tile's query slots: the fused rows of empty slots out, occupied
    // slots listed
    for (int t0 = warp * 32; t0 < nslots; t0 += kK8Threads) {
      const int t = t0 + lane;
      bool occ = false;
      if (t < nslots) {
        const int r = t / row_len, o = t - r * row_len;
        const int lx = r / ny, ly = r - lx * ny;
        const long long g = static_cast<long long>(((x0 + lx) * G + y0 + ly) * G + z0) * C + o;
        occ = a.pk[g].w != 0.0f;
        if (!occ && a.fuse) out4[g] = s_empty;
      }
      const unsigned b = __ballot_sync(0xffffffffu, occ);
      int base = 0;
      if (lane == 0 && b) base = atomicAdd(&s_nq, __popc(b));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (occ) s.qlist[base + __popc(b & ((1u << lane) - 1))] = t;
    }
    // the moments variant: zero rows over the whole tile, a row of z-cells a
    // warp (coalesced); the occupied slots' rows are written over them after
    // the barrier below
    if (!a.fuse)
      for (int r = warp; r < nx * ny; r += kK8Warps) {
        const int lx = r / ny, ly = r - lx * ny;
        const long long g = static_cast<long long>(((x0 + lx) * G + y0 + ly) * G + z0) * C;
        warp_zero_row(a.out + 10 * g, 10 * row_len, lane);
      }
    __syncthreads();
    const int nq = s_nq;
    if (nq == 0) continue;  // block-uniform: nothing to stage

    // 2. stage the tile and its halo, each cell's occupied slots compacted:
    // a warp task is 32 / C cells (C <= 32), or one cell in chunks of 32
    const int cpw = C <= 32 ? 32 / C : 1;
    const int j = C <= 32 ? lane / C : 0;
    const bool lane_ok = j < cpw;  // C <= 32: lanes past the last whole cell idle
    const unsigned seg = C >= 32 ? 0xffffffffu : lane_ok ? ((1u << C) - 1) << (j * C) : 0u;
    for (int task = warp; task * cpw < HC; task += kK8Warps) {
      const int h = task * cpw + j;
      const int hz = h % HZ, hxy = h / HZ;
      const int gx = x0 - 1 + hxy / HY, gy = y0 - 1 + hxy % HY, gz = z0 - 1 + hz;
      const bool in = h < HC && lane_ok && gx >= 0 && gx < G && gy >= 0 && gy < G && gz >= 0 &&
                      gz < G;
      const float4* cell = a.pk + static_cast<long long>((gx * G + gy) * G + gz) * C;
      int count = 0;
      for (int c0 = 0; c0 < C; c0 += 32) {  // one pass when C <= 32
        const int c = C <= 32 ? lane - j * C : c0 + lane;
        const float4 p = in && c < C ? cell[c] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const bool occ = p.w != 0.0f;
        const unsigned b = __ballot_sync(0xffffffffu, occ) & seg;
        if (occ) s.halo[h * a.S + count + __popc(b & ((1u << lane) - 1))] = p;
        count += __popc(b);
      }
      if (h < HC && lane_ok && lane == j * C) s.cnt[h] = count;
    }
    __syncthreads();

    // 3. a thread a query, whole warps at a time (query_moments votes)
    for (int i0 = warp * 32; i0 < nq; i0 += kK8Threads) {
      const int i = i0 + lane;
      const int t = s.qlist[min(i, nq - 1)];
      const int r = t / row_len, o = t - r * row_len;
      const int lx = r / ny, ly = r - lx * ny, lz = o / C;
      const long long g = static_cast<long long>(((x0 + lx) * G + y0 + ly) * G + z0) * C + o;
      float4 q = a.pk[g];
      if (i >= nq) q.x = q.y = q.z = __int_as_float(0x7fc00000);  // NaN: no hits
      float m[10] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      query_moments(a, s.halo, s.cnt, s_off, s.hits + tid, ((lx + 1) * HY + ly + 1) * HZ + lz + 1,
                    q, m);
      if (i >= nq) continue;
      if (a.fuse) {
        out4[g] = normal_row(m);
      } else {  // a row starts 8-byte aligned
        float2* o2 = reinterpret_cast<float2*>(a.out + 10 * g);
#pragma unroll
        for (int ch = 0; ch < 5; ++ch) o2[ch] = make_float2(m[2 * ch], m[2 * ch + 1]);
      }
    }
  }
}

}  // namespace r3d

// pk (G^3 * C, 4) f32 packed table; out (G^3 * C, 10) f32 moments, or with
// fuse_eig (G^3 * C, 4) f32 [nx, ny, nz, cnt]; a block owns tiles of
// tx x ty x tz cells (ops/grid_knn_cuda.py picks them). Returns a
// cudaError_t code.
extern "C" int r3d_grid_moments(const float* pk, float* out, int G, int C, float r2,
                                int fuse_eig, int tx, int ty, int tz, cudaStream_t stream) {
  if (G < 1 || C < 1 || tx < 1 || ty < 1 || tz < 1 ||
      static_cast<long long>(G) * G * G > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  r3d::K8Args a;
  a.pk = reinterpret_cast<const float4*>(pk);
  a.out = out;
  a.G = G;
  a.C = C;
  a.TX = tx;
  a.TY = ty;
  a.TZ = tz;
  a.ntx = (G + tx - 1) / tx;
  a.nty = (G + ty - 1) / ty;
  a.ntz = (G + tz - 1) / tz;
  const long long n_tiles = static_cast<long long>(a.ntx) * a.nty * a.ntz;
  a.n_tiles = static_cast<int>(n_tiles);
  a.S = C % 2 == 0 ? C + 1 : C;
  a.r2 = r2;
  a.fuse = fuse_eig;
  const size_t smem = r3d::k8_smem_bytes(tx, ty, tz, C, a.S);
  // the hit lists hold halo indices in 16 bits
  if (smem > static_cast<size_t>(r3d::kK8MaxSmem) || n_tiles > 0x7fffffffLL ||
      static_cast<long long>(r3d::k8_halo_cells(tx, ty, tz)) * a.S > 0xffff)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = r3d::grid_moments_kernel;
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
                             r3d::kK8MaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_set.fetch_or(bit);
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, r3d::kK8Threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = std::min<long long>(n_tiles, static_cast<long long>(sms) *
                                                            (per_sm > 0 ? per_sm : 1));
  kernel<<<static_cast<unsigned>(blocks), r3d::kK8Threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
