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
//
// The TPU walked x-slabs in order, staged each (dy, dz) offset's candidates
// with one lane roll and reduced candidates over sublanes, a query row at a
// time, with accumulators in VMEM. On Hopper: one thread per query slot,
// moments in 10 registers, a loop over the 27 cells and their C slots. The
// C threads of one cell read the same candidates, and neighboring cells
// along z sit in the same warp, so the 16-byte candidate loads are served
// from L1 / L2; unoccupied query and candidate slots add +0.0 and are
// skipped, which is exact.
//
// Bound on the H100: operations. Each query slot tests 27 * C candidates
// (about 9 f32 operations a test before the accumulation); the table is
// read once and the output written once (16 B + 40 or 16 B a slot).
//
// The radius arrives as a runtime scalar (the TPU read it from SMEM). Every
// operation rounds once (__f*_rn: no contraction into fused multiply-adds),
// in the order of the plain version (grid_knn.moments_plain: offsets dx,
// dy, dz in -1..1, then candidates c' = 0..C-1), so the kernel agrees with
// it bitwise, counts included.
#include <cuda_runtime.h>

namespace r3d {

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

__global__ void __launch_bounds__(256) grid_moments_kernel(
    const float4* __restrict__ pk, float* __restrict__ out, int G, int C, float r2,
    int fuse_eig) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n_slots = static_cast<long long>(G) * G * G * C;
  if (t >= n_slots) return;
  const int cell = static_cast<int>(t / C);
  const int x = cell / (G * G), y = (cell / G) % G, z = cell % G;
  const float4 q = pk[t];
  // [cnt, sx, sy, sz, sxx, syy, szz, sxy, sxz, syz]
  float m[10] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (q.w != 0.0f) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int cx = x + dx;
      if (cx < 0 || cx >= G) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int cy = y + dy;
        if (cy < 0 || cy >= G) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          const int cz = z + dz;
          if (cz < 0 || cz >= G) continue;
          const float4* cand = pk + static_cast<long long>((cx * G + cy) * G + cz) * C;
          for (int c = 0; c < C; ++c) {
            const float4 p = cand[c];
            if (p.w == 0.0f) continue;
            const float d0 = sub(q.x, p.x), d1 = sub(q.y, p.y), d2 = sub(q.z, p.z);
            const float dd = add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2));
            if (!(dd <= r2)) continue;
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
      }
    }
  }
  if (!fuse_eig) {
    float* o = out + 10 * t;
#pragma unroll
    for (int ch = 0; ch < 10; ++ch) o[ch] = m[ch];
    return;
  }
  const float nn = fmaxf(m[0], 1.0f);
  const float mx = dvd(m[1], nn), my = dvd(m[2], nn), mz = dvd(m[3], nn);
  float v[3];
  eig6(sub(dvd(m[4], nn), mul(mx, mx)), sub(dvd(m[5], nn), mul(my, my)),
       sub(dvd(m[6], nn), mul(mz, mz)), sub(dvd(m[7], nn), mul(mx, my)),
       sub(dvd(m[8], nn), mul(mx, mz)), sub(dvd(m[9], nn), mul(my, mz)), v);
  reinterpret_cast<float4*>(out)[t] = make_float4(v[0], v[1], v[2], m[0]);
}

}  // namespace r3d

// pk (G^3 * C, 4) f32 packed table; out (G^3 * C, 10) f32 moments, or with
// fuse_eig (G^3 * C, 4) f32 [nx, ny, nz, cnt]. Returns a cudaError_t code.
extern "C" int r3d_grid_moments(const float* pk, float* out, int G, int C, float r2,
                                int fuse_eig, cudaStream_t stream) {
  if (G < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(G) * G * G * C;
  r3d::grid_moments_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(pk), out, G, C, r2, fuse_eig);
  return static_cast<int>(cudaGetLastError());
}
