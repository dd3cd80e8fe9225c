// A TSDF frame update in one pass a voxel: the projection, K9's sample and the
// weighted running average of fusion/tsdf.py, fused.
//
// Replaces no TPU kernel of its own: the JAX package leaves the voxel
// centers, the camera transform and the running averages of
// recon3d_tpu/fusion/tsdf.py:_integrate to XLA and only the sample to a
// Pallas kernel (K9, recon3d_tpu/ops/project_sample.py:131, on the card
// csrc/project_sample.cu). On the card the PyTorch version of that glue is
// some 270 full-volume operations a frame, many of them float64 to emulate
// XLA's fused multiply-adds (ops/image.py:fma): 28 ms at 256^3. Here one
// thread does a voxel's whole update, in the plain version's order and with
// its roundings written out (`__fmaf_rn` is the single rounding that fma
// emulates; contraction is on in NVCC_FLAGS, so no bare a * b + c):
//   1. the center g * voxel_size + origin, one fused multiply-add an axis;
//   2. the camera transform fma(p2, m2, fma(p1, m1, p0 * m0)) + t a row;
//   3. u = fx * x / max(z, 1e-9) + cx (and v), rounded half to even,
//      clamped to [-1, W] ([-1, H]) and the in-image mask with z > 1e-6;
//   4. the depth and colour at that pixel (uint8 colour times the float32
//      1 / 255), read only for voxels inside the image;
//   5. sdf = d - z, the truncation clamp(sdf / sdf_trunc, -1, 1) and the
//      update mask (0.0001 < d < depth_trunc, sdf > -sdf_trunc);
//   6. fold mode: tsdf and colour fma(old, w_old, new) / max(w_old + 1, 1)
//      where updated, the old value elsewhere, the weight
//      min(w_old + upd, weight_max); contribution mode: (where(upd, tsdf, 0),
//      upd, where(upd, colour, 0)), the summand of integrate_frames and of
//      the sharded fusion's two passes.
// Clamps keep PyTorch's semantics (a NaN passes through); constants are the
// float32 values PyTorch rounds the Python scalars to. So every output is
// bitwise the plain version's (fusion/tsdf.py:_frame_contrib_plain, _combine).
//
// Bound on the H100: bytes. The fold reads the old tsdf, weight and colour
// and writes the new volume whole (out of place, as integrate() returns a
// new volume): 40 B a voxel, 671 MB at R = 256, 0.200 ms at 3.35 TB/s; the
// contribution writes 20 B a voxel. A thread takes 4 consecutive voxels
// along z: the volume moves in 16-byte loads and streaming stores (tsdf,
// weight, then the 12 colour floats as three), over a grid-stride loop of
// one wave of blocks. The images (2.15 MB at 640 x 480 with uint8 colour)
// stay in the 50 MB L2 and are read through __ldg; neighbouring voxels
// along z project to neighbouring pixels. Where R is not a multiple of 4, or
// a volume is not 16-byte aligned, a thread takes one voxel with scalar
// loads. Offsets are 64-bit (R^3 * 3 passes 2^31 at R = 904).
#include <cuda_runtime.h>

#include <cstdint>

namespace r3d {

enum ColorKind { kNoColor = 0, kColorU8 = 1, kColorF32 = 2 };

struct FuseArgs {
  const float* tsdf;    // fold: the old volume (R, R, R), (R, R, R), (R, R, R, 3)
  const float* weight;
  const float* color;
  const float* depth;   // (H, W) metres
  const void* image;    // (H, W, 3) uint8 or float32 colour, or null
  const float* ext;     // (4, 4) camera_from_world
  const float* origin;  // (3,)
  const float* voxel_size;
  const float* sdf_trunc;
  float* out_tsdf;      // fold: the new volume; contribution: the summands
  float* out_weight;
  float* out_color;
  int R, H, W;
  float fx, fy, cx, cy, depth_trunc, weight_max;
};

// The Python scalars of the plain version, as PyTorch rounds them to float32
// (a double literal rounded once, not a float literal rounded from decimal).
constexpr float kZMin = static_cast<float>(1e-9);
constexpr float kZFront = static_cast<float>(1e-6);
constexpr float kDepthMin = static_cast<float>(1e-4);
// 1.0 / torch.tensor(255.0): the float32 reciprocal, correctly rounded
constexpr float kInv255 = 1.0f / 255.0f;

// torch.clamp(v, min=lo) / (v, max=hi): a NaN passes through
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : (v < lo ? lo : v);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return v != v ? v : (v > hi ? hi : v);
}

struct Pose {
  float m[9], t[3], o[3], vs, st;
};

__device__ __forceinline__ Pose load_pose(const FuseArgs& a) {
  Pose p;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) p.m[3 * r + c] = __ldg(a.ext + 4 * r + c);
    p.t[r] = __ldg(a.ext + 4 * r + 3);
    p.o[r] = __ldg(a.origin + r);
  }
  p.vs = __ldg(a.voxel_size);
  p.st = __ldg(a.sdf_trunc);
  return p;
}

struct Sample {
  bool upd;
  float tsdf;   // clamp(sdf / sdf_trunc, -1, 1) where upd
  float c[3];   // the pixel's colour where upd
};

// One voxel at z index k; r0..r2 are the camera rows' first two terms,
// fma(p1, m[r][1], p0 * m[r][0]), shared along z.
template <int CK>
__device__ __forceinline__ Sample sample_voxel(const FuseArgs& a, const Pose& P, float r0,
                                               float r1, float r2, int k) {
  const float p2 = __fmaf_rn(static_cast<float>(k), P.vs, P.o[2]);
  const float x = __fadd_rn(__fmaf_rn(p2, P.m[2], r0), P.t[0]);
  const float y = __fadd_rn(__fmaf_rn(p2, P.m[5], r1), P.t[1]);
  const float z = __fadd_rn(__fmaf_rn(p2, P.m[8], r2), P.t[2]);
  const float zc = clamp_lo(z, kZMin);
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(a.fx, x), zc), a.cx);
  const float v = __fadd_rn(__fdiv_rn(__fmul_rn(a.fy, y), zc), a.cy);
  // round half to even, clamped before the (saturating) int conversion
  const int ui = static_cast<int>(clamp_hi(clamp_lo(rintf(u), -1.0f), static_cast<float>(a.W)));
  const int vi = static_cast<int>(clamp_hi(clamp_lo(rintf(v), -1.0f), static_cast<float>(a.H)));
  Sample s{false, 0.0f, {0.0f, 0.0f, 0.0f}};
  if (!(z > kZFront) || ui < 0 || ui >= a.W || vi < 0 || vi >= a.H) return s;
  const long long pix = static_cast<long long>(vi) * a.W + ui;
  const float d = __ldg(a.depth + pix);
  const float sdf = __fsub_rn(d, z);
  if (!(d > kDepthMin) || !(d < a.depth_trunc) || !(sdf > -P.st)) return s;
  s.upd = true;
  s.tsdf = clamp_hi(clamp_lo(__fdiv_rn(sdf, P.st), -1.0f), 1.0f);
  if constexpr (CK == kColorU8) {
    const unsigned char* img = static_cast<const unsigned char*>(a.image) + 3 * pix;
#pragma unroll
    for (int c = 0; c < 3; ++c) s.c[c] = __fmul_rn(static_cast<float>(__ldg(img + c)), kInv255);
  } else if constexpr (CK == kColorF32) {
    const float* img = static_cast<const float*>(a.image) + 3 * pix;
#pragma unroll
    for (int c = 0; c < 3; ++c) s.c[c] = __ldg(img + c);
  }
  return s;
}

// V voxels a thread: 4 along z with 16-byte loads and stores, or 1.
template <int CK, bool FOLD, int V>
__global__ void __launch_bounds__(256) tsdf_fuse_kernel(const FuseArgs a) {
  constexpr bool kColor = CK != kNoColor;
  const Pose P = load_pose(a);
  const long long R = a.R;
  const long long groups = R * R * R / V;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; q < groups;
       q += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = q * V / R;  // i * R + j; a group never crosses a row
    const int k0 = static_cast<int>(q * V - row * R);
    const int i = static_cast<int>(row / R);
    const int j = static_cast<int>(row - i * R);
    const float p0 = __fmaf_rn(static_cast<float>(i), P.vs, P.o[0]);
    const float p1 = __fmaf_rn(static_cast<float>(j), P.vs, P.o[1]);
    const float r0 = __fmaf_rn(p1, P.m[1], __fmul_rn(p0, P.m[0]));
    const float r1 = __fmaf_rn(p1, P.m[4], __fmul_rn(p0, P.m[3]));
    const float r2 = __fmaf_rn(p1, P.m[7], __fmul_rn(p0, P.m[6]));

    float t[V], w[V], c[3 * V];
    if constexpr (FOLD) {
      if constexpr (V == 4) {
        const float4 t4 = __ldcs(reinterpret_cast<const float4*>(a.tsdf) + q);
        const float4 w4 = __ldcs(reinterpret_cast<const float4*>(a.weight) + q);
        t[0] = t4.x, t[1] = t4.y, t[2] = t4.z, t[3] = t4.w;
        w[0] = w4.x, w[1] = w4.y, w[2] = w4.z, w[3] = w4.w;
        if constexpr (kColor) {
#pragma unroll
          for (int h = 0; h < 3; ++h) {
            const float4 c4 = __ldcs(reinterpret_cast<const float4*>(a.color) + 3 * q + h);
            c[4 * h] = c4.x, c[4 * h + 1] = c4.y, c[4 * h + 2] = c4.z, c[4 * h + 3] = c4.w;
          }
        }
      } else {
        t[0] = __ldcs(a.tsdf + q);
        w[0] = __ldcs(a.weight + q);
        if constexpr (kColor) {
#pragma unroll
          for (int h = 0; h < 3; ++h) c[h] = __ldcs(a.color + 3 * q + h);
        }
      }
    }

#pragma unroll
    for (int e = 0; e < V; ++e) {
      const Sample s = sample_voxel<CK>(a, P, r0, r1, r2, k0 + e);
      if constexpr (FOLD) {
        // w_sum = w_old + w_new even where nothing updates (-0 + 0 is +0)
        const float ws = __fadd_rn(w[e], s.upd ? 1.0f : 0.0f);
        if (s.upd) {
          const float den = clamp_lo(ws, 1.0f);
          t[e] = __fdiv_rn(__fmaf_rn(t[e], w[e], s.tsdf), den);
          if constexpr (kColor) {
#pragma unroll
            for (int h = 0; h < 3; ++h)
              c[3 * e + h] = __fdiv_rn(__fmaf_rn(c[3 * e + h], w[e], s.c[h]), den);
          }
        }
        w[e] = clamp_hi(ws, a.weight_max);
      } else {
        t[e] = s.upd ? s.tsdf : 0.0f;
        w[e] = s.upd ? 1.0f : 0.0f;
        if constexpr (kColor) {
#pragma unroll
          for (int h = 0; h < 3; ++h) c[3 * e + h] = s.upd ? s.c[h] : 0.0f;
        }
      }
    }

    if constexpr (V == 4) {
      __stcs(reinterpret_cast<float4*>(a.out_tsdf) + q, make_float4(t[0], t[1], t[2], t[3]));
      __stcs(reinterpret_cast<float4*>(a.out_weight) + q, make_float4(w[0], w[1], w[2], w[3]));
      if constexpr (kColor) {
#pragma unroll
        for (int h = 0; h < 3; ++h)
          __stcs(reinterpret_cast<float4*>(a.out_color) + 3 * q + h,
                 make_float4(c[4 * h], c[4 * h + 1], c[4 * h + 2], c[4 * h + 3]));
      }
    } else {
      __stcs(a.out_tsdf + q, t[0]);
      __stcs(a.out_weight + q, w[0]);
      if constexpr (kColor) {
#pragma unroll
        for (int h = 0; h < 3; ++h) __stcs(a.out_color + 3 * q + h, c[h]);
      }
    }
  }
}

// One wave of 256-thread blocks over the card's SMs, fewer for a small volume.
template <int CK, bool FOLD, int V>
int launch(const FuseArgs& a, cudaStream_t stream) {
  auto kernel = tsdf_fuse_kernel<CK, FOLD, V>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = static_cast<long long>(a.R) * a.R * a.R / V;
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long need = (groups + 255) / 256;
  kernel<<<static_cast<unsigned>(need < wave ? need : wave), 256, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int CK, bool FOLD>
int launch_width(const FuseArgs& a, bool vec, cudaStream_t stream) {
  return vec ? launch<CK, FOLD, 4>(a, stream) : launch<CK, FOLD, 1>(a, stream);
}

template <int CK>
int launch_mode(const FuseArgs& a, bool fold, bool vec, cudaStream_t stream) {
  return fold ? launch_width<CK, true>(a, vec, stream) : launch_width<CK, false>(a, vec, stream);
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace r3d

// fold != 0: tsdf, weight (and color where color_kind != 0) hold the old
// volume, and out_* get the new one; fold == 0: tsdf, weight, color are
// unused, and out_* get the frame's contribution. color_kind: 0 none,
// 1 uint8, 2 float32 (H, W, 3) image. Returns a cudaError_t code.
extern "C" int r3d_tsdf_fuse(const float* tsdf, const float* weight, const float* color,
                             const float* depth, const void* image, const float* ext,
                             const float* origin, const float* voxel_size,
                             const float* sdf_trunc, float* out_tsdf, float* out_weight,
                             float* out_color, int R, int H, int W, int color_kind, int fold,
                             float fx, float fy, float cx, float cy, float depth_trunc,
                             float weight_max, cudaStream_t stream) {
  using namespace r3d;
  const bool with_color = color_kind != kNoColor;
  if (R < 1 || H < 1 || W < 1 || color_kind < kNoColor || color_kind > kColorF32 ||
      !depth || !ext || !origin || !voxel_size || !sdf_trunc || !out_tsdf || !out_weight ||
      (with_color && (!image || !out_color)) ||
      (fold && (!tsdf || !weight || (with_color && !color))))
    return static_cast<int>(cudaErrorInvalidValue);
  const FuseArgs a{tsdf, weight, color, depth, image, ext, origin, voxel_size, sdf_trunc,
                   out_tsdf, out_weight, out_color, R, H, W,
                   fx, fy, cx, cy, depth_trunc, weight_max};
  const bool vec = R % 4 == 0 && aligned16(tsdf) && aligned16(weight) && aligned16(color) &&
                   aligned16(out_tsdf) && aligned16(out_weight) && aligned16(out_color);
  switch (color_kind) {
    case kColorU8: return launch_mode<kColorU8>(a, fold != 0, vec, stream);
    case kColorF32: return launch_mode<kColorF32>(a, fold != 0, vec, stream);
    default: return launch_mode<kNoColor>(a, fold != 0, vec, stream);
  }
}
