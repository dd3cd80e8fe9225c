// K1: one 1-D bilinear resampling pass of the two-pass rectification warp.
//
// Replaces recon3d_tpu/ops/warp.py:remap_two_pass_pallas (kernel body
// _mk_resample_kernel, pallas_calls at warp.py:266 and :276). Same function:
// along `axis`, out[i] = fma(1 - frac, a0, frac * a1), where
//   resid = (coord[i] - i) - coarse[line]     (f32, in that order)
//   rf = floor(resid), frac = resid - rf,
//   a0 = src[(i + coarse + rf) mod n]      if -R     <= rf <= R + 1, else 0,
//   a1 = src[(i + coarse + rf + 1) mod n]  if -R - 1 <= rf <= R,     else 0,
// n the line length and R the plan's residual bound. The TPU has no gather,
// so it built `base` = src rolled by the per-line coarse shift from a
// log2 ladder of masked rolls and picked the taps from a plane sweep of
// 2R + 2 rolls; the rolls wrap, which is the `mod n` here (the wrapped taps
// are the ones plan.valid masks). On Hopper a gather is cheap: each thread
// reads its two taps directly. The vertical pass (axis 0) takes a
// per-column coarse shift (W,), the horizontal pass (axis 1) a per-row one
// (H,); the horizontal pass also applies plan.valid.
//
// Bound on the H100: bytes. A pass reads src and coord and writes out,
// 3 x 8.3 MB at 1080p. One thread per output element, consecutive threads
// on consecutive columns: the coord and out accesses are coalesced, and the
// taps of neighbouring threads lie on neighbouring addresses of one or two
// rows (vertical pass) or of one row (horizontal pass).
//
// Every operation rounds as the plain PyTorch version's do: separate f32
// subtractions and products (__fsub_rn / __fmul_rn, never contracted) and
// one fused multiply-add for the interpolation, the one XLA forms from
// (1 - frac) * a0 + frac * a1 and ops/image.py:fma computes. So the kernel
// matches the plain version, and the JAX package, bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace r3d {

__global__ void __launch_bounds__(256) resample_kernel(
    const float* __restrict__ src, const float* __restrict__ coord,
    const int* __restrict__ coarse, const uint8_t* __restrict__ valid, float* __restrict__ out,
    int H, int W, int axis, int resid_bound) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= static_cast<long long>(H) * W) return;
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<long long>(y) * W);
  // i: position along the pass's axis, n: line length, c: the line's shift
  const int i = axis == 0 ? y : x;
  const int n = axis == 0 ? H : W;
  const int c = axis == 0 ? coarse[x] : coarse[y];
  const float resid = __fsub_rn(__fsub_rn(coord[p], static_cast<float>(i)), static_cast<float>(c));
  const float rf = floorf(resid);
  const float frac = __fsub_rn(resid, rf);
  const int r = static_cast<int>(rf);
  int k = (i + c + r) % n;  // tap 0 along the line, wrapped like a roll
  if (k < 0) k += n;
  const int k1 = k + 1 == n ? 0 : k + 1;
  const long long line0 = axis == 0 ? x : static_cast<long long>(y) * W;
  const long long step = axis == 0 ? W : 1;
  const float a0 = (r >= -resid_bound && r <= resid_bound + 1) ? src[line0 + k * step] : 0.0f;
  const float a1 = (r >= -resid_bound - 1 && r <= resid_bound) ? src[line0 + k1 * step] : 0.0f;
  float v = __fmaf_rn(__fsub_rn(1.0f, frac), a0, __fmul_rn(frac, a1));
  if (valid != nullptr && valid[p] == 0) v = 0.0f;
  out[p] = v;
}

}  // namespace r3d

// src, coord, out (H, W) f32; coarse (W,) int32 for axis 0, (H,) for axis 1;
// valid (H, W) uint8 or null (then no mask). Returns a cudaError_t code.
extern "C" int r3d_resample(const float* src, const float* coord, const int* coarse,
                            const uint8_t* valid, float* out, int H, int W, int axis,
                            int resid_bound, cudaStream_t stream) {
  if (H < 1 || W < 1 || (axis != 0 && axis != 1) || resid_bound < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(H) * W;
  r3d::resample_kernel<<<static_cast<int>((n + 255) / 256), 256, 0, stream>>>(
      src, coord, coarse, valid, out, H, W, axis, resid_bound);
  return static_cast<int>(cudaGetLastError());
}
