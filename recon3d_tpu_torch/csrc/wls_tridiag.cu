// K6: Thomas tridiagonal solves of the Fast Global Smoother (WLS refine).
//
// Replaces recon3d_tpu/depth/wls_pallas.py:_solve (kernel body
// _mk_tridiag_kernel, pallas_call at wls_pallas.py:102). Same function: per
// system -wl[i] u[i-1] + diag[i] u[i] - wr[i] u[i+1] = rhs[i] with
// wl[0] = wr[n-1] = 0, solved by a forward elimination into the cp / dp
// factor planes and a back substitution.
//
// Bound on the H100: bytes (4 input planes, 1 output plane and the cp / dp
// scratch), but in practice the latency of the sequential recurrence: one
// thread per system, 1080 or 1920 steps each. The vertical solve (axis 0)
// runs one thread per column, so a warp's loads at a step are one coalesced
// row segment; the horizontal solve (axis 1) runs one thread per row and
// reads its row in place, strided across the warp, instead of transposing
// the planes as the TPU did. Built without fast math, and every operation
// rounds exactly as the plain PyTorch version's separate f32 operations do
// (no contraction into fused multiply-adds): IEEE division, no FMA.
#include <cuda_runtime.h>

namespace r3d {

__global__ void __launch_bounds__(128) tridiag_kernel(
    const float* __restrict__ wl, const float* __restrict__ wr, const float* __restrict__ diag,
    const float* __restrict__ rhs, float* __restrict__ out, float* __restrict__ cp,
    float* __restrict__ dp, int len, int count, long long step, long long sys) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= count) return;  // no shuffles or barriers: threads are independent
  const long long base = s * sys;
  float cpv = 0.0f, dpv = 0.0f;
  for (int t = 0; t < len; ++t) {
    const long long i = base + t * step;
    const float wli = wl[i];
    float den = __fadd_rn(diag[i], __fmul_rn(wli, cpv));
    if (fabsf(den) < 1e-12f) den = 1e-12f;
    const float inv = __fdiv_rn(1.0f, den);
    cpv = __fmul_rn(-wr[i], inv);
    dpv = __fmul_rn(__fadd_rn(rhs[i], __fmul_rn(wli, dpv)), inv);
    cp[i] = cpv;
    dp[i] = dpv;
  }
  float u = 0.0f;
  for (int t = len - 1; t >= 0; --t) {
    const long long i = base + t * step;
    u = __fsub_rn(dp[i], __fmul_rn(cp[i], u));
    out[i] = u;
  }
}

}  // namespace r3d

// All planes (n, m) f32, row-major. axis 0 solves down each column, axis 1
// along each row. cp and dp are (n, m) scratch. Returns a cudaError_t code.
extern "C" int r3d_tridiag(const float* wl, const float* wr, const float* diag, const float* rhs,
                           float* out, float* cp, float* dp, int n, int m, int axis,
                           cudaStream_t stream) {
  if (n < 1 || m < 1 || (axis != 0 && axis != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const int len = axis == 0 ? n : m;
  const int count = axis == 0 ? m : n;
  const long long step = axis == 0 ? m : 1;
  const long long sys = axis == 0 ? 1 : m;
  r3d::tridiag_kernel<<<(count + 127) / 128, 128, 0, stream>>>(wl, wr, diag, rhs, out, cp, dp,
                                                               len, count, step, sys);
  const cudaError_t e = cudaGetLastError();
  return static_cast<int>(e);
}

extern "C" const char* r3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
