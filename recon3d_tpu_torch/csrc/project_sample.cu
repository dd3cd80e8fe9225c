// K9: the projective sampler of TSDF integration.
//
// Replaces recon3d_tpu/ops/project_sample.py:sample_images_at (kernel
// _mk_kernel, pallas_call at project_sample.py:131). Same function: for
// every voxel i of the (R, R, R) index volumes,
//   out[c, i] = images[c, vc[i], uc[i]]   for each channel c < C,
// with vc, uc already clipped to the (H, W) image by the caller
// (fusion/tsdf.py:_frame_contrib). TPU gathers serialize, so the TPU kernel
// selected each pixel from a 64 x 128 window of the image with a one-hot
// matmul (three bf16 passes to stay exact) and read 0 outside the window.
// On Hopper a gather is cheap: one thread a voxel reads its two indices once
// and copies the C channel values, so there is no window and no miss, and
// every value is a copy: the output is bitwise the plain version's
// images[:, vc, uc] (ops/project_sample.py:sample_images_plain).
//
// Bound on the H100: bytes. vc and uc are read once (8 B a voxel) and C
// floats written (4 C B a voxel): 134 MB in and 268 MB out at R = 256,
// C = 4. The image stack (4.9 MB at 640 x 480 x 4) stays in the 50 MB L2.
// Consecutive threads read consecutive indices and write consecutive
// floats of each of the C output rows (coalesced); neighboring voxels
// along z project to neighboring pixels, so the image reads are local.
// Offsets are 64-bit: at R = 512, C = 4 the output has 5.4e8 elements.
#include <cuda_runtime.h>

namespace r3d {

__global__ void __launch_bounds__(256) project_sample_kernel(
    const int* __restrict__ vc, const int* __restrict__ uc, const float* __restrict__ images,
    float* __restrict__ out, long long n, int C, int H, int W) {
  const long long hw = static_cast<long long>(H) * W;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long pix = static_cast<long long>(__ldg(vc + i)) * W + __ldg(uc + i);
    for (int c = 0; c < C; ++c) out[c * n + i] = __ldg(images + c * hw + pix);
  }
}

}  // namespace r3d

// vc, uc (n,) int32 pixel indices inside the image; images (C, H, W) f32;
// out (C, n) f32. Returns a cudaError_t code.
extern "C" int r3d_project_sample(const int* vc, const int* uc, const float* images, float* out,
                                  long long n, int C, int H, int W, cudaStream_t stream) {
  if (n < 1 || C < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + 255) / 256;
  const unsigned grid = static_cast<unsigned>(blocks < (1LL << 30) ? blocks : (1LL << 30));
  r3d::project_sample_kernel<<<grid, 256, 0, stream>>>(vc, uc, images, out, n, C, H, W);
  return static_cast<int>(cudaGetLastError());
}
