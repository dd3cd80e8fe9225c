// K7: the packed cell table of the voxel-grid moments path.
//
// Replaces recon3d_tpu/ops/grid_knn_pallas.py:_bin_points_packed_pallas
// (kernel _mk_pack_kernel, pallas_call at grid_knn_pallas.py:319). Same
// function: slot (cell, c) of the (cells * C, 4) table holds
//   [x, y, z, 1] of the cell-sorted point at pos = start[cell] + c
//                 while pos < start[cell + 1],
//   [0, 0, 0, 0] otherwise,
// where `start` (cells + 1 entries) and the sort come from
// ops/grid_knn.py:_sort_cells in torch, as they come from XLA on the TPU.
// The TPU DMA'd each block's window of sorted rows into VMEM and placed
// them with a one-hot selection matmul (three bf16 passes to stay exact),
// losing points when a block's run outgrew the static window. On Hopper a
// gather is cheap: one thread per slot reads its point directly, so there
// is no window and no window overflow, and each value is a copy: the table
// is bitwise the plain version's (grid_knn.pack_plain).
//
// Bound on the H100: bytes. The table is written once (16 B a slot: 268 MB
// at G = 128, C = 8) and every point read once (12 B); `start` is read
// twice a slot but C consecutive threads share a cell, so its reads hit
// cache. Consecutive threads write consecutive 16-byte rows (coalesced
// float4 stores); the point reads of a cell are consecutive too.
#include <cuda_runtime.h>

namespace r3d {

__global__ void __launch_bounds__(256) grid_pack_kernel(
    const float* __restrict__ sp, const int* __restrict__ start, float4* __restrict__ pk,
    int n_cells, int C) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n_cells) * C) return;
  const int cell = static_cast<int>(t / C);
  const int c = static_cast<int>(t - static_cast<long long>(cell) * C);
  const int pos = start[cell] + c;
  float4 row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (pos < start[cell + 1]) {
    const float* s = sp + 3LL * pos;
    row = make_float4(s[0], s[1], s[2], 1.0f);
  }
  pk[t] = row;
}

}  // namespace r3d

// sp (N, 3) f32 cell-sorted points; start (n_cells + 1,) int32; pk
// (n_cells * C, 4) f32 out. Returns a cudaError_t code.
extern "C" int r3d_grid_pack(const float* sp, const int* start, float* pk, int n_cells, int C,
                             cudaStream_t stream) {
  if (n_cells < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n_cells) * C;
  r3d::grid_pack_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      sp, start, reinterpret_cast<float4*>(pk), n_cells, C);
  return static_cast<int>(cudaGetLastError());
}
