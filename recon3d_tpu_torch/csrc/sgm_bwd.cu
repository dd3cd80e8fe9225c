// K3: backward-horizontal SGM path accumulated in place onto v1 -> v3.
//
// Replaces the backward scan of recon3d_tpu/depth/sgm_pallas.py:
// aggregate_and_finalize (kernel body _mk_hscan_kernel(reverse=True,
// accumulate=True), pallas_call at sgm_pallas.py:1094).
//
// Bound on the H100: bytes. It reads the int16 cost (535 MB at 1080p /
// D = 128) and v1 (1.07 GB) once and writes v3 (1.07 GB) over v1. One warp
// walks each row right to left (sgm_scan.cuh); the chunked loads keep
// several steps' reads in flight ahead of the carry chain.
#include "sgm_scan.cuh"

// cost (HP, WP, DP) int16, v (HP, WP, DP) f32 updated in place; p1, p2 in
// x2 cost units. Returns a cudaError_t code, 0 on success.
extern "C" int r3d_bwd_accumulate(const int16_t* cost, float* v, int HP, int WP, int DP,
                                  float p1, float p2, cudaStream_t stream) {
  if ((DP != 128 && DP != 256) || WP % r3d::kScanChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return r3d::launch_hscan(cost, v, v, HP, WP, DP, p1, p2, 1, stream);
}
