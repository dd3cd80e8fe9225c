// K14: the standalone forward-horizontal and downward SGM path scans.
//
// Replaces the two scans recon3d_tpu/depth/sgm_pallas.py:
// aggregate_and_finalize runs when it is given no v1 (sgm_pallas.py:
// 1064-1087): the forward scan (kernel body _mk_hscan_kernel(reverse=False,
// accumulate=False), pallas_call at sgm_pallas.py:1067) and the downward
// scan accumulated onto it (_mk_vscan_kernel(reverse=False), pallas_call at
// sgm_pallas.py:1077). They are the scans K2 runs after its cost stage, so
// both launchers are sgm_scan.cuh's warp-per-line scans over a given cost
// volume.
//
// Bound on the H100: bytes. The forward scan reads the int16 cost (535 MB at
// 1080p / D = 128) and writes v1 (1.07 GB); the downward scan reads the cost
// and v1 and writes v1 back.
#include "sgm_scan.cuh"

// cost (HP, WP, DP) int16; v1 (HP, WP, DP) f32, written whole. p1, p2 in x2
// cost units. Returns a cudaError_t code, 0 on success.
extern "C" int r3d_fwd_scan(const int16_t* cost, float* v1, int HP, int WP, int DP, float p1,
                            float p2, cudaStream_t stream) {
  if ((DP != 128 && DP != 256) || WP % r3d::kScanChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return r3d::launch_hscan(cost, nullptr, v1, HP, WP, DP, p1, p2, 0, stream);
}

// v (HP, WP, DP) f32 updated in place: v += L_down.
extern "C" int r3d_down_accumulate(const int16_t* cost, float* v, int HP, int WP, int DP,
                                   float p1, float p2, cudaStream_t stream) {
  if ((DP != 128 && DP != 256) || HP % r3d::kScanChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return r3d::launch_vscan(cost, v, HP, WP, DP, p1, p2, 0, stream);
}
