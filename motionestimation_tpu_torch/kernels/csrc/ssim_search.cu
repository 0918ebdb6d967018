// Exact SSIM full-search block matching with truncated block extents for
// NVIDIA Hopper (sm_90a).
//
// me_ssim_search — replaces the Pallas kernel `_kernel_ssim`
//   (motionestimation_tpu/kernels/ssim_pallas.py:48, launched by
//   `_run_ssim` :163). Any blk, truncated block extents: the last block row
//   and column of a frame, or the whole frame for blk > 32, with an
//   optional score volume (the edge slabs of the whole-frame volume, which
//   the JAX package computes with its golden tile search,
//   ssim_pallas.py:852-874).
//
// Contract: ssim.cu's (operands, global origin, validity, the highest
// score above 0 first in raster order, score 0 and the centre index
// without one, -inf at invalid volume entries), with extents bh =
// clip(frame_h - tl_y, 0, blk) and bw = clip(frame_w - tl_x, 0, blk).
// Scores come from exact int32 sums through ssim_score.cuh's step-by-step
// float32, so they equal the plain version's bit for bit.
//
// The body is edge_search.cuh (its note gives the design): packed bytes;
// per four pixels one __dp4a for Σcur·ref and two on the window word masked
// to the block's width for Σref and Σref²; Σcur, Σcur² and the score's
// block terms once per macroblock; a warp per macroblock over its valid
// candidates only, warps sharing a macroblock on the thin edge slabs. What
// bounds it: K*K*bh*bw pixel-candidates per block against 2 bytes of frame
// per pixel, so shared-memory loads and integer issue; at small blocks the
// score (six IEEE divisions and a square root per candidate).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "edge_search.cuh"

// vol: null, or float32 [K*K][nby][out_ld] to receive every candidate's
// score. Returns the cudaError_t of the launch (0 on success). nby, nbx >=
// 1, blk >= 1, span >= 0.
extern "C" int me_ssim_search(const void* cur, const void* ref,
                              void* out_score, void* out_idx, void* vol,
                              int cur_ld, int ref_ld, int out_ld, int nby,
                              int nbx, int blk, int span, int frame_h,
                              int frame_w, int y_origin, int x_origin,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blk < 1 || span < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int cw = blk <= 32 ? (blk + 3) / 4 : 0;
#define ME_SSIM_LAUNCH(EMIT, C)                                             \
  me::edge::launch_edge<me::Form::kSsim, C, EMIT>(                          \
      cur, ref, out_score, out_idx, vol, cur_ld, ref_ld, out_ld, nby, nbx,  \
      blk, span, frame_h, frame_w, y_origin, x_origin, s)
#define ME_SSIM_CASE(C)                                                     \
  case C:                                                                   \
    return vol != nullptr ? ME_SSIM_LAUNCH(true, C)                         \
                          : ME_SSIM_LAUNCH(false, C);
  switch (cw) {
    ME_EDGE_CW(ME_SSIM_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_SSIM_CASE
#undef ME_SSIM_LAUNCH
}

// me_ssim_search's resources (no volume) for an [nby, nbx] grid, as
// me_int_occupancy (int_search.cu) reports them.
extern "C" int me_ssim_occupancy(int blk, int span, int nby, int nbx,
                                 int* out) {
  if (blk < 1 || span < 0 || nby < 1 || nbx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cw = blk <= 32 ? (blk + 3) / 4 : 0;
#define ME_OCCUPANCY_CASE(C)                                         \
  case C:                                                            \
    return me::edge::edge_occupancy<me::Form::kSsim, C>(nby, nbx, blk, \
                                                        span, out);
  switch (cw) {
    ME_EDGE_CW(ME_OCCUPANCY_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_OCCUPANCY_CASE
}
