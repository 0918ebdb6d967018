// Exact full-search block matching (SSD or SAD) with truncated block
// extents for NVIDIA Hopper (sm_90a).
//
// me_int_search — replaces the Pallas kernel `_kernel_int`
//   (motionestimation_tpu/kernels/full_search_pallas.py:1076, launched by
//   `_run_int` :1178). Any blk, truncated block extents: the last block row
//   and column of a frame, or the whole frame where no interior kernel
//   applies (SAD outside the phase kernel's blk, span 0; MSE at blk 17-23,
//   25-31 and above 32), with an optional cost volume (the edge slabs of
//   the whole-frame volume, or the whole volume of a SAD config outside the
//   phase kernel, which the JAX package computes with its golden tile
//   search, :1922-1949).
//
// Contract: full_search.cu's (operands, global origin, validity, tie rule,
// INT32_MAX and the centre index without a valid candidate, INT32_MAX at
// invalid volume entries), with extents bh = clip(frame_h - tl_y, 0, blk)
// and bw = clip(frame_w - tl_x, 0, blk).
//
// The body is edge_search.cuh (its note gives the design): packed bytes,
// one VABSDIFF4 with accumulate (SAD) or VABSDIFF4 and __dp4a (SSD) per
// four pixels, the row's tail word masked to the block's width, a warp
// per macroblock over its valid candidates only, warps sharing a
// macroblock on the thin edge slabs. What bounds it: K*K*bh*bw
// pixel-candidates per block against 2 bytes of frame per pixel, so
// shared-memory loads and integer issue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "edge_search.cuh"

// metric: 0 = SSD (MSE search), 1 = SAD. vol: null, or int32
// [K*K][nby][out_ld] to receive every candidate's cost. Returns the
// cudaError_t of the launch (0 on success). nby, nbx >= 1, blk >= 1,
// span >= 0.
extern "C" int me_int_search(const void* cur, const void* ref, void* out_cost,
                             void* out_idx, void* vol, int cur_ld,
                             int ref_ld, int out_ld, int nby, int nbx,
                             int blk, int span, int metric, int frame_h,
                             int frame_w, int y_origin, int x_origin,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blk < 1 || span < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int cw = blk <= 32 ? (blk + 3) / 4 : 0;
#define ME_INT_LAUNCH(F, EMIT, C)                                           \
  me::edge::launch_edge<me::Form::F, C, EMIT>(                              \
      cur, ref, out_cost, out_idx, vol, cur_ld, ref_ld, out_ld, nby, nbx,   \
      blk, span, frame_h, frame_w, y_origin, x_origin, s)
#define ME_INT_CASE(C)                                                      \
  case C:                                                                   \
    if (metric == 1)                                                        \
      return vol != nullptr ? ME_INT_LAUNCH(kSad, true, C)                  \
                            : ME_INT_LAUNCH(kSad, false, C);                \
    return vol != nullptr ? ME_INT_LAUNCH(kSsd, true, C)                    \
                          : ME_INT_LAUNCH(kSsd, false, C);
  switch (cw) {
    ME_EDGE_CW(ME_INT_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_INT_CASE
#undef ME_INT_LAUNCH
}

// me_int_search's resources (metric as there, no volume) for an [nby, nbx]
// grid: out[5] = {registers per thread, local (spill) bytes per thread,
// dynamic shared memory bytes, macroblocks per CUDA block, resident CUDA
// blocks per SM}. Returns the cudaError_t of the queries.
extern "C" int me_int_occupancy(int blk, int span, int metric, int nby,
                                int nbx, int* out) {
  if (blk < 1 || span < 0 || nby < 1 || nbx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cw = blk <= 32 ? (blk + 3) / 4 : 0;
#define ME_OCCUPANCY_CASE(C)                                               \
  case C:                                                                  \
    return metric == 1 ? me::edge::edge_occupancy<me::Form::kSad, C>(      \
                             nby, nbx, blk, span, out)                     \
                       : me::edge::edge_occupancy<me::Form::kSsd, C>(      \
                             nby, nbx, blk, span, out);
  switch (cw) {
    ME_EDGE_CW(ME_OCCUPANCY_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_OCCUPANCY_CASE
}
