// Exact full-search block matching (SSD or SAD) for NVIDIA Hopper (sm_90a).
//
// me_phase_search — replaces the Pallas kernel `_kernel_phase`
//   (motionestimation_tpu/kernels/full_search_pallas.py:729, launched by
//   `_run_phase` :953). Full interior blocks, blk in {1, 2, 4, 8, 16, 32},
//   with an optional cost volume (its `emit_volume` mode, :872-888), behind
//   an extern "C" launcher loaded with ctypes. Blocks with truncated
//   extents go to me_int_search (int_search.cu).
//
// Contract (shared with the plain PyTorch version in full_search_cuda.py):
//   cur:  uint8 [tile_h, tile_w] (row stride cur_ld), pixel (0, 0) at global
//         frame coordinates (y_origin, x_origin).
//   ref:  uint8 halo [tile_h + 2*span, tile_w + 2*span] (row stride ref_ld):
//         global reference pixel (y_origin + r - span, x_origin + c - span)
//         sits at [r, c], zero outside the frame.
//   out:  int32 cost and flat index per block, [nby, nbx] (row stride out_ld).
//   vol:  (optional) int32 [K*K][nby][out_ld]: every candidate's cost,
//         INT32_MAX where the candidate is invalid.
//   A displacement d (per axis, in [-span, span]) is valid iff
//   0 <= tl + d <= frame - extent, with tl in global coordinates. The cost
//   is the exact int32 SSD or SAD over the block's in-frame pixels. The
//   winner is the lowest cost, ties going to the lowest flat raster index
//   (dy + span) * K + (dx + span). A block with no valid candidate gets
//   INT32_MAX and the centre index span * K + span.
//
// What bounds it. The work is K*K*blk*blk pixel-candidates per block (5.2
// G at 3840x2160, 8x8, +-12) against 2 bytes of frame per pixel: integer
// issue and shared-memory reads, not device memory.
//
// The phase kernel is the warp-per-macroblock body of warp_search.cuh (its
// note gives the design), the one me_chunked_search and me_wide_search
// run: the reference window staged once per byte offset from its raw
// bytes, so every candidate reads aligned words and one __dp4a (SSD, as
// (Qcur - X) + (Qref - X) with the Qref plane from sliding sums) or one
// VABSDIFF4 with accumulate (SAD) covers four pixels; a warp per
// macroblock with its lanes over the candidates, no division and no
// barrier after staging; bank-skewed row strides. The block's words stay
// in registers up to blk 16 and are read as 128-bit shared broadcasts at
// blk 32. At 4K 8x8 +-12 the SASS holds 16 __dp4a and 17 shared loads
// among 66 instructions per candidate: one shared load per __dp4a, and
// the load pipe (one warp-wide load per SM per clock) is the first limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "warp_search.cuh"

#define ME_PHASE_BLOCKS(CASE) CASE(1) CASE(2) CASE(4) CASE(8) CASE(16) CASE(32)

// metric: 0 = SSD (MSE search), 1 = SAD. vol: null, or int32
// [K*K][nby][out_ld] to receive every candidate's cost. Returns the
// cudaError_t of the launch (0 on success). nby, nbx >= 1.
extern "C" int me_phase_search(const void* cur, const void* ref,
                               void* out_cost, void* out_idx, void* vol,
                               int cur_ld, int ref_ld, int out_ld, int nby,
                               int nbx, int blk, int span, int metric,
                               int frame_h, int frame_w, int y_origin,
                               int x_origin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (span < 0) return static_cast<int>(cudaErrorInvalidValue);
#define ME_PHASE_CASE(B)                                                   \
  case B:                                                                  \
    return metric == 1                                                     \
               ? me::launch_search<B, me::Form::kSad>(                     \
                     cur, ref, out_cost, out_idx, vol, cur_ld, ref_ld,     \
                     out_ld, nby, nbx, span, frame_h, frame_w, y_origin,   \
                     x_origin, s)                                          \
               : me::launch_search<B, me::Form::kSsd>(                     \
                     cur, ref, out_cost, out_idx, vol, cur_ld, ref_ld,     \
                     out_ld, nby, nbx, span, frame_h, frame_w, y_origin,   \
                     x_origin, s);
  switch (blk) {
    ME_PHASE_BLOCKS(ME_PHASE_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_PHASE_CASE
}

// me_phase_search's resources (metric as there, no volume) for a grid of
// nbx macroblocks a row: out[5] = {registers per thread, local (spill)
// bytes per thread, dynamic shared memory bytes, macroblocks per CUDA
// block, resident CUDA blocks per SM}. Returns the cudaError_t of the
// queries.
extern "C" int me_phase_occupancy(int blk, int span, int metric, int nbx,
                                  int* out) {
  if (span < 0 || nbx < 1) return static_cast<int>(cudaErrorInvalidValue);
#define ME_OCCUPANCY_CASE(B)                                         \
  case B:                                                            \
    return metric == 1                                               \
               ? me::search_occupancy<B, me::Form::kSad>(nbx, span, out) \
               : me::search_occupancy<B, me::Form::kSsd>(nbx, span, out);
  switch (blk) {
    ME_PHASE_BLOCKS(ME_OCCUPANCY_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_OCCUPANCY_CASE
}
