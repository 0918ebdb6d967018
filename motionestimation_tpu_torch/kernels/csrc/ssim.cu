// Exact SSIM full-search block matching for NVIDIA Hopper (sm_90a).
//
// me_ssim_fast_search — replaces the Pallas kernel `_kernel_ssim_fast`
//   (motionestimation_tpu/kernels/ssim_pallas.py:214, launched by
//   `_run_ssim_fast` :457). Full interior blocks, any blk <= 32, span >= 0,
//   with an optional score volume (its `emit_volume` mode, :357-442),
//   behind an extern "C" launcher loaded with ctypes. Blocks with truncated
//   extents go to me_ssim_search (ssim_search.cu).
//
// Contract (shared with the plain PyTorch version in ssim_cuda.py):
//   cur:  uint8 [tile_h, tile_w] (row stride cur_ld), pixel (0, 0) at global
//         frame coordinates (y_origin, x_origin).
//   ref:  uint8 halo [tile_h + 2*span, tile_w + 2*span] (row stride ref_ld):
//         global reference pixel (y_origin + r - span, x_origin + c - span)
//         sits at [r, c], zero outside the frame.
//   out:  float32 score and int32 flat index per block, [nby, nbx] (row
//         stride out_ld).
//   vol:  (optional) float32 [K*K][nby][out_ld]: every candidate's raw
//         score, scores <= 0 included, and -inf where it is invalid.
//   A displacement d (per axis, in [-span, span]) is valid iff
//   0 <= tl + d <= frame - extent. Its score is the SSIM of the block's
//   in-frame pixels (extent = clip(frame - tl, 0, blk) per axis) and the
//   candidate window over the same extent, from the exact int32 sums
//   Σcur, Σcur², Σref, Σref², Σcur·ref and the pixel count. The winner is
//   the highest score above 0, ties going to the lowest flat raster index
//   (dy + span) * K + (dx + span): the reference's scan with strict `>`
//   from a best score of 0. A block where no candidate scores above 0 gets
//   score 0 and the centre index span * K + span.
//
// Score arithmetic: ssim_score.cuh, one IEEE float32 operation at a time in
// the plain version's order, so kernel and plain version agree bit for bit.
//
// me_ssim_fast_search is the SSIM instance of the warp-per-macroblock body
// of warp_search.cuh (its note gives the design), the one me_phase_search,
// me_chunked_search and me_wide_search run, with every blk 1..32 a
// compile-time instance, search and emit. What bounds it: K*K*blk*blk
// pixel-candidates per block (1.87 G at 3840x2160, 16x16, +-7) against 2
// bytes of frame per pixel, so integer issue, shared-memory loads and the
// float score, not device memory. Per candidate it does one window load
// and one __dp4a per four pixels (Σcur·ref; the block's bytes past blk
// are zero), one 64-bit load of (Σref, Σref²) from a plane of sliding
// sums built once per CUDA block, and the score: the TPU kernel's hoisted
// box-sum planes, exact in int32 (Σref² <= 255² * 1024 < 2^27), so its
// hi/lo float32 split is not needed. A warp owns a macroblock, its lanes
// step through the candidates in raster order with no division, rows are
// bank-skewed, and the block's terms of the score are taken once per
// macroblock. At small blk the score (three IEEE divisions where the
// pixel count is a power of two, else six, and a square root) outweighs
// the sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "ssim_score.cuh"
#include "warp_search.cuh"

#define ME_BLK_1_TO_32(CASE)                                                \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9)   \
  CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16) CASE(17)   \
  CASE(18) CASE(19) CASE(20) CASE(21) CASE(22) CASE(23) CASE(24) CASE(25)   \
  CASE(26) CASE(27) CASE(28) CASE(29) CASE(30) CASE(31) CASE(32)

// vol: null, or float32 [K*K][nby][out_ld] to receive every candidate's
// score. Returns the cudaError_t of the launch (0 on success). nby, nbx >= 1,
// 1 <= blk <= 32, span >= 0.
extern "C" int me_ssim_fast_search(const void* cur, const void* ref,
                                   void* out_score, void* out_idx, void* vol,
                                   int cur_ld, int ref_ld, int out_ld,
                                   int nby, int nbx, int blk, int span,
                                   int frame_h, int frame_w, int y_origin,
                                   int x_origin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (span < 0) return static_cast<int>(cudaErrorInvalidValue);
#define ME_SSIM_FAST_CASE(B)                                               \
  case B:                                                                  \
    return me::launch_search<B, me::Form::kSsim>(                          \
        cur, ref, out_score, out_idx, vol, cur_ld, ref_ld, out_ld, nby,    \
        nbx, span, frame_h, frame_w, y_origin, x_origin, s);
  switch (blk) {
    ME_BLK_1_TO_32(ME_SSIM_FAST_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_SSIM_FAST_CASE
}

// me_ssim_fast_search's resources (no volume) for a grid of nbx
// macroblocks a row: out[5] = {registers per thread, local (spill) bytes
// per thread, dynamic shared memory bytes, macroblocks per CUDA block,
// resident CUDA blocks per SM}. Returns the cudaError_t of the queries.
extern "C" int me_ssim_fast_occupancy(int blk, int span, int nbx, int* out) {
  if (span < 0 || nbx < 1) return static_cast<int>(cudaErrorInvalidValue);
#define ME_OCCUPANCY_CASE(B) \
  case B:                    \
    return me::search_occupancy<B, me::Form::kSsim>(nbx, span, out);
  switch (blk) {
    ME_BLK_1_TO_32(ME_OCCUPANCY_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_OCCUPANCY_CASE
}
