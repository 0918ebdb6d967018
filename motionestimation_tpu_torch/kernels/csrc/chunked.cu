// Exact MSE full search by hoisted box sums for NVIDIA Hopper (sm_90a).
//
// Three extern "C" launchers, loaded with ctypes, on one kernel body:
//
// me_chunked_search — replaces the Pallas kernel `_kernel_f32`
//   (motionestimation_tpu/kernels/full_search_pallas.py:131, launched by
//   `_run_f32` :1238). Full interior blocks, any blk 1..16, span >= 0, with
//   an optional cost volume (the counterpart of its `emit_volume` mode).
// me_chunked_u8_search — replaces `_kernel_f32_bf16` (:348, launched by
//   `_run_f32` with operand_bf16): the same search with its operands staged
//   narrower (bf16) on the TPU. No volume (the TPU kernel has none). Here
//   every kernel already reads packed bytes, four to a 32-bit word, so it
//   launches me_chunked_search's own instance.
// me_wide_search — replaces `_kernel_f32_wide` (:471, launched by
//   `_run_f32_wide` :618). Full interior blocks, blk 24 or 32, span >= 0.
//
// Contract: that of full_search.cu (operands, global origin, validity,
// tie rule), for SSD only. Every block of the tile is whole and inside the
// frame, so the centre candidate is always valid. With a volume, vol[cand]
// is a [nby, out_ld] plane: each candidate's SSD, INT32_MAX where the
// candidate is invalid.
//
// Decomposition, the TPU kernels': SSD(d) = (Qcur - X(d)) + (Qref(d) - X(d))
//   Qcur    = Σ cur² over the block, once per block;
//   Qref(d) = Σ ref² over the candidate: a blk x blk box sum of ref²,
//             computed once for the whole reference window of a CUDA block
//             into a plane in shared memory;
//   X(d)    = Σ cur·ref(d), the only per-candidate work.
// Everything is exact in int32 (Qref <= 255² * 32² < 2^27), so the
// f32-exactness limits of the TPU kernels do not arise. `_kernel_f32_wide`
// builds Qref from 8-row part sums so that each float32 partial stays below
// 2^24; in int32 the parts only fix the order of exact additions, so the
// wide kernel takes Qref from the same sliding sums as the others.
//
// me_chunked_search, me_chunked_u8_search and me_wide_search are
// instances of the warp-per-macroblock body of warp_search.cuh (its note
// gives the design), the one me_phase_search and me_ssim_fast_search run:
// packed bytes and one __dp4a per four pixels, a warp per macroblock with
// its lanes over the candidates, no division and no barrier after staging,
// bank-skewed row strides, Qref from per-column sliding sums in the raw
// bytes' space. What bounds them: at 3840x2160, 7x7, +-15 the 168,784
// interior blocks need 1.62e8 block-candidates, 7.95 G pixel-candidates,
// against 2 bytes of frame per pixel, so shared-memory loads and integer
// issue, not device memory: per candidate at blk 7 the SASS holds 14
// __dp4a (2 words a row, 4 pixels each) and 15 shared loads (14 window
// words, one Qref word) among 61 instructions. Four vertically adjacent
// candidates per thread (each window row loaded once for four chains) ran
// no faster than one. At blk 24 and 32 the block's words are read from
// shared memory as 128-bit broadcasts, one load per four __dp4a. The JAX
// package's A/B between f32 and bf16 operand staging (`_kernel_f32` against
// `_kernel_f32_bf16`) has no counterpart here: both launchers run one
// instance.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "warp_search.cuh"

#define ME_BLK_1_TO_16(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) \
  CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

// SSD search of full interior blocks, 1 <= blk <= 16, span >= 0; vol is
// null or int32 [K*K][nby][out_ld]. Returns the cudaError_t of the launch
// (0 on success). nby, nbx >= 1.
extern "C" int me_chunked_search(const void* cur, const void* ref,
                                 void* out_cost, void* out_idx, void* vol,
                                 int cur_ld, int ref_ld, int out_ld, int nby,
                                 int nbx, int blk, int span, int frame_h,
                                 int frame_w, int y_origin, int x_origin,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (span < 0) return static_cast<int>(cudaErrorInvalidValue);
#define ME_CHUNKED_CASE(B)                                                 \
  case B:                                                                  \
    return me::launch_search<B, me::Form::kSsd>(                           \
        cur, ref, out_cost, out_idx, vol, cur_ld, ref_ld, out_ld, nby, nbx, \
        span, frame_h, frame_w, y_origin, x_origin, s);
  switch (blk) {
    ME_BLK_1_TO_16(ME_CHUNKED_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_CHUNKED_CASE
}

// me_chunked_search's resources for a grid of nbx macroblocks a row:
// out[5] = {registers per thread, local (spill) bytes per thread, dynamic
// shared memory bytes, macroblocks per CUDA block, resident CUDA blocks per
// SM}. Returns the cudaError_t of the queries.
extern "C" int me_chunked_occupancy(int blk, int span, int nbx, int* out) {
  if (span < 0 || nbx < 1) return static_cast<int>(cudaErrorInvalidValue);
#define ME_OCCUPANCY_CASE(B) \
  case B:                    \
    return me::search_occupancy<B, me::Form::kSsd>(nbx, span, out);
  switch (blk) {
    ME_BLK_1_TO_16(ME_OCCUPANCY_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_OCCUPANCY_CASE
}

// me_chunked_search without a volume, 1 <= blk <= 16, span >= 0.
extern "C" int me_chunked_u8_search(const void* cur, const void* ref,
                                    void* out_cost, void* out_idx, int cur_ld,
                                    int ref_ld, int out_ld, int nby, int nbx,
                                    int blk, int span, int frame_h,
                                    int frame_w, int y_origin, int x_origin,
                                    void* stream) {
  return me_chunked_search(cur, ref, out_cost, out_idx, nullptr, cur_ld,
                           ref_ld, out_ld, nby, nbx, blk, span, frame_h,
                           frame_w, y_origin, x_origin, stream);
}

// SSD search of full interior blocks, blk 24 or 32, span >= 0.
extern "C" int me_wide_search(const void* cur, const void* ref,
                              void* out_cost, void* out_idx, int cur_ld,
                              int ref_ld, int out_ld, int nby, int nbx,
                              int blk, int span, int frame_h, int frame_w,
                              int y_origin, int x_origin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (span < 0) return static_cast<int>(cudaErrorInvalidValue);
#define ME_WIDE_CASE(B)                                                    \
  case B:                                                                  \
    return me::launch_search<B, me::Form::kSsd>(                           \
        cur, ref, out_cost, out_idx, nullptr, cur_ld, ref_ld, out_ld, nby, \
        nbx, span, frame_h, frame_w, y_origin, x_origin, s);
  switch (blk) {
    ME_WIDE_CASE(24)
    ME_WIDE_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_WIDE_CASE
}

// me_wide_search's resources, out[5] as for me_chunked_occupancy.
extern "C" int me_wide_occupancy(int blk, int span, int nbx, int* out) {
  if (span < 0 || nbx < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (blk) {
    case 24:
      return me::search_occupancy<24, me::Form::kSsd>(nbx, span, out);
    case 32:
      return me::search_occupancy<32, me::Form::kSsd>(nbx, span, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
