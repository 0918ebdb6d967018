// Exact full-search block matching (SSD or SAD) for NVIDIA Hopper (sm_90a).
//
// Two kernels, each behind an extern "C" launcher loaded with ctypes:
//
// me_phase_search — replaces the Pallas kernel `_kernel_phase`
//   (motionestimation_tpu/kernels/full_search_pallas.py:729, launched by
//   `_run_phase` :953). Full interior blocks, blk in {1, 2, 4, 8, 16, 32},
//   with an optional cost volume (its `emit_volume` mode, :872-888).
// me_int_search — replaces the Pallas kernel `_kernel_int`
//   (full_search_pallas.py:1076, launched by `_run_int` :1178). Any blk,
//   truncated block extents (the last block row / column of a frame, or
//   the whole frame where the phase kernel does not apply), with an
//   optional cost volume (the edge slabs of the whole-frame volume, which
//   the JAX package computes with its golden tile search, :1922-1949).
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
// What bounds them. The work is K*K*blk*blk pixel-candidates per block (5.2
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
//
// The int kernel handles any extent byte by byte: it runs on thin edge
// slabs, where its time is small. It keeps each thread's best candidate as
// the 64-bit key (cost << 32 | flat); the minimum key over the CUDA block
// (warp shuffles, then shared memory) is exactly "lowest cost, first in
// raster order", whatever order the threads ran in. A volume (separate
// template instances in both kernels) adds one 4-byte store per
// candidate; lanes store to different planes, so the stores are not
// coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "warp_search.cuh"

namespace {

using me::kNoKey;
using me::kThreads;
using me::kWarps;
using me::reserve_smem;
using me::warp_store_min;
constexpr int kInt32Max = 0x7fffffff;

__device__ __forceinline__ void write_best(const unsigned long long* red,
                                           int slot, int32_t* cost,
                                           int32_t* idx, int centre) {
  const unsigned long long best = me::slot_min(red, slot);
  if (best == kNoKey) {
    *cost = kInt32Max;
    *idx = centre;
  } else {
    *cost = static_cast<int32_t>(best >> 32);
    *idx = static_cast<int32_t>(best & 0xffffffffu);
  }
}

// ---------------------------------------------------------------------------
// Int kernel: one macroblock per CUDA block, any blk, truncated extents
// blk_h = clip(frame_h - tl_y, 0, blk) (likewise blk_w). EMIT writes every
// candidate's cost to `vol`. grid = (nbx, nby).
template <bool SAD, bool EMIT>
__global__ void __launch_bounds__(kThreads)
int_search_kernel(const uint8_t* __restrict__ cur, int cur_ld,
                  const uint8_t* __restrict__ ref, int ref_ld,
                  int32_t* __restrict__ out_cost,
                  int32_t* __restrict__ out_idx, int32_t* __restrict__ vol,
                  int out_ld, int nby, int blk, int span, int frame_h,
                  int frame_w, int y_origin, int x_origin) {
  extern __shared__ unsigned long long smem[];
  const int K = 2 * span + 1;
  const int KK = K * K;
  const int centre = span * K + span;
  const int by = blockIdx.y, bx = blockIdx.x;
  const int gy = y_origin + by * blk, gx = x_origin + bx * blk;
  const int bh = max(0, min(blk, frame_h - gy));
  const int bw = max(0, min(blk, frame_w - gx));
  const int win_h = bh + 2 * span, win_w = bw + 2 * span;

  unsigned long long* red = smem;                           // [kWarps]
  uint8_t* win = reinterpret_cast<uint8_t*>(red + kWarps);  // [win_h*win_w]
  uint8_t* cb = win + win_h * win_w;                        // [bh*bw]

  for (int i = threadIdx.x; i < win_h * win_w; i += kThreads) {
    const int r = i / win_w, c = i - r * win_w;
    win[i] = ref[static_cast<size_t>(by * blk + r) * ref_ld + bx * blk + c];
  }
  for (int i = threadIdx.x; i < bh * bw; i += kThreads) {
    const int r = i / bw, c = i - r * bw;
    cb[i] = cur[static_cast<size_t>(by * blk + r) * cur_ld + bx * blk + c];
  }
  __syncthreads();

  const int oy_lo = max(0, span - gy);
  const int oy_hi = min(2 * span, frame_h - bh - gy + span);
  const int ox_lo = max(0, span - gx);
  const int ox_hi = min(2 * span, frame_w - bw - gx + span);
  int32_t* vrow = EMIT ? vol + static_cast<size_t>(by) * out_ld + bx : nullptr;
  const size_t plane = static_cast<size_t>(nby) * out_ld;
  unsigned long long best = kNoKey;
  for (int cand = threadIdx.x; cand < KK; cand += kThreads) {
    const int oy = cand / K, ox = cand - oy * K;
    if (oy < oy_lo || oy > oy_hi || ox < ox_lo || ox > ox_hi) {
      if constexpr (EMIT) vrow[cand * plane] = kInt32Max;
      continue;
    }
    int acc = 0;
    for (int r = 0; r < bh; ++r) {
      const uint8_t* wr = win + (oy + r) * win_w + ox;
      const uint8_t* cr = cb + r * bw;
      for (int x = 0; x < bw; ++x) {
        const int d = static_cast<int>(cr[x]) - static_cast<int>(wr[x]);
        acc += SAD ? abs(d) : d * d;
      }
    }
    if constexpr (EMIT) vrow[cand * plane] = acc;
    const unsigned long long key =
        (static_cast<unsigned long long>(static_cast<uint32_t>(acc)) << 32) |
        static_cast<unsigned>(cand);
    best = key < best ? key : best;
  }
  warp_store_min(best, red, 0);
  __syncthreads();
  if (threadIdx.x == 0) {
    const size_t o = static_cast<size_t>(by) * out_ld + bx;
    write_best(red, 0, out_cost + o, out_idx + o, centre);
  }
}

template <bool SAD, bool EMIT>
int launch_int(const void* cur, const void* ref, void* out_cost,
               void* out_idx, void* vol, int cur_ld, int ref_ld, int out_ld,
               int nby, int nbx, int blk, int span, int frame_h, int frame_w,
               int y_origin, int x_origin, cudaStream_t stream) {
  const size_t smem = sizeof(unsigned long long) * kWarps +
                      static_cast<size_t>(blk + 2 * span) * (blk + 2 * span) +
                      static_cast<size_t>(blk) * blk;
  if (!reserve_smem(int_search_kernel<SAD, EMIT>, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  int_search_kernel<SAD, EMIT><<<dim3(nbx, nby), kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(cur), cur_ld,
      static_cast<const uint8_t*>(ref), ref_ld,
      static_cast<int32_t*>(out_cost), static_cast<int32_t*>(out_idx),
      static_cast<int32_t*>(vol), out_ld, nby, blk, span, frame_h, frame_w,
      y_origin, x_origin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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

// metric and vol as for me_phase_search.
extern "C" int me_int_search(const void* cur, const void* ref, void* out_cost,
                             void* out_idx, void* vol, int cur_ld,
                             int ref_ld, int out_ld, int nby, int nbx,
                             int blk, int span, int metric, int frame_h,
                             int frame_w, int y_origin, int x_origin,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ME_INT_LAUNCH(SAD, EMIT)                                              \
  return launch_int<SAD, EMIT>(cur, ref, out_cost, out_idx, vol, cur_ld,      \
                               ref_ld, out_ld, nby, nbx, blk, span, frame_h,  \
                               frame_w, y_origin, x_origin, s)
  if (metric == 1) {
    if (vol != nullptr) ME_INT_LAUNCH(true, true);
    ME_INT_LAUNCH(true, false);
  }
  if (vol != nullptr) ME_INT_LAUNCH(false, true);
  ME_INT_LAUNCH(false, false);
#undef ME_INT_LAUNCH
}
