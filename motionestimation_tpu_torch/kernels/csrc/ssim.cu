// Exact SSIM full-search block matching for NVIDIA Hopper (sm_90a).
//
// Two kernels, each behind an extern "C" launcher loaded with ctypes:
//
// me_ssim_fast_search — replaces the Pallas kernel `_kernel_ssim_fast`
//   (motionestimation_tpu/kernels/ssim_pallas.py:214, launched by
//   `_run_ssim_fast` :457). Full interior blocks, any blk <= 32, span >= 0,
//   with an optional score volume (its `emit_volume` mode, :357-442).
// me_ssim_search — replaces the Pallas kernel `_kernel_ssim`
//   (ssim_pallas.py:48, launched by `_run_ssim` :163). Any blk, truncated
//   block extents (the last block row / column of a frame, or the whole
//   frame for blk > 32), with an optional score volume (the edge slabs of
//   the whole-frame volume, which the JAX package computes with its golden
//   tile search, ssim_pallas.py:852-874).
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
//
// The truncated-extent kernel reads bytes one by one; it runs on thin edge
// slabs, where its time is small. The volume (separate template instances
// of both kernels; the search instances are unchanged) adds one 4-byte
// store per candidate, invalid ones included; the threads that split a
// block's candidates store to different planes, so the stores are not
// coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "ssim_score.cuh"
#include "warp_search.cuh"

namespace {

using me::CurStats;
using me::cur_stats;
using me::kNegInfBits;
using me::kNoKey;
using me::kThreads;
using me::kWarps;
using me::reserve_smem;
using me::score_key;
using me::ssim_score;
using me::warp_store_min;

__device__ __forceinline__ void write_best(const unsigned long long* red,
                                           int slot, float* score,
                                           int32_t* idx, int centre) {
  const unsigned long long best = me::slot_min(red, slot);
  if (best == kNoKey) {
    *score = 0.0f;
    *idx = centre;
  } else {
    *score = me::key_score(best);
    *idx = static_cast<int32_t>(best & 0xffffffffu);
  }
}

// ---------------------------------------------------------------------------
// Truncated-extent kernel: one macroblock per CUDA block, any blk, extents
// blk_h = clip(frame_h - tl_y, 0, blk) (likewise blk_w). EMIT writes every
// candidate's score to `vol`. grid = (nbx, nby).
template <bool EMIT>
__global__ void __launch_bounds__(kThreads)
ssim_search_kernel(const uint8_t* __restrict__ cur, int cur_ld,
                   const uint8_t* __restrict__ ref, int ref_ld,
                   float* __restrict__ out_score,
                   int32_t* __restrict__ out_idx, float* __restrict__ vol,
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
  const int count = bh * bw;
  const int win_h = bh + 2 * span, win_w = bw + 2 * span;

  unsigned long long* red = smem;                           // [kWarps]
  uint8_t* win = reinterpret_cast<uint8_t*>(red + kWarps);  // [win_h*win_w]
  uint8_t* cb = win + win_h * win_w;                        // [bh*bw]

  for (int i = threadIdx.x; i < win_h * win_w; i += kThreads) {
    const int r = i / win_w, c = i - r * win_w;
    win[i] = ref[static_cast<size_t>(by * blk + r) * ref_ld + bx * blk + c];
  }
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int r = i / bw, c = i - r * bw;
    cb[i] = cur[static_cast<size_t>(by * blk + r) * cur_ld + bx * blk + c];
  }
  __syncthreads();

  // Every thread takes the block's own sums (count bytes): cheap beside
  // the K*K*count of the candidates.
  int sum_c = 0, sum_c2 = 0;
  for (int i = 0; i < count; ++i) {
    const int c = cb[i];
    sum_c += c;
    sum_c2 += c * c;
  }
  const CurStats cs = cur_stats(sum_c, sum_c2, count);

  const int oy_lo = max(0, span - gy);
  const int oy_hi = min(2 * span, frame_h - bh - gy + span);
  const int ox_lo = max(0, span - gx);
  const int ox_hi = min(2 * span, frame_w - bw - gx + span);
  float* vrow = EMIT ? vol + static_cast<size_t>(by) * out_ld + bx : nullptr;
  const size_t plane = static_cast<size_t>(nby) * out_ld;
  unsigned long long best = kNoKey;
  for (int cand = threadIdx.x; cand < KK; cand += kThreads) {
    const int oy = cand / K, ox = cand - oy * K;
    if (oy < oy_lo || oy > oy_hi || ox < ox_lo || ox > ox_hi) {
      if constexpr (EMIT) vrow[cand * plane] = __uint_as_float(kNegInfBits);
      continue;
    }
    int sum_r = 0, sum_r2 = 0, cross = 0;
    for (int r = 0; r < bh; ++r) {
      const uint8_t* wr = win + (oy + r) * win_w + ox;
      const uint8_t* cr = cb + r * bw;
      for (int x = 0; x < bw; ++x) {
        const int v = wr[x];
        sum_r += v;
        sum_r2 += v * v;
        cross += v * static_cast<int>(cr[x]);
      }
    }
    const float score = ssim_score(cs, sum_r, sum_r2, cross, count);
    if constexpr (EMIT) vrow[cand * plane] = score;
    const unsigned long long key = score_key(score, cand);
    best = key < best ? key : best;
  }
  warp_store_min(best, red, 0);
  __syncthreads();
  if (threadIdx.x == 0) {
    const size_t o = static_cast<size_t>(by) * out_ld + bx;
    write_best(red, 0, out_score + o, out_idx + o, centre);
  }
}

template <bool EMIT>
int launch_truncated(const void* cur, const void* ref, void* out_score,
                     void* out_idx, void* vol, int cur_ld, int ref_ld,
                     int out_ld, int nby, int nbx, int blk, int span,
                     int frame_h, int frame_w, int y_origin, int x_origin,
                     cudaStream_t stream) {
  const size_t smem = sizeof(unsigned long long) * kWarps +
                      static_cast<size_t>(blk + 2 * span) * (blk + 2 * span) +
                      static_cast<size_t>(blk) * blk;
  if (!reserve_smem(ssim_search_kernel<EMIT>, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  ssim_search_kernel<EMIT><<<dim3(nbx, nby), kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(cur), cur_ld,
      static_cast<const uint8_t*>(ref), ref_ld,
      static_cast<float*>(out_score), static_cast<int32_t*>(out_idx),
      static_cast<float*>(vol), out_ld, nby, blk, span, frame_h, frame_w,
      y_origin, x_origin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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

// vol as for me_ssim_fast_search.
extern "C" int me_ssim_search(const void* cur, const void* ref,
                              void* out_score, void* out_idx, void* vol,
                              int cur_ld, int ref_ld, int out_ld, int nby,
                              int nbx, int blk, int span, int frame_h,
                              int frame_w, int y_origin, int x_origin,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vol != nullptr)
    return launch_truncated<true>(cur, ref, out_score, out_idx, vol, cur_ld,
                                  ref_ld, out_ld, nby, nbx, blk, span,
                                  frame_h, frame_w, y_origin, x_origin, s);
  return launch_truncated<false>(cur, ref, out_score, out_idx, vol, cur_ld,
                                 ref_ld, out_ld, nby, nbx, blk, span, frame_h,
                                 frame_w, y_origin, x_origin, s);
}
