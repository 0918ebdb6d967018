// Exact full-search block matching (SSD or SAD) for NVIDIA Hopper (sm_90a).
//
// Two kernels, each behind an extern "C" launcher loaded with ctypes:
//
// me_phase_search — replaces the Pallas kernel `_kernel_phase`
//   (motionestimation_tpu/kernels/full_search_pallas.py:729, launched by
//   `_run_phase` :953). Full interior blocks, blk in {1, 2, 4, 8, 16, 32}.
// me_int_search — replaces the Pallas kernel `_kernel_int`
//   (full_search_pallas.py:1076, launched by `_run_int` :1178). Any blk,
//   truncated block extents (the last block row / column of a frame, or
//   the whole frame where the phase kernel does not apply).
//
// Contract (shared with the plain PyTorch version in full_search_cuda.py):
//   cur:  uint8 [tile_h, tile_w] (row stride cur_ld), pixel (0, 0) at global
//         frame coordinates (y_origin, x_origin).
//   ref:  uint8 halo [tile_h + 2*span, tile_w + 2*span] (row stride ref_ld):
//         global reference pixel (y_origin + r - span, x_origin + c - span)
//         sits at [r, c], zero outside the frame.
//   out:  int32 cost and flat index per block, [nby, nbx] (row stride out_ld).
//   A displacement d (per axis, in [-span, span]) is valid iff
//   0 <= tl + d <= frame - extent, with tl in global coordinates. The cost
//   is the exact int32 SSD or SAD over the block's in-frame pixels. The
//   winner is the lowest cost, ties going to the lowest flat raster index
//   (dy + span) * K + (dx + span). A block with no valid candidate gets
//   INT32_MAX and the centre index span * K + span.
//
// Design. One CUDA block stages the current pixels of a tile of
// macroblocks and the reference window they can reach,
// (tile + 2*span) on each side, in shared memory. The 128 threads split the
// K*K candidates of each macroblock. Each thread keeps its best candidate
// as the 64-bit key (cost << 32 | flat); the minimum key over the CUDA
// block (warp shuffles, then shared memory) is exactly "lowest cost, first
// in raster order", whatever order the threads ran in.
//
// What bounds it. The work is K*K*blk*blk pixel-candidates per block (5.2 G
// at 3840x2160, 8x8, +-12) against 8 bytes of frame per pixel: integer
// arithmetic and shared-memory reads, not device memory. The phase kernel
// therefore packs four pixels in one 32-bit word: the reference window is
// stored once for every byte offset (word o holds bytes o..o+3), so every
// candidate reads aligned words, and one __dp4a (four byte products
// summed into int32) or __vsadu4 covers four pixels. SSD is
// sum(c^2) + sum(r^2) - 2*sum(c*r), exact in 32 bits for blk <= 32
// (sum(r^2) <= 255^2 * 1024 < 2^27). For blk <= 16 the macroblock's current
// pixels stay in registers. The int kernel handles any extent byte by
// byte: it runs on thin edge slabs, where its time is small.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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
// Phase kernel: full blocks of side BLK, `tbx` macroblocks per CUDA block
// along x. grid = (ceil(nbx / tbx), nby).
template <int BLK, bool SAD>
__global__ void __launch_bounds__(kThreads)
phase_search_kernel(const uint8_t* __restrict__ cur, int cur_ld,
                    const uint8_t* __restrict__ ref, int ref_ld,
                    int32_t* __restrict__ out_cost,
                    int32_t* __restrict__ out_idx, int out_ld, int nbx,
                    int tbx, int span, int frame_h, int frame_w, int y_origin,
                    int x_origin) {
  constexpr int CW = BLK >= 4 ? BLK / 4 : 1;  // words per block row
  constexpr int PX = BLK >= 4 ? 4 : BLK;      // pixels per word
  constexpr uint32_t kMask = BLK >= 4 ? 0xffffffffu : (1u << (8 * BLK)) - 1u;
  constexpr bool kCurInRegs = BLK <= 16;

  extern __shared__ unsigned long long smem[];
  const int K = 2 * span + 1;
  const int KK = K * K;
  const int centre = span * K + span;
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * tbx;
  const int ntile = min(tbx, nbx - bx0);
  const int win_h = BLK + 2 * span;
  const int win_w = tbx * BLK + 2 * span;  // packed words per window row
  const int halo_w = nbx * BLK + 2 * span;
  const int cur_words = tbx * CW;          // packed words per tile row

  unsigned long long* red = smem;                                    // [tbx*kWarps]
  uint32_t* win = reinterpret_cast<uint32_t*>(red + tbx * kWarps);   // [win_h*win_w]
  uint32_t* cblk = win + win_h * win_w;                              // [BLK*cur_words]

  // Stage the reference window: win[r][o] packs halo bytes (r, o..o+3) of
  // the window, little-endian; bytes past the halo's used width are zero.
  const int wy0 = by * BLK, wx0 = bx0 * BLK;
  for (int i = threadIdx.x; i < win_h * win_w; i += kThreads) {
    const int r = i / win_w, o = i - r * win_w;
    const uint8_t* p = ref + static_cast<size_t>(wy0 + r) * ref_ld;
    const int x = wx0 + o;
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (x + b < halo_w) v |= static_cast<uint32_t>(p[x + b]) << (8 * b);
    win[i] = v;
  }
  // Stage the current tile: CW words per macroblock row, PX pixels each.
  for (int i = threadIdx.x; i < BLK * cur_words; i += kThreads) {
    const int r = i / cur_words, w = i - r * cur_words;
    const int m = w / CW, ww = w - m * CW;
    uint32_t v = 0;
    if (m < ntile) {
      const uint8_t* p = cur + static_cast<size_t>(wy0 + r) * cur_ld +
                         (bx0 + m) * BLK + 4 * ww;
#pragma unroll
      for (int b = 0; b < PX; ++b) v |= static_cast<uint32_t>(p[b]) << (8 * b);
    }
    cblk[i] = v;
  }
  __syncthreads();

  const int gy = y_origin + by * BLK;
  // Valid offsets o = d + span: 0 <= g + o - span <= frame - BLK.
  const int oy_lo = max(0, span - gy);
  const int oy_hi = min(2 * span, frame_h - BLK - gy + span);
  for (int m = 0; m < ntile; ++m) {
    const int gx = x_origin + (bx0 + m) * BLK;
    const int ox_lo = max(0, span - gx);
    const int ox_hi = min(2 * span, frame_w - BLK - gx + span);
    const uint32_t* cb = cblk + m * CW;  // row r at cb[r * cur_words]

    uint32_t creg[kCurInRegs ? BLK * CW : 1];
    uint32_t sum_c2 = 0;
#pragma unroll
    for (int r = 0; r < BLK; ++r) {
#pragma unroll
      for (int w = 0; w < CW; ++w) {
        const uint32_t c = cb[r * cur_words + w];
        if constexpr (kCurInRegs) creg[r * CW + w] = c;
        if constexpr (!SAD) sum_c2 = __dp4a(c, c, sum_c2);
      }
    }

    unsigned long long best = kNoKey;
    for (int cand = threadIdx.x; cand < KK; cand += kThreads) {
      const int oy = cand / K, ox = cand - oy * K;
      if (oy < oy_lo || oy > oy_hi || ox < ox_lo || ox > ox_hi) continue;
      const uint32_t* wp = win + oy * win_w + m * BLK + ox;
      uint32_t acc = 0, cross = 0, sum_r2 = 0;
#pragma unroll
      for (int r = 0; r < BLK; ++r) {
#pragma unroll
        for (int w = 0; w < CW; ++w) {
          uint32_t c;
          if constexpr (kCurInRegs) {
            c = creg[r * CW + w];
          } else {
            c = cb[r * cur_words + w];
          }
          const uint32_t x = wp[r * win_w + 4 * w] & kMask;
          if constexpr (SAD) {
            acc += __vsadu4(c, x);
          } else {
            cross = __dp4a(c, x, cross);
            sum_r2 = __dp4a(x, x, sum_r2);
          }
        }
      }
      if constexpr (!SAD) acc = sum_c2 + sum_r2 - 2u * cross;
      const unsigned long long key =
          (static_cast<unsigned long long>(acc) << 32) |
          static_cast<unsigned>(cand);
      best = key < best ? key : best;
    }
    warp_store_min(best, red, m);
  }
  __syncthreads();
  if (threadIdx.x < ntile) {
    const int m = threadIdx.x;
    const size_t o = static_cast<size_t>(by) * out_ld + bx0 + m;
    write_best(red, m, out_cost + o, out_idx + o, centre);
  }
}

// ---------------------------------------------------------------------------
// Int kernel: one macroblock per CUDA block, any blk, truncated extents
// blk_h = clip(frame_h - tl_y, 0, blk) (likewise blk_w). grid = (nbx, nby).
template <bool SAD>
__global__ void __launch_bounds__(kThreads)
int_search_kernel(const uint8_t* __restrict__ cur, int cur_ld,
                  const uint8_t* __restrict__ ref, int ref_ld,
                  int32_t* __restrict__ out_cost,
                  int32_t* __restrict__ out_idx, int out_ld, int blk,
                  int span, int frame_h, int frame_w, int y_origin,
                  int x_origin) {
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
  unsigned long long best = kNoKey;
  for (int cand = threadIdx.x; cand < KK; cand += kThreads) {
    const int oy = cand / K, ox = cand - oy * K;
    if (oy < oy_lo || oy > oy_hi || ox < ox_lo || ox > ox_hi) continue;
    int acc = 0;
    for (int r = 0; r < bh; ++r) {
      const uint8_t* wr = win + (oy + r) * win_w + ox;
      const uint8_t* cr = cb + r * bw;
      for (int x = 0; x < bw; ++x) {
        const int d = static_cast<int>(cr[x]) - static_cast<int>(wr[x]);
        acc += SAD ? abs(d) : d * d;
      }
    }
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

size_t phase_smem_bytes(int blk, int tbx, int span) {
  const int cw = blk >= 4 ? blk / 4 : 1;
  const size_t win = static_cast<size_t>(blk + 2 * span) * (tbx * blk + 2 * span);
  return sizeof(unsigned long long) * tbx * kWarps +
         sizeof(uint32_t) * (win + static_cast<size_t>(blk) * tbx * cw);
}

template <int BLK, bool SAD>
int launch_phase(const void* cur, const void* ref, void* out_cost,
                 void* out_idx, int cur_ld, int ref_ld, int out_ld, int nby,
                 int nbx, int span, int frame_h, int frame_w, int y_origin,
                 int x_origin, cudaStream_t stream) {
  auto kernel = phase_search_kernel<BLK, SAD>;
  int tbx = BLK >= 64 ? 1 : 64 / BLK;  // ~64 pixels of macroblocks per tile
  if (tbx > nbx) tbx = nbx;
  size_t smem = phase_smem_bytes(BLK, tbx, span);
  while (!reserve_smem(kernel, smem) && tbx > 1) {
    tbx /= 2;
    smem = phase_smem_bytes(BLK, tbx, span);
  }
  if (!reserve_smem(kernel, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nbx + tbx - 1) / tbx, nby);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(cur), cur_ld,
      static_cast<const uint8_t*>(ref), ref_ld,
      static_cast<int32_t*>(out_cost), static_cast<int32_t*>(out_idx), out_ld,
      nbx, tbx, span, frame_h, frame_w, y_origin, x_origin);
  return static_cast<int>(cudaGetLastError());
}

template <int BLK>
int dispatch_phase_metric(int metric, const void* cur, const void* ref,
                          void* out_cost, void* out_idx, int cur_ld,
                          int ref_ld, int out_ld, int nby, int nbx, int span,
                          int frame_h, int frame_w, int y_origin, int x_origin,
                          cudaStream_t stream) {
  if (metric == 1)
    return launch_phase<BLK, true>(cur, ref, out_cost, out_idx, cur_ld, ref_ld,
                                   out_ld, nby, nbx, span, frame_h, frame_w,
                                   y_origin, x_origin, stream);
  return launch_phase<BLK, false>(cur, ref, out_cost, out_idx, cur_ld, ref_ld,
                                  out_ld, nby, nbx, span, frame_h, frame_w,
                                  y_origin, x_origin, stream);
}

}  // namespace

// metric: 0 = SSD (MSE search), 1 = SAD. Returns the cudaError_t of the
// launch (0 on success). nby, nbx >= 1.
extern "C" int me_phase_search(const void* cur, const void* ref,
                               void* out_cost, void* out_idx, int cur_ld,
                               int ref_ld, int out_ld, int nby, int nbx,
                               int blk, int span, int metric, int frame_h,
                               int frame_w, int y_origin, int x_origin,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ME_PHASE_CASE(B)                                                    \
  case B:                                                                   \
    return dispatch_phase_metric<B>(metric, cur, ref, out_cost, out_idx,    \
                                    cur_ld, ref_ld, out_ld, nby, nbx, span, \
                                    frame_h, frame_w, y_origin, x_origin, s);
  switch (blk) {
    ME_PHASE_CASE(1)
    ME_PHASE_CASE(2)
    ME_PHASE_CASE(4)
    ME_PHASE_CASE(8)
    ME_PHASE_CASE(16)
    ME_PHASE_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_PHASE_CASE
}

extern "C" int me_int_search(const void* cur, const void* ref, void* out_cost,
                             void* out_idx, int cur_ld, int ref_ld,
                             int out_ld, int nby, int nbx, int blk, int span,
                             int metric, int frame_h, int frame_w,
                             int y_origin, int x_origin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(unsigned long long) * kWarps +
                      static_cast<size_t>(blk + 2 * span) * (blk + 2 * span) +
                      static_cast<size_t>(blk) * blk;
  const dim3 grid(nbx, nby);
  if (metric == 1) {
    if (!reserve_smem(int_search_kernel<true>, smem))
      return static_cast<int>(cudaErrorInvalidValue);
    int_search_kernel<true><<<grid, kThreads, smem, s>>>(
        static_cast<const uint8_t*>(cur), cur_ld,
        static_cast<const uint8_t*>(ref), ref_ld,
        static_cast<int32_t*>(out_cost), static_cast<int32_t*>(out_idx),
        out_ld, blk, span, frame_h, frame_w, y_origin, x_origin);
  } else {
    if (!reserve_smem(int_search_kernel<false>, smem))
      return static_cast<int>(cudaErrorInvalidValue);
    int_search_kernel<false><<<grid, kThreads, smem, s>>>(
        static_cast<const uint8_t*>(cur), cur_ld,
        static_cast<const uint8_t*>(ref), ref_ld,
        static_cast<int32_t*>(out_cost), static_cast<int32_t*>(out_idx),
        out_ld, blk, span, frame_h, frame_w, y_origin, x_origin);
  }
  return static_cast<int>(cudaGetLastError());
}
