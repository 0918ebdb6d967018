// Exact SSIM full-search block matching for NVIDIA Hopper (sm_90a).
//
// Two kernels, each behind an extern "C" launcher loaded with ctypes:
//
// me_ssim_fast_search — replaces the Pallas kernel `_kernel_ssim_fast`
//   (motionestimation_tpu/kernels/ssim_pallas.py:214, launched by
//   `_run_ssim_fast` :457). Full interior blocks, any blk <= 32, span >= 0.
// me_ssim_search — replaces the Pallas kernel `_kernel_ssim`
//   (ssim_pallas.py:48, launched by `_run_ssim` :163). Any blk, truncated
//   block extents (the last block row / column of a frame, or the whole
//   frame for blk > 32).
//
// Contract (shared with the plain PyTorch version in ssim_cuda.py):
//   cur:  uint8 [tile_h, tile_w] (row stride cur_ld), pixel (0, 0) at global
//         frame coordinates (y_origin, x_origin).
//   ref:  uint8 halo [tile_h + 2*span, tile_w + 2*span] (row stride ref_ld):
//         global reference pixel (y_origin + r - span, x_origin + c - span)
//         sits at [r, c], zero outside the frame.
//   out:  float32 score and int32 flat index per block, [nby, nbx] (row
//         stride out_ld).
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
// Score arithmetic. `ssim_score` evaluates the formula one IEEE float32
// operation at a time, in the order of the plain version
// (metrics/cost.py `ssim_from_sums`), using only the _rn intrinsics,
// __int2float_rn and __float2int_rz. nvcc never contracts those into FMAs
// (it does contract a*b + c written plainly), so the kernels' scores equal
// the plain version's bit for bit on the card and the argmax picks the same
// candidate. Σcur, Σcur² and the block's mean, truncated mean and standard
// deviation do not depend on the candidate and are taken once per block.
//
// The argmax under any thread order: a valid candidate with score > 0 is
// the 64-bit key ((0x7fffffff - bits(score)) << 32) | flat. Positive floats
// order like their bit patterns, so the minimum key (common.cuh) is the
// highest score, first in raster order.
//
// What bounds it. The fast kernel does K*K*blk*blk pixel-candidates per
// block (1.87 G at 3840x2160, 16x16, +-7) against 2 bytes of frame per
// pixel: integer arithmetic and shared-memory reads, not device memory.
// As in the phase kernel of full_search.cu, the tile's reference window is
// stored once for every byte offset (word o packs bytes o..o+3), so every
// candidate reads aligned words, and three __dp4a per four pixels give
// Σcur·ref, Σref² and Σref (the last against 0x01010101). All sums are
// exact in int32 (Σref² <= 255² * 1024 < 2^27 at blk 32): the TPU kernel's
// hi/lo float32 split and its box-sum pyramids are not needed. At small
// blk the score itself (six IEEE divisions and a square root per
// candidate) outweighs the sums. The truncated-extent kernel reads bytes
// one by one; it runs on thin edge slabs, where its time is small.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using me::kNoKey;
using me::kThreads;
using me::kWarps;
using me::reserve_smem;
using me::warp_store_min;

// The reference's constants (ssim.c:47), rounded to float32.
constexpr float kC1 = 0.01f;
constexpr float kC2 = 0.09f;
constexpr float kC3 = 0.045f;

// The integer parts are taken modulo 2^32, as int32 arithmetic wraps in
// the plain version; their true values fit in int32.
__device__ __forceinline__ int wrap(unsigned v) { return static_cast<int>(v); }

// Σ(x - M)² / N with M the float mean, centred on the truncated mean so
// that the int32 parts are exact and only the fractional correction rounds.
__device__ __forceinline__ float centred_var(int sum_x, int sum_sq, int imean,
                                             float mean, int n_i, float n) {
  const unsigned ui = imean, un = n_i;
  const int csq = wrap(unsigned(sum_sq) - 2u * ui * unsigned(sum_x) +
                       un * ui * ui);
  const int cs = wrap(unsigned(sum_x) - un * ui);
  const float frac = __fsub_rn(mean, __int2float_rn(imean));
  const float num = __fadd_rn(
      __fsub_rn(__int2float_rn(csq),
                __fmul_rn(__fmul_rn(2.0f, frac), __int2float_rn(cs))),
      __fmul_rn(__fmul_rn(n, frac), frac));
  return __fdiv_rn(num, n);
}

__device__ __forceinline__ float std_dev(float var) {
  return __fsqrt_rn(fmaxf(var, 0.0f));
}

// What the score needs of the current block, taken once per block.
struct CurStats {
  int sum;
  int n_i;     // max(count, 1)
  float n;
  float mean;
  int imean;   // the mean truncated toward zero
  float std;
};

__device__ __forceinline__ CurStats cur_stats(int sum_cur, int sum_sq_cur,
                                              int count) {
  CurStats c;
  c.sum = sum_cur;
  c.n_i = max(count, 1);
  c.n = __int2float_rn(c.n_i);
  c.mean = __fdiv_rn(__int2float_rn(sum_cur), c.n);
  c.imean = __float2int_rz(c.mean);
  c.std = std_dev(centred_var(sum_cur, sum_sq_cur, c.imean, c.mean, c.n_i, c.n));
  return c;
}

__device__ __forceinline__ float ssim_score(const CurStats& c, int sum_ref,
                                            int sum_sq_ref, int sum_cross,
                                            int count) {
  const float mean_ref = __fdiv_rn(__int2float_rn(sum_ref), c.n);
  const int imean_ref = __float2int_rz(mean_ref);
  const float std_ref = std_dev(
      centred_var(sum_ref, sum_sq_ref, imean_ref, mean_ref, c.n_i, c.n));
  const unsigned ic = c.imean, ir = imean_ref;
  const int cross_sum =
      wrap(unsigned(sum_cross) - ic * unsigned(sum_ref) - ir * unsigned(c.sum) +
           unsigned(count) * ir * ic);
  const float cross_var = __fdiv_rn(__int2float_rn(cross_sum), c.n);
  const float luminance = __fdiv_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(2.0f, mean_ref), c.mean), kC1),
      __fadd_rn(__fadd_rn(__fmul_rn(mean_ref, mean_ref),
                          __fmul_rn(c.mean, c.mean)),
                kC1));
  const float contrast = __fdiv_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(2.0f, std_ref), c.std), kC2),
      __fadd_rn(__fadd_rn(__fmul_rn(std_ref, std_ref), __fmul_rn(c.std, c.std)),
                kC2));
  const float structure = __fdiv_rn(__fadd_rn(cross_var, kC3),
                                    __fadd_rn(__fmul_rn(std_ref, c.std), kC3));
  return __fmul_rn(__fmul_rn(luminance, contrast), structure);
}

// The key of a candidate, or kNoKey unless its score is above 0.
__device__ __forceinline__ unsigned long long score_key(float score, int flat) {
  if (!(score > 0.0f)) return kNoKey;
  const unsigned inv = 0x7fffffffu - __float_as_uint(score);
  return (static_cast<unsigned long long>(inv) << 32) |
         static_cast<unsigned>(flat);
}

__device__ __forceinline__ void write_best(const unsigned long long* red,
                                           int slot, float* score,
                                           int32_t* idx, int centre) {
  const unsigned long long best = me::slot_min(red, slot);
  if (best == kNoKey) {
    *score = 0.0f;
    *idx = centre;
  } else {
    *score = __uint_as_float(0x7fffffffu - static_cast<unsigned>(best >> 32));
    *idx = static_cast<int32_t>(best & 0xffffffffu);
  }
}

// ---------------------------------------------------------------------------
// Fast kernel: full blocks, CW packed words per block row, `tbx` macroblocks
// per CUDA block along x. BLK is the block side when it is fixed at compile
// time (4, 8, 16, 32: loops unroll, and up to 16 the block's pixels stay in
// registers); 0 takes it from `blk_rt`, with (blk_rt + 3) / 4 == CW.
// grid = (ceil(nbx / tbx), nby).
template <int CW, int BLK>
__global__ void __launch_bounds__(kThreads)
ssim_fast_kernel(const uint8_t* __restrict__ cur, int cur_ld,
                 const uint8_t* __restrict__ ref, int ref_ld,
                 float* __restrict__ out_score, int32_t* __restrict__ out_idx,
                 int out_ld, int nbx, int tbx, int blk_rt, int span,
                 int frame_h, int frame_w, int y_origin, int x_origin) {
  constexpr bool kCurInRegs = BLK > 0 && BLK <= 16;
  const int blk = BLK > 0 ? BLK : blk_rt;
  // Bytes of the last word of a block row that belong to the block.
  const uint32_t last_mask =
      (blk & 3) ? (1u << (8 * (blk & 3))) - 1u : 0xffffffffu;

  extern __shared__ unsigned long long smem[];
  const int K = 2 * span + 1;
  const int KK = K * K;
  const int centre = span * K + span;
  const int count = blk * blk;
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * tbx;
  const int ntile = min(tbx, nbx - bx0);
  const int win_h = blk + 2 * span;
  const int win_w = tbx * blk + 2 * span;  // packed words per window row
  const int halo_w = nbx * blk + 2 * span;
  const int cur_words = tbx * CW;          // packed words per tile row

  unsigned long long* red = smem;                                    // [tbx*kWarps]
  uint32_t* win = reinterpret_cast<uint32_t*>(red + tbx * kWarps);   // [win_h*win_w]
  uint32_t* cblk = win + win_h * win_w;                              // [blk*cur_words]

  // Stage the reference window: win[r][o] packs halo bytes (r, o..o+3) of
  // the window, little-endian; bytes past the halo's used width are zero.
  const int wy0 = by * blk, wx0 = bx0 * blk;
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
  // Stage the current tile: CW words per macroblock row, zero past blk.
  for (int i = threadIdx.x; i < blk * cur_words; i += kThreads) {
    const int r = i / cur_words, w = i - r * cur_words;
    const int m = w / CW, ww = w - m * CW;
    uint32_t v = 0;
    if (m < ntile) {
      const uint8_t* p = cur + static_cast<size_t>(wy0 + r) * cur_ld +
                         (bx0 + m) * blk + 4 * ww;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * ww + b < blk) v |= static_cast<uint32_t>(p[b]) << (8 * b);
    }
    cblk[i] = v;
  }
  __syncthreads();

  const int gy = y_origin + by * blk;
  // Valid offsets o = d + span: 0 <= g + o - span <= frame - blk.
  const int oy_lo = max(0, span - gy);
  const int oy_hi = min(2 * span, frame_h - blk - gy + span);
  for (int m = 0; m < ntile; ++m) {
    const int gx = x_origin + (bx0 + m) * blk;
    const int ox_lo = max(0, span - gx);
    const int ox_hi = min(2 * span, frame_w - blk - gx + span);
    const uint32_t* cb = cblk + m * CW;  // row r at cb[r * cur_words]

    uint32_t creg[kCurInRegs ? BLK * CW : 1];
    uint32_t sum_c = 0, sum_c2 = 0;
#pragma unroll
    for (int r = 0; r < (BLK > 0 ? BLK : blk); ++r) {
#pragma unroll
      for (int w = 0; w < CW; ++w) {
        const uint32_t c = cb[r * cur_words + w];
        if constexpr (kCurInRegs) creg[r * CW + w] = c;
        sum_c = __dp4a(c, 0x01010101u, sum_c);
        sum_c2 = __dp4a(c, c, sum_c2);
      }
    }
    const CurStats cs = cur_stats(static_cast<int>(sum_c),
                                  static_cast<int>(sum_c2), count);

    unsigned long long best = kNoKey;
    for (int cand = threadIdx.x; cand < KK; cand += kThreads) {
      const int oy = cand / K, ox = cand - oy * K;
      if (oy < oy_lo || oy > oy_hi || ox < ox_lo || ox > ox_hi) continue;
      const uint32_t* wp = win + oy * win_w + m * blk + ox;
      uint32_t cross = 0, sum_r2 = 0, sum_r = 0;
#pragma unroll
      for (int r = 0; r < (BLK > 0 ? BLK : blk); ++r) {
#pragma unroll
        for (int w = 0; w < CW; ++w) {
          uint32_t c;
          if constexpr (kCurInRegs) {
            c = creg[r * CW + w];
          } else {
            c = cb[r * cur_words + w];
          }
          uint32_t x = wp[r * win_w + 4 * w];
          if (w == CW - 1) x &= last_mask;
          cross = __dp4a(c, x, cross);
          sum_r2 = __dp4a(x, x, sum_r2);
          sum_r = __dp4a(x, 0x01010101u, sum_r);
        }
      }
      const float score =
          ssim_score(cs, static_cast<int>(sum_r), static_cast<int>(sum_r2),
                     static_cast<int>(cross), count);
      const unsigned long long key = score_key(score, cand);
      best = key < best ? key : best;
    }
    warp_store_min(best, red, m);
  }
  __syncthreads();
  if (threadIdx.x < ntile) {
    const int m = threadIdx.x;
    const size_t o = static_cast<size_t>(by) * out_ld + bx0 + m;
    write_best(red, m, out_score + o, out_idx + o, centre);
  }
}

// ---------------------------------------------------------------------------
// Truncated-extent kernel: one macroblock per CUDA block, any blk, extents
// blk_h = clip(frame_h - tl_y, 0, blk) (likewise blk_w). grid = (nbx, nby).
__global__ void __launch_bounds__(kThreads)
ssim_search_kernel(const uint8_t* __restrict__ cur, int cur_ld,
                   const uint8_t* __restrict__ ref, int ref_ld,
                   float* __restrict__ out_score,
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
  unsigned long long best = kNoKey;
  for (int cand = threadIdx.x; cand < KK; cand += kThreads) {
    const int oy = cand / K, ox = cand - oy * K;
    if (oy < oy_lo || oy > oy_hi || ox < ox_lo || ox > ox_hi) continue;
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
    const unsigned long long key =
        score_key(ssim_score(cs, sum_r, sum_r2, cross, count), cand);
    best = key < best ? key : best;
  }
  warp_store_min(best, red, 0);
  __syncthreads();
  if (threadIdx.x == 0) {
    const size_t o = static_cast<size_t>(by) * out_ld + bx;
    write_best(red, 0, out_score + o, out_idx + o, centre);
  }
}

size_t fast_smem_bytes(int blk, int cw, int tbx, int span) {
  const size_t win =
      static_cast<size_t>(blk + 2 * span) * (tbx * blk + 2 * span);
  return sizeof(unsigned long long) * tbx * kWarps +
         sizeof(uint32_t) * (win + static_cast<size_t>(blk) * tbx * cw);
}

template <int CW, int BLK>
int launch_fast(const void* cur, const void* ref, void* out_score,
                void* out_idx, int cur_ld, int ref_ld, int out_ld, int nby,
                int nbx, int blk, int span, int frame_h, int frame_w,
                int y_origin, int x_origin, cudaStream_t stream) {
  auto kernel = ssim_fast_kernel<CW, BLK>;
  int tbx = blk >= 64 ? 1 : 64 / blk;  // ~64 pixels of macroblocks per tile
  if (tbx > nbx) tbx = nbx;
  size_t smem = fast_smem_bytes(blk, CW, tbx, span);
  while (!reserve_smem(kernel, smem) && tbx > 1) {
    tbx /= 2;
    smem = fast_smem_bytes(blk, CW, tbx, span);
  }
  if (!reserve_smem(kernel, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nbx + tbx - 1) / tbx, nby);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(cur), cur_ld,
      static_cast<const uint8_t*>(ref), ref_ld,
      static_cast<float*>(out_score), static_cast<int32_t*>(out_idx), out_ld,
      nbx, tbx, blk, span, frame_h, frame_w, y_origin, x_origin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). nby, nbx >= 1,
// 1 <= blk <= 32, span >= 0.
extern "C" int me_ssim_fast_search(const void* cur, const void* ref,
                                   void* out_score, void* out_idx, int cur_ld,
                                   int ref_ld, int out_ld, int nby, int nbx,
                                   int blk, int span, int frame_h,
                                   int frame_w, int y_origin, int x_origin,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ME_SSIM_FAST(CW, BLK)                                                 \
  return launch_fast<CW, BLK>(cur, ref, out_score, out_idx, cur_ld, ref_ld,   \
                              out_ld, nby, nbx, blk, span, frame_h, frame_w,  \
                              y_origin, x_origin, s)
  if (blk < 1 || blk > 32 || span < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (blk) {
    case 4: ME_SSIM_FAST(1, 4);
    case 8: ME_SSIM_FAST(2, 8);
    case 16: ME_SSIM_FAST(4, 16);
    case 32: ME_SSIM_FAST(8, 32);
    default: break;
  }
  switch ((blk + 3) / 4) {
    case 1: ME_SSIM_FAST(1, 0);
    case 2: ME_SSIM_FAST(2, 0);
    case 3: ME_SSIM_FAST(3, 0);
    case 4: ME_SSIM_FAST(4, 0);
    case 5: ME_SSIM_FAST(5, 0);
    case 6: ME_SSIM_FAST(6, 0);
    case 7: ME_SSIM_FAST(7, 0);
    default: ME_SSIM_FAST(8, 0);
  }
#undef ME_SSIM_FAST
}

extern "C" int me_ssim_search(const void* cur, const void* ref,
                              void* out_score, void* out_idx, int cur_ld,
                              int ref_ld, int out_ld, int nby, int nbx,
                              int blk, int span, int frame_h, int frame_w,
                              int y_origin, int x_origin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(unsigned long long) * kWarps +
                      static_cast<size_t>(blk + 2 * span) * (blk + 2 * span) +
                      static_cast<size_t>(blk) * blk;
  if (!reserve_smem(ssim_search_kernel, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  ssim_search_kernel<<<dim3(nbx, nby), kThreads, smem, s>>>(
      static_cast<const uint8_t*>(cur), cur_ld,
      static_cast<const uint8_t*>(ref), ref_ld,
      static_cast<float*>(out_score), static_cast<int32_t*>(out_idx), out_ld,
      blk, span, frame_h, frame_w, y_origin, x_origin);
  return static_cast<int>(cudaGetLastError());
}
