// Exact MSE full search by hoisted box sums for NVIDIA Hopper (sm_90a).
//
// Three kernels, each behind an extern "C" launcher loaded with ctypes:
//
// me_chunked_search — replaces the Pallas kernel `_kernel_f32`
//   (motionestimation_tpu/kernels/full_search_pallas.py:131, launched by
//   `_run_f32` :1238). Full interior blocks, any blk 1..16, span >= 0, with
//   an optional cost volume (the counterpart of its `emit_volume` mode).
// me_chunked_u8_search — replaces `_kernel_f32_bf16` (:348, launched by
//   `_run_f32` with operand_bf16). The same search with its operands staged
//   narrower: packed bytes, four to a 32-bit word. No volume (the TPU
//   kernel has none).
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
//             (row sums, then column sums) into a plane in shared memory;
//   X(d)    = Σ cur·ref(d), the only per-candidate work.
// Everything is exact in int32 (Qref <= 255² * 32² < 2^27), so the
// f32-exactness limits of the TPU kernels do not arise. `_kernel_f32_wide`
// builds Qref from 8-row part sums so that each float32 partial stays below
// 2^24; the wide kernel here adds the same 8-row parts, in int32, where the
// split only fixes the order of the additions.
//
// Design. As the phase kernel of full_search.cu: one CUDA block per row of
// `tbx` macroblocks stages the current pixels and the reference window they
// can reach in shared memory; its 128 threads split the K*K candidates of
// each macroblock and keep the best as the 64-bit key (cost << 32 | flat),
// reduced by common.cuh to "lowest cost, first in raster order".
//
// Staging. The chunked and wide kernels stage both operands 32 bits per
// pixel, as `_kernel_f32` stages float32: X is one integer multiply-add per
// pixel-candidate on one 32-bit shared load of the window, and any blk needs
// no tail mask. The block's pixels stay in registers up to blk 8; wider
// blocks are read four pixels at a time by a broadcast 128-bit shared load
// (inline PTX, so the compiler cannot hoist 64..256 of them into registers).
// The u8 kernel stages packed bytes on the phase kernel's byte-offset window
// (word o packs bytes o..o+3 of a window row), so every candidate reads
// aligned words and one __dp4a covers four pixels; the tail word of a block
// row is masked on both operands when blk % 4 != 0.
//
// What bounds it. K*K*blk*blk pixel-candidates per block (7.95 G at
// 3840x2160, 7x7, +-15) against 2 bytes of frame per pixel: shared-memory
// reads and integer issue, not device memory. Per pixel-candidate the
// 32-bit kernels issue one shared load and one IMAD; the u8 kernel a quarter
// of each. The volume adds K*K*4 bytes of stores per block, one candidate
// per thread: threads that split candidates write to different planes, so
// the stores are not coalesced.

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

// Four int32 from shared memory in one broadcast load, issued where it is
// written (not hoisted out of the candidate loop).
__device__ __forceinline__ int4 lds128(const int4* p) {
  int4 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

// The Qref plane: qref[oy][x] = Σ_{r < BLK} rows[oy + r][x] for oy < K,
// x < q_w, where rows[r][x] is the sum of ref² over window row r, columns
// x..x+BLK-1. The column sum adds PART-row parts (PART divides BLK).
template <int BLK, int PART>
__device__ __forceinline__ void column_box_sums(const int32_t* rows,
                                                int32_t* qref, int K,
                                                int q_w) {
  for (int i = threadIdx.x; i < K * q_w; i += kThreads) {
    const int oy = i / q_w, x = i - oy * q_w;
    const int32_t* col = rows + oy * q_w + x;
    int q = 0;
#pragma unroll
    for (int p = 0; p < BLK / PART; ++p) {
      int part = 0;
#pragma unroll
      for (int r = 0; r < PART; ++r) part += col[(p * PART + r) * q_w];
      q += part;
    }
    qref[i] = q;
  }
}

// Valid offsets o = d + span along one axis: 0 <= g + o - span <= frame - blk.
struct Range {
  int lo, hi;
};

__device__ __forceinline__ Range valid_offsets(int g, int span, int blk,
                                               int frame) {
  return {max(0, span - g), min(2 * span, frame - blk - g + span)};
}

// ---------------------------------------------------------------------------
// 32-bit staging (chunked and wide kernels). Shared memory, after the
// reduction slots: the block's pixels [tbx][BLK][CP] (CP = BLK rounded up
// to 4, zero past BLK), the window [win_h][win_w], its row sums of ref²
// [win_h][q_w] and the Qref plane [K][q_w]. grid = (ceil(nbx / tbx), nby).
template <int BLK, int PART>
__global__ void __launch_bounds__(kThreads)
box32_search_kernel(const uint8_t* __restrict__ cur, int cur_ld,
                    const uint8_t* __restrict__ ref, int ref_ld,
                    int32_t* __restrict__ out_cost,
                    int32_t* __restrict__ out_idx, int32_t* __restrict__ vol,
                    int out_ld, int nby, int nbx, int tbx, int span,
                    int frame_h, int frame_w, int y_origin, int x_origin) {
  constexpr int CQ = (BLK + 3) / 4;  // int4 per staged block row
  constexpr int CP = 4 * CQ;
  constexpr bool kCurInRegs = BLK <= 8;
  constexpr int kRowUnroll = BLK <= 16 ? BLK : 4;  // code size at blk 24, 32

  extern __shared__ unsigned long long smem[];
  const int K = 2 * span + 1;
  const int KK = K * K;
  const int centre = span * K + span;
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * tbx;
  const int ntile = min(tbx, nbx - bx0);
  const int win_h = BLK + 2 * span;
  const int win_w = tbx * BLK + 2 * span;
  const int q_w = win_w - BLK + 1;  // candidate top-left columns
  const int halo_w = nbx * BLK + 2 * span;

  unsigned long long* red = smem;                                   // [tbx*kWarps]
  int4* cblk = reinterpret_cast<int4*>(red + tbx * kWarps);         // [tbx*BLK*CQ]
  int32_t* win = reinterpret_cast<int32_t*>(cblk + tbx * BLK * CQ); // [win_h*win_w]
  int32_t* rows = win + win_h * win_w;                              // [win_h*q_w]
  int32_t* qref = rows + win_h * q_w;                               // [K*q_w]

  const int wy0 = by * BLK, wx0 = bx0 * BLK;
  for (int i = threadIdx.x; i < win_h * win_w; i += kThreads) {
    const int r = i / win_w, c = i - r * win_w;
    const int x = wx0 + c;
    win[i] = x < halo_w ? ref[static_cast<size_t>(wy0 + r) * ref_ld + x] : 0;
  }
  int32_t* cpix = reinterpret_cast<int32_t*>(cblk);
  for (int i = threadIdx.x; i < tbx * BLK * CP; i += kThreads) {
    const int m = i / (BLK * CP), rc = i - m * (BLK * CP);
    const int r = rc / CP, c = rc - r * CP;
    cpix[i] = m < ntile && c < BLK
                  ? cur[static_cast<size_t>(wy0 + r) * cur_ld +
                        (bx0 + m) * BLK + c]
                  : 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < win_h * q_w; i += kThreads) {
    const int r = i / q_w, x = i - r * q_w;
    const int32_t* w = win + r * win_w + x;
    int s = 0;
#pragma unroll
    for (int c = 0; c < BLK; ++c) s += w[c] * w[c];
    rows[i] = s;
  }
  __syncthreads();
  column_box_sums<BLK, PART>(rows, qref, K, q_w);
  __syncthreads();

  const Range oy_ok = valid_offsets(y_origin + by * BLK, span, BLK, frame_h);
  for (int m = 0; m < ntile; ++m) {
    const Range ox_ok =
        valid_offsets(x_origin + (bx0 + m) * BLK, span, BLK, frame_w);
    const int4* cb = cblk + m * BLK * CQ;  // row r at cb[r * CQ]
    int4 creg[kCurInRegs ? BLK * CQ : 1];
    int qcur = 0;
#pragma unroll
    for (int r = 0; r < BLK; ++r) {
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const int4 c = cb[r * CQ + q];
        if constexpr (kCurInRegs) creg[r * CQ + q] = c;
        qcur += c.x * c.x + c.y * c.y + c.z * c.z + c.w * c.w;
      }
    }
    int32_t* vrow = vol == nullptr
                        ? nullptr
                        : vol + static_cast<size_t>(by) * out_ld + bx0 + m;
    const size_t plane = static_cast<size_t>(nby) * out_ld;

    unsigned long long best = kNoKey;
    for (int cand = threadIdx.x; cand < KK; cand += kThreads) {
      const int oy = cand / K, ox = cand - oy * K;
      if (oy < oy_ok.lo || oy > oy_ok.hi || ox < ox_ok.lo || ox > ox_ok.hi) {
        if (vrow != nullptr) vrow[cand * plane] = kInt32Max;
        continue;
      }
      const int32_t* wp = win + oy * win_w + m * BLK + ox;
      int x = 0;
#pragma unroll kRowUnroll
      for (int r = 0; r < BLK; ++r) {
        const int32_t* w = wp + r * win_w;
#pragma unroll
        for (int q = 0; q < CQ; ++q) {
          int4 c;
          if constexpr (kCurInRegs) {
            c = creg[r * CQ + q];
          } else {
            c = lds128(cb + r * CQ + q);
          }
          x += c.x * w[4 * q];
          if (4 * q + 1 < BLK) x += c.y * w[4 * q + 1];
          if (4 * q + 2 < BLK) x += c.z * w[4 * q + 2];
          if (4 * q + 3 < BLK) x += c.w * w[4 * q + 3];
        }
      }
      const int cost = (qcur - x) + (qref[oy * q_w + m * BLK + ox] - x);
      if (vrow != nullptr) vrow[cand * plane] = cost;
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<uint32_t>(cost)) << 32) |
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

size_t box32_smem_bytes(int blk, int tbx, int span) {
  const size_t cp = (blk + 3) / 4 * 4;
  const size_t win_h = blk + 2 * span, win_w = tbx * blk + 2 * span;
  const size_t q_w = win_w - blk + 1, k = 2 * span + 1;
  return sizeof(unsigned long long) * tbx * kWarps +
         sizeof(int32_t) * (tbx * blk * cp + win_h * win_w + win_h * q_w +
                            k * q_w);
}

// ---------------------------------------------------------------------------
// Packed-byte staging (u8 kernel). Shared memory, after the reduction slots:
// the byte-offset window [win_h][win_w] (word o packs bytes o..o+3), the
// block's words [BLK][tbx * CW] (zero past BLK), the row sums of ref²
// [win_h][q_w] and the Qref plane [K][q_w]. grid = (ceil(nbx / tbx), nby).
template <int BLK>
__global__ void __launch_bounds__(kThreads)
u8_search_kernel(const uint8_t* __restrict__ cur, int cur_ld,
                 const uint8_t* __restrict__ ref, int ref_ld,
                 int32_t* __restrict__ out_cost,
                 int32_t* __restrict__ out_idx, int out_ld, int nbx, int tbx,
                 int span, int frame_h, int frame_w, int y_origin,
                 int x_origin) {
  constexpr int CW = (BLK + 3) / 4;  // packed words per block row
  constexpr uint32_t kLast = (BLK & 3) ? (1u << (8 * (BLK & 3))) - 1u
                                       : 0xffffffffu;

  extern __shared__ unsigned long long smem[];
  const int K = 2 * span + 1;
  const int KK = K * K;
  const int centre = span * K + span;
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * tbx;
  const int ntile = min(tbx, nbx - bx0);
  const int win_h = BLK + 2 * span;
  const int win_w = tbx * BLK + 2 * span;  // packed words per window row
  const int q_w = win_w - BLK + 1;
  const int halo_w = nbx * BLK + 2 * span;
  const int cur_words = tbx * CW;          // packed words per tile row

  unsigned long long* red = smem;                                   // [tbx*kWarps]
  uint32_t* win = reinterpret_cast<uint32_t*>(red + tbx * kWarps);  // [win_h*win_w]
  uint32_t* cblk = win + win_h * win_w;                             // [BLK*cur_words]
  int32_t* rows = reinterpret_cast<int32_t*>(cblk + BLK * cur_words);
  int32_t* qref = rows + win_h * q_w;                               // [K*q_w]

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
  for (int i = threadIdx.x; i < BLK * cur_words; i += kThreads) {
    const int r = i / cur_words, w = i - r * cur_words;
    const int m = w / CW, ww = w - m * CW;
    uint32_t v = 0;
    if (m < ntile) {
      const uint8_t* p = cur + static_cast<size_t>(wy0 + r) * cur_ld +
                         (bx0 + m) * BLK + 4 * ww;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * ww + b < BLK) v |= static_cast<uint32_t>(p[b]) << (8 * b);
    }
    cblk[i] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < win_h * q_w; i += kThreads) {
    const int r = i / q_w, x = i - r * q_w;
    const uint32_t* w = win + r * win_w + x;
    uint32_t s = 0;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const uint32_t v = c == CW - 1 ? w[4 * c] & kLast : w[4 * c];
      s = __dp4a(v, v, s);
    }
    rows[i] = static_cast<int32_t>(s);
  }
  __syncthreads();
  column_box_sums<BLK, BLK>(rows, qref, K, q_w);
  __syncthreads();

  const Range oy_ok = valid_offsets(y_origin + by * BLK, span, BLK, frame_h);
  for (int m = 0; m < ntile; ++m) {
    const Range ox_ok =
        valid_offsets(x_origin + (bx0 + m) * BLK, span, BLK, frame_w);
    const uint32_t* cb = cblk + m * CW;  // row r at cb[r * cur_words]
    uint32_t creg[BLK * CW];
    uint32_t qcur = 0;
#pragma unroll
    for (int r = 0; r < BLK; ++r) {
#pragma unroll
      for (int w = 0; w < CW; ++w) {
        creg[r * CW + w] = cb[r * cur_words + w];
        qcur = __dp4a(creg[r * CW + w], creg[r * CW + w], qcur);
      }
    }

    unsigned long long best = kNoKey;
    for (int cand = threadIdx.x; cand < KK; cand += kThreads) {
      const int oy = cand / K, ox = cand - oy * K;
      if (oy < oy_ok.lo || oy > oy_ok.hi || ox < ox_ok.lo || ox > ox_ok.hi)
        continue;
      const uint32_t* wp = win + oy * win_w + m * BLK + ox;
      uint32_t x = 0;
#pragma unroll
      for (int r = 0; r < BLK; ++r) {
#pragma unroll
        for (int w = 0; w < CW; ++w) {
          uint32_t v = wp[r * win_w + 4 * w];
          if (w == CW - 1) v &= kLast;
          x = __dp4a(creg[r * CW + w] & (w == CW - 1 ? kLast : 0xffffffffu),
                     v, x);
        }
      }
      const int xi = static_cast<int>(x);
      const int cost = (static_cast<int>(qcur) - xi) +
                       (qref[oy * q_w + m * BLK + ox] - xi);
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<uint32_t>(cost)) << 32) |
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

size_t u8_smem_bytes(int blk, int tbx, int span) {
  const size_t cw = (blk + 3) / 4;
  const size_t win_h = blk + 2 * span, win_w = tbx * blk + 2 * span;
  const size_t q_w = win_w - blk + 1, k = 2 * span + 1;
  return sizeof(unsigned long long) * tbx * kWarps +
         sizeof(uint32_t) * (win_h * win_w + blk * tbx * cw + win_h * q_w +
                             k * q_w);
}

template <int BLK, int PART>
int launch_box32(const void* cur, const void* ref, void* out_cost,
                 void* out_idx, void* vol, int cur_ld, int ref_ld, int out_ld,
                 int nby, int nbx, int span, int frame_h, int frame_w,
                 int y_origin, int x_origin, cudaStream_t stream) {
  auto kernel = box32_search_kernel<BLK, PART>;
  int tbx = 64 / BLK;  // ~64 pixels of macroblocks per tile
  if (tbx > nbx) tbx = nbx;
  size_t smem = box32_smem_bytes(BLK, tbx, span);
  while (!reserve_smem(kernel, smem) && tbx > 1) {
    tbx /= 2;
    smem = box32_smem_bytes(BLK, tbx, span);
  }
  if (!reserve_smem(kernel, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nbx + tbx - 1) / tbx, nby);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(cur), cur_ld,
      static_cast<const uint8_t*>(ref), ref_ld,
      static_cast<int32_t*>(out_cost), static_cast<int32_t*>(out_idx),
      static_cast<int32_t*>(vol), out_ld, nby, nbx, tbx, span, frame_h,
      frame_w, y_origin, x_origin);
  return static_cast<int>(cudaGetLastError());
}

template <int BLK>
int launch_u8(const void* cur, const void* ref, void* out_cost,
              void* out_idx, int cur_ld, int ref_ld, int out_ld, int nby,
              int nbx, int span, int frame_h, int frame_w, int y_origin,
              int x_origin, cudaStream_t stream) {
  auto kernel = u8_search_kernel<BLK>;
  int tbx = 64 / BLK;  // ~64 pixels of macroblocks per tile
  if (tbx > nbx) tbx = nbx;
  size_t smem = u8_smem_bytes(BLK, tbx, span);
  while (!reserve_smem(kernel, smem) && tbx > 1) {
    tbx /= 2;
    smem = u8_smem_bytes(BLK, tbx, span);
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

}  // namespace

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
#define ME_CHUNKED_CASE(B)                                                  \
  case B:                                                                   \
    return launch_box32<B, B>(cur, ref, out_cost, out_idx, vol, cur_ld,     \
                              ref_ld, out_ld, nby, nbx, span, frame_h,      \
                              frame_w, y_origin, x_origin, s);
  switch (blk) {
    ME_BLK_1_TO_16(ME_CHUNKED_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_CHUNKED_CASE
}

// The same search on packed-byte operands, 1 <= blk <= 16, span >= 0.
extern "C" int me_chunked_u8_search(const void* cur, const void* ref,
                                    void* out_cost, void* out_idx, int cur_ld,
                                    int ref_ld, int out_ld, int nby, int nbx,
                                    int blk, int span, int frame_h,
                                    int frame_w, int y_origin, int x_origin,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (span < 0) return static_cast<int>(cudaErrorInvalidValue);
#define ME_U8_CASE(B)                                                       \
  case B:                                                                   \
    return launch_u8<B>(cur, ref, out_cost, out_idx, cur_ld, ref_ld,        \
                        out_ld, nby, nbx, span, frame_h, frame_w, y_origin, \
                        x_origin, s);
  switch (blk) {
    ME_BLK_1_TO_16(ME_U8_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_U8_CASE
}

// SSD search of full interior blocks, blk 24 or 32, span >= 0, with Qref
// from 8-row parts.
extern "C" int me_wide_search(const void* cur, const void* ref,
                              void* out_cost, void* out_idx, int cur_ld,
                              int ref_ld, int out_ld, int nby, int nbx,
                              int blk, int span, int frame_h, int frame_w,
                              int y_origin, int x_origin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (span < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (blk) {
    case 24:
      return launch_box32<24, 8>(cur, ref, out_cost, out_idx, nullptr, cur_ld,
                                 ref_ld, out_ld, nby, nbx, span, frame_h,
                                 frame_w, y_origin, x_origin, s);
    case 32:
      return launch_box32<32, 8>(cur, ref, out_cost, out_idx, nullptr, cur_ld,
                                 ref_ld, out_ld, nby, nbx, span, frame_h,
                                 frame_w, y_origin, x_origin, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
