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
//             into a plane in shared memory;
//   X(d)    = Σ cur·ref(d), the only per-candidate work.
// Everything is exact in int32 (Qref <= 255² * 32² < 2^27), so the
// f32-exactness limits of the TPU kernels do not arise. `_kernel_f32_wide`
// builds Qref from 8-row part sums so that each float32 partial stays below
// 2^24; in int32 the parts only fix the order of exact additions, so the
// wide kernel takes Qref from the same sliding sums as the others.
//
// me_chunked_search and me_wide_search are instances of the
// warp-per-macroblock body of warp_search.cuh (its note gives the design),
// the one me_phase_search runs: packed bytes and one __dp4a per four
// pixels, a warp per macroblock with its lanes over the candidates, no
// division and no barrier after staging, bank-skewed row strides, Qref
// from per-column sliding sums in the raw bytes' space. What bounds them:
// at 3840x2160, 7x7, +-15 the 168,784 interior blocks need 1.62e8
// block-candidates, 7.95 G pixel-candidates, against 2 bytes of frame per
// pixel, so shared-memory loads and integer issue, not device memory: per
// candidate at blk 7 the SASS holds 14 __dp4a (2 words a row, 4 pixels
// each) and 15 shared loads (14 window words, one Qref word) among 61
// instructions. Four vertically adjacent candidates per thread (each
// window row loaded once for four chains) ran no faster than one. At blk
// 24 and 32 the block's words are read from shared memory as 128-bit
// broadcasts, one load per four __dp4a.
//
// The u8 kernel: one CUDA block per row of `tbx` macroblocks stages the
// current pixels and the reference window they can reach in shared memory
// as packed bytes on a byte-offset window, with Qref from a plane of row
// sums, then column sums; its 128 threads split the K*K candidates of each
// macroblock and keep the best as the 64-bit key, reduced by common.cuh to
// "lowest cost, first in raster order". The tail word of a block row is
// masked on both operands when blk % 4 != 0. What bounds it: shared-memory
// reads and integer issue, not device memory.

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

// The Qref plane: qref[oy][x] = Σ_{r < BLK} rows[oy + r][x] for oy < K,
// x < q_w, where rows[r][x] is the sum of ref² over window row r, columns
// x..x+BLK-1.
template <int BLK>
__device__ __forceinline__ void column_box_sums(const int32_t* rows,
                                                int32_t* qref, int K,
                                                int q_w) {
  for (int i = threadIdx.x; i < K * q_w; i += kThreads) {
    const int oy = i / q_w, x = i - oy * q_w;
    const int32_t* col = rows + oy * q_w + x;
    int q = 0;
#pragma unroll
    for (int r = 0; r < BLK; ++r) q += col[r * q_w];
    qref[i] = q;
  }
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
  column_box_sums<BLK>(rows, qref, K, q_w);
  __syncthreads();

  const me::Range oy_ok =
      me::valid_offsets(y_origin + by * BLK, span, BLK, frame_h);
  for (int m = 0; m < ntile; ++m) {
    const me::Range ox_ok =
        me::valid_offsets(x_origin + (bx0 + m) * BLK, span, BLK, frame_w);
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
    return me::launch_search<B, false>(cur, ref, out_cost, out_idx, vol,    \
                                       cur_ld, ref_ld, out_ld, nby, nbx,    \
                                       span, frame_h, frame_w, y_origin,    \
                                       x_origin, s);
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
    return me::search_occupancy<B, false>(nbx, span, out);
  switch (blk) {
    ME_BLK_1_TO_16(ME_OCCUPANCY_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ME_OCCUPANCY_CASE
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

// SSD search of full interior blocks, blk 24 or 32, span >= 0.
extern "C" int me_wide_search(const void* cur, const void* ref,
                              void* out_cost, void* out_idx, int cur_ld,
                              int ref_ld, int out_ld, int nby, int nbx,
                              int blk, int span, int frame_h, int frame_w,
                              int y_origin, int x_origin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (span < 0) return static_cast<int>(cudaErrorInvalidValue);
#define ME_WIDE_CASE(B)                                                     \
  case B:                                                                   \
    return me::launch_search<B, false>(cur, ref, out_cost, out_idx,         \
                                       nullptr, cur_ld, ref_ld, out_ld,     \
                                       nby, nbx, span, frame_h, frame_w,    \
                                       y_origin, x_origin, s);
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
      return me::search_occupancy<24, false>(nbx, span, out);
    case 32:
      return me::search_occupancy<32, false>(nbx, span, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
