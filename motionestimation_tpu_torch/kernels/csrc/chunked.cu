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
// 2^24; the wide kernel here adds the same 8-row parts, in int32, where the
// split only fixes the order of the additions.
//
// me_chunked_search (K5). What bounds it: at 3840x2160, 7x7, +-15 the
// 168,784 interior blocks need 1.62e8 block-candidates, 7.95 G
// pixel-candidates, against 2 bytes of frame per pixel, so integer issue
// and shared-memory load words, not device memory. Per candidate at blk 7
// the kernel issues 14 __dp4a (2 words a row, 4 pixels each; 2.27 G in
// all) and reads 14 window words plus one Qref word from shared memory
// (2.43 G words, 0.29 ms at 32 words per SM per clock). On the H100, four
// vertically adjacent candidates per thread (each window row loaded once
// for four independent __dp4a chains, 5 window words per candidate) ran
// no faster than one: the instructions issued around the __dp4a bound it,
// not the loads or the chain. Design, for Hopper rather than after
// `_kernel_f32`'s choreography:
// - Packed bytes: the window is staged once per byte offset (word o packs
//   bytes o..o+3 of a window row), so every candidate reads aligned words
//   and one __dp4a covers four pixels. The block's tail bytes past blk are
//   staged as zero, which masks the tail word of every product; Qcur and
//   the row sums of Qref use __dp4a too, with the tail word masked. The
//   block's words stay in registers.
// - A warp owns a macroblock: its 32 lanes take its K*K candidates in
//   turn, stepping through (oy, ox) with no division; one warp_min gives
//   the best 64-bit key (cost << 32 | flat: lowest cost, first in raster
//   order) and lane 0 writes it. No shared reduction slot, no barrier
//   after staging.
// - Banks: window and Qref rows have a stride that is K modulo 32 words,
//   so 32 consecutive candidates fall on 32 different banks whatever K is.
// - Occupancy: Qref comes from per-column sliding sums of the row sums of
//   ref², with no plane of row sums, and the raw bytes the window is built
//   from share their space with the Qref plane: 26.3 KB at 7x7 +-15 for a
//   tile of 8 macroblocks, which each of 4 warps owns two of, so 8 CUDA
//   blocks (32 warps) are resident per SM.
// The volume adds K*K*4 bytes of stores per block; each thread writes its
// candidate's cost, INT32_MAX where it is invalid. Lanes write to
// different planes, so the stores are not coalesced.
//
// The u8 and wide kernels: one CUDA block per row of `tbx` macroblocks
// stages the current pixels and the reference window they can reach in
// shared memory, with Qref from a plane of row sums, then column sums; its
// 128 threads split the K*K candidates of each macroblock and keep the best
// as the 64-bit key, reduced by common.cuh to "lowest cost, first in raster
// order".
//
// Staging. The wide kernel stages both operands 32 bits per pixel, as
// `_kernel_f32_wide` stages float32: X is one integer multiply-add per
// pixel-candidate on one 32-bit shared load of the window, and any blk needs
// no tail mask. Wide blocks are read four pixels at a time by a broadcast
// 128-bit shared load (inline PTX, so the compiler cannot hoist 64..256 of
// them into registers). The u8 kernel stages packed bytes on the phase
// kernel's byte-offset window, as K5 does; the tail word of a block row is
// masked on both operands when blk % 4 != 0.
//
// What bounds them: shared-memory reads and integer issue, not device
// memory. Per pixel-candidate the 32-bit kernel issues one shared load and
// one IMAD; the u8 kernel a quarter of each.

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
// K5. Shared memory, in 32-bit words: the byte-offset window [win_h][ws],
// the block's words [tbx][BLK][CW] (zero past BLK), then one region that
// holds the window's raw bytes [win_h][raw_w] until the window is built,
// and the Qref plane [K][qs] after. grid = (ceil(nbx / tbx), nby),
// kThreads threads.
struct K5Layout {
  int win_w;   // words per window row (byte offsets)
  int q_w;     // Qref columns: candidate top-left columns of the tile
  int raw_w;   // raw bytes per window row, a multiple of 4
  int ws, qs;  // row strides of the window and of the Qref plane
  int win_words, cur_words, region_words;
};

// The least count >= `words` that is k modulo 32: as a row stride, it puts
// candidate c = oy * k + ox on bank c + const.
__host__ __device__ inline int bank_stride(int words, int k) {
  return words + ((k - words) % 32 + 32) % 32;
}

__host__ __device__ inline K5Layout k5_layout(int blk, int tbx, int span) {
  K5Layout l;
  const int k = 2 * span + 1, win_h = blk + 2 * span;
  l.win_w = tbx * blk + 2 * span;
  l.q_w = l.win_w - blk + 1;
  l.raw_w = 4 * ((l.win_w + 7) / 4);  // words o..o+3 read two raw words
  l.ws = bank_stride(l.win_w, k);
  l.qs = bank_stride(l.q_w, k);
  l.win_words = win_h * l.ws;
  l.cur_words = tbx * blk * ((blk + 3) / 4);
  const int raw_words = win_h * l.raw_w / 4;
  const int qref_words = k * l.qs;
  l.region_words = raw_words > qref_words ? raw_words : qref_words;
  return l;
}

template <int BLK>
__global__ void __launch_bounds__(kThreads)
chunked_search_kernel(const uint8_t* __restrict__ cur, int cur_ld,
                      const uint8_t* __restrict__ ref, int ref_ld,
                      int32_t* __restrict__ out_cost,
                      int32_t* __restrict__ out_idx,
                      int32_t* __restrict__ vol, int out_ld, int nby,
                      int nbx, int tbx, int span, int frame_h, int frame_w,
                      int y_origin, int x_origin) {
  constexpr int CW = (BLK + 3) / 4;  // packed words per block row
  constexpr uint32_t kLast = (BLK & 3) ? (1u << (8 * (BLK & 3))) - 1u
                                       : 0xffffffffu;

  extern __shared__ unsigned long long smem[];
  const K5Layout l = k5_layout(BLK, tbx, span);
  const int K = 2 * span + 1;
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * tbx;
  const int ntile = min(tbx, nbx - bx0);
  const int win_h = BLK + 2 * span;
  const int halo_w = nbx * BLK + 2 * span;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  uint32_t* win = reinterpret_cast<uint32_t*>(smem);
  uint32_t* cblk = win + l.win_words;
  uint32_t* region = cblk + l.cur_words;
  uint8_t* raw = reinterpret_cast<uint8_t*>(region);
  int32_t* qref = reinterpret_cast<int32_t*>(region);

  // Raw window bytes (zero past the halo) and the block's words.
  const int wy0 = by * BLK, wx0 = bx0 * BLK;
  for (int r = warp; r < win_h; r += kWarps) {
    const uint8_t* src = ref + static_cast<size_t>(wy0 + r) * ref_ld + wx0;
    for (int c = lane; c < l.raw_w; c += 32)
      raw[r * l.raw_w + c] = wx0 + c < halo_w ? src[c] : 0;
  }
  for (int i = threadIdx.x; i < tbx * BLK * CW; i += kThreads) {
    const int m = i / (BLK * CW), rw = i - m * (BLK * CW);
    const int r = rw / CW, w = rw - r * CW;
    uint32_t v = 0;
    if (m < ntile) {
      const uint8_t* p = cur + static_cast<size_t>(wy0 + r) * cur_ld +
                         (bx0 + m) * BLK + 4 * w;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * w + b < BLK) v |= static_cast<uint32_t>(p[b]) << (8 * b);
    }
    cblk[i] = v;
  }
  __syncthreads();
  // The byte-offset window from the raw bytes.
  for (int r = warp; r < win_h; r += kWarps) {
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(raw + r * l.raw_w);
    uint32_t* dst = win + r * l.ws;
    for (int o = lane; o < l.win_w; o += 32)
      dst[o] = __funnelshift_r(src[o >> 2], src[(o >> 2) + 1], 8 * (o & 3));
  }
  __syncthreads();
  // The Qref plane over the raw bytes' space: per column x, the sliding sum
  // of the last BLK row sums of ref² (columns x..x+BLK-1), kept in a ring.
  for (int x = threadIdx.x; x < l.q_w; x += kThreads) {
    int ring[BLK];
#pragma unroll
    for (int i = 0; i < BLK; ++i) ring[i] = 0;
    int s = 0;
    for (int r0 = 0; r0 < win_h; r0 += BLK) {
#pragma unroll
      for (int i = 0; i < BLK; ++i) {
        const int r = r0 + i;
        if (r < win_h) {
          const uint32_t* w = win + r * l.ws + x;
          uint32_t q = 0;
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            const uint32_t v = c == CW - 1 ? w[4 * c] & kLast : w[4 * c];
            q = __dp4a(v, v, q);
          }
          s += static_cast<int>(q) - ring[i];
          ring[i] = static_cast<int>(q);
          if (r >= BLK - 1)
            qref[(r - (BLK - 1)) * l.qs + x] = s;
        }
      }
    }
  }
  __syncthreads();

  const Range oy_ok = valid_offsets(y_origin + by * BLK, span, BLK, frame_h);
  const size_t plane = static_cast<size_t>(nby) * out_ld;
  // Lane takes candidates lane, lane + 32, ... of its warp's macroblock.
  const int oy_first = lane / K, ox_first = lane - oy_first * K;
  const int oy_step = 32 / K, ox_step = 32 - oy_step * K;
  for (int m = warp; m < ntile; m += kWarps) {
    const Range ox_ok =
        valid_offsets(x_origin + (bx0 + m) * BLK, span, BLK, frame_w);
    uint32_t creg[BLK * CW];
    uint32_t qcur = 0;
#pragma unroll
    for (int i = 0; i < BLK * CW; ++i) {
      creg[i] = cblk[m * BLK * CW + i];
      qcur = __dp4a(creg[i], creg[i], qcur);
    }
    const size_t o = static_cast<size_t>(by) * out_ld + bx0 + m;
    unsigned long long best = kNoKey;
    for (int oy = oy_first, ox = ox_first; oy < K;) {
      const uint32_t* wp = win + oy * l.ws + m * BLK + ox;
      uint32_t x = 0;
#pragma unroll
      for (int r = 0; r < BLK; ++r) {
#pragma unroll
        for (int c = 0; c < CW; ++c)
          x = __dp4a(creg[r * CW + c], wp[r * l.ws + 4 * c], x);
      }
      const int xi = static_cast<int>(x);
      const int cost = (static_cast<int>(qcur) - xi) +
                       (qref[oy * l.qs + m * BLK + ox] - xi);
      const bool ok = ox >= ox_ok.lo && ox <= ox_ok.hi && oy >= oy_ok.lo &&
                      oy <= oy_ok.hi;
      const int flat = oy * K + ox;
      if (vol != nullptr)
        vol[static_cast<size_t>(flat) * plane + o] = ok ? cost : kInt32Max;
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<uint32_t>(cost))
           << 32) |
          static_cast<unsigned>(flat);
      if (ok && key < best) best = key;
      oy += oy_step;
      ox += ox_step;
      if (ox >= K) {
        ox -= K;
        ++oy;
      }
    }
    best = me::warp_min(best);
    if (lane == 0) {
      const bool none = best == kNoKey;
      out_cost[o] = none ? kInt32Max : static_cast<int32_t>(best >> 32);
      out_idx[o] = none ? span * K + span
                        : static_cast<int32_t>(best & 0xffffffffu);
    }
  }
}

size_t k5_smem_bytes(int blk, int tbx, int span) {
  const K5Layout l = k5_layout(blk, tbx, span);
  return sizeof(uint32_t) * (l.win_words + l.cur_words + l.region_words);
}

// K5's tile: about 64 pixels of macroblocks, a multiple of kWarps so that
// every warp owns as many, at most nbx, halved until its shared memory fits.
// Returns 0 if no tile fits.
template <int BLK>
int k5_tile(int nbx, int span, size_t* smem) {
  auto kernel = chunked_search_kernel<BLK>;
  int tbx = 64 / BLK / kWarps * kWarps;
  if (tbx < kWarps) tbx = kWarps;
  if (tbx > nbx) tbx = nbx;
  *smem = k5_smem_bytes(BLK, tbx, span);
  while (!reserve_smem(kernel, *smem) && tbx > 1) {
    tbx /= 2;
    *smem = k5_smem_bytes(BLK, tbx, span);
  }
  return reserve_smem(kernel, *smem) ? tbx : 0;
}

template <int BLK>
int launch_chunked(const void* cur, const void* ref, void* out_cost,
                   void* out_idx, void* vol, int cur_ld, int ref_ld,
                   int out_ld, int nby, int nbx, int span, int frame_h,
                   int frame_w, int y_origin, int x_origin,
                   cudaStream_t stream) {
  size_t smem = 0;
  const int tbx = k5_tile<BLK>(nbx, span, &smem);
  if (tbx == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nbx + tbx - 1) / tbx, nby);
  chunked_search_kernel<BLK><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(cur), cur_ld,
      static_cast<const uint8_t*>(ref), ref_ld,
      static_cast<int32_t*>(out_cost), static_cast<int32_t*>(out_idx),
      static_cast<int32_t*>(vol), out_ld, nby, nbx, tbx, span, frame_h,
      frame_w, y_origin, x_origin);
  return static_cast<int>(cudaGetLastError());
}

// out = {registers and local (spill) bytes per thread, dynamic shared
// memory bytes, macroblocks per CUDA block, resident CUDA blocks per SM}.
template <int BLK>
int occupancy_chunked(int nbx, int span, int* out) {
  auto kernel = chunked_search_kernel<BLK>;
  size_t smem = 0;
  const int tbx = k5_tile<BLK>(nbx, span, &smem);
  if (tbx == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = tbx;
  out[4] = blocks;
  return 0;
}

// ---------------------------------------------------------------------------
// 32-bit staging (wide kernel). Shared memory, after the
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
    return launch_chunked<B>(cur, ref, out_cost, out_idx, vol, cur_ld,      \
                             ref_ld, out_ld, nby, nbx, span, frame_h,       \
                             frame_w, y_origin, x_origin, s);
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
    return occupancy_chunked<B>(nbx, span, out);
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
