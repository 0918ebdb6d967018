// The register-ring search body of me_phase_ring (full_search.cu): the
// exact SSD of full interior 8x8 blocks, without a volume, at any span.
//
// Contract: that of full_search.cu (operands, global origin, validity, tie
// rule, INT32_MAX and the centre index where no candidate is valid).
//
// A CUDA block takes tby x tbx macroblocks (full_search.cu's ring_shape
// picks them and G by span) and stages, in
// shared memory, their window of 8 tby + 2 span rows as bytes, four to a
// word (zero past the halo), their 64 pixels each as 16 words, and the
// Qref plane: Qref << 6 of every 8x8 box of the window, by per-column
// sliding sums of the row sums of ref² (ring_plane). Each macroblock gets T
// = ceil(K / G) threads, each owning G consecutive offset columns (the
// surplus past K masked). A thread keeps its macroblock's 16 words and Qcur
// in registers and walks the K + 7 window rows its candidates reach: it
// loads each row's words once, shifts them to the G + 4 byte offsets its
// columns start at, and feeds a ring of 8 x G sums X = Σ cur·ref by one
// __dp4a a word (window row j adds cur row r to offset row j - r, slot
// (j - r) % 8). No shared load a pixel-candidate: per window row, a few
// word loads feed 16 G __dp4a. The rows go in chunks of eight, whose slot
// indices are compile-time: the first chunk (offset rows below 0 absent),
// then whole chunks, then up to two chunks where offset rows past K - 1
// are skipped by a branch the whole warp takes alike.
//
// An offset row is whole at r = 7. Its G costs Qcur + Qref - 2X (exact:
// at most 64 * 255² < 2^23) enter a 32-bit key cost << 6 | jj << 3 | q,
// jj the row's place in its chunk: the thread's candidates of one chunk in
// raster order. An invalid column carries bit 31 into its key, an invalid
// row ORs all ones into it, so neither wins, with no branch a pixel; every
// masked candidate reads bytes of the staged window, so its sum is a true
// SSD and the bit does not wrap. At each chunk's end the chunk's least key
// replaces the thread's best (cost, flat) only if its cost is lower:
// chunks come in raster order, so the first minimum stays. The T threads
// of a macroblock meet once at the end, through shared memory, as 64-bit
// keys cost << 32 | flat.
//
// What bounds it: 16 __dp4a a candidate on the SM's int32 lanes, beside
// about five instructions of a finished candidate (a plane load, the key,
// its minimum) and the row's loads and shifts over G candidates. At G = 8
// the SASS of a whole chunk holds 1,419 instructions for 64 candidates,
// 1,024 of them __dp4a, and 12 shared loads a window row; 128 registers,
// no spill, 16 warps an SM. At 4K 8x8 +-31 it runs in 0.762 ms on the
// H100, 65% of the __dp4a rate of 64 lanes an SM at 1,980 MHz.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "warp_search.cuh"

namespace me {

constexpr int kRingBlk = 8;
// The launch bound: ptxas keeps a thread within 128 registers.
constexpr int kRingMaxThreads = 512;
// The widest span routed to the ring: 4 x 8 macroblocks at +-63 stage
// 148 KB of shared memory; from about +-90 one row of 8 no longer fits.
constexpr int kRingMaxSpan = 63;
// A key's cost at or above this is masked: valid keys are below 2^31.
constexpr uint32_t kRingNoCost = 1u << 25;

// Byte offsets of the thread's G + 7 columns: e[o] holds bytes o..o+3 of
// its first column, o < G + 4. kAligned of them are loaded words shifted
// once (e[4i]; where G is a multiple of 4 every thread's first column
// starts a word, and they are the words), the rest come from two of those.
template <int G>
struct RingRow {
  static constexpr bool kWordStart = G % 4 == 0;
  static constexpr int kLastOdd = (G + 3) % 4 ? G + 3 : G + 2;
  static constexpr int kAligned = kLastOdd / 4 + 2;
  static constexpr int kWords = kAligned + (kWordStart ? 0 : 1);
};

struct RingLayout {
  int threads;        // T a macroblock, times the tile, a multiple of 32
  int win_h, ws;      // window rows, words a row
  int qh, qs;         // plane rows, entries a row (a multiple of 4)
  int red_words, win_words, cur_words, plane_words;
};

__host__ __device__ inline RingLayout ring_layout(int g, int words, int tby,
                                                  int tbx, int span) {
  RingLayout l;
  const int k = 2 * span + 1, t = (k + g - 1) / g;
  l.threads = (tby * tbx * t + 31) / 32 * 32;
  l.win_h = kRingBlk * tby + 2 * span;
  l.qh = l.win_h - kRingBlk + 1;
  // Plane columns: every column a thread reads, surplus ones included.
  l.qs = (kRingBlk * (tbx - 1) + t * g + 3) / 4 * 4;
  // Words a row: the last thread's loads, and the plane's last column's
  // box (three words from its first byte's word); odd, so that rows fall
  // on other banks.
  const int last_load = 2 * (tbx - 1) + (t - 1) * g / 4 + words;
  const int last_box = (l.qs - 1) / 4 + 3;
  l.ws = (last_load > last_box ? last_load : last_box) | 1;
  l.red_words = 2 * l.threads;
  l.win_words = (l.win_h * l.ws + 3) / 4 * 4;
  l.cur_words = tby * tbx * 16;
  l.plane_words = l.qh * l.qs;
  return l;
}

inline size_t ring_smem_bytes(const RingLayout& l) {
  return sizeof(uint32_t) *
         (l.red_words + l.win_words + l.cur_words + l.plane_words);
}

// The Qref plane, shifted: plane[y][x] = (Σ over the 8x8 box at window (y,
// x) of ref²) << 6, for y < qh, x < qs. An item is four columns over a run
// of rows: each window row's three words give the four columns' row sums
// by __dp4a, slid over 8 rows in rings in registers. Every thread calls it.
__device__ __forceinline__ void ring_plane(const uint32_t* win,
                                           const RingLayout& l,
                                           uint32_t* plane, int t) {
  const int groups = l.qs / 4;
  int segs = l.threads / groups;
  segs = segs < 1 ? 1 : segs;
  const int max_segs = (l.qh + 7) / 8;  // runs of at least 8 rows
  segs = segs > max_segs ? max_segs : segs;
  const int seg_len = (l.qh + segs - 1) / segs;
  for (int item = t; item < groups * segs; item += l.threads) {
    const int x4 = item % groups, y0 = item / groups * seg_len;
    const int y1 = min(l.qh, y0 + seg_len);
    uint32_t ring[kRingBlk][4] = {};
    uint32_t s[4] = {0, 0, 0, 0};
    for (int r0 = y0; r0 < y1 + kRingBlk - 1; r0 += kRingBlk) {
#pragma unroll
      for (int i = 0; i < kRingBlk; ++i) {
        const int r = r0 + i;
        if (r < y1 + kRingBlk - 1) {
          const uint32_t* w = win + r * l.ws + x4;
          const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
          uint32_t e[8];
          e[0] = w0;
          e[4] = w1;
#pragma unroll
          for (int o = 1; o < 4; ++o) {
            e[o] = __funnelshift_r(w0, w1, 8 * o);
            e[o + 4] = __funnelshift_r(w1, w2, 8 * o);
          }
          uint4 out;
          uint32_t* o4 = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t q = __dp4a(e[c], e[c], __dp4a(e[c + 4], e[c + 4], 0u));
            s[c] += q - ring[i][c];
            ring[i][c] = q;
            o4[c] = s[c] << 6;
          }
          if (r >= y0 + kRingBlk - 1)
            reinterpret_cast<uint4*>(plane + (r - kRingBlk + 1) * l.qs)[x4] =
                out;
        }
      }
    }
  }
}

// The thread's columns of one window row (G + 4 words, e[o] = bytes o..o+3
// from the byte `shift` / 8 of row[0]), from kWords loads.
template <int G>
__device__ __forceinline__ void ring_columns(const uint32_t* row, int shift,
                                             uint32_t (&e)[G + 4]) {
  using S = RingRow<G>;
  uint32_t w[S::kWords], a[S::kAligned];
#pragma unroll
  for (int i = 0; i < S::kWords; ++i) w[i] = row[i];
#pragma unroll
  for (int i = 0; i < S::kAligned; ++i) {
    if constexpr (S::kWordStart)
      a[i] = w[i];
    else
      a[i] = __funnelshift_r(w[i], w[i + 1], shift);
  }
#pragma unroll
  for (int o = 0; o < G + 4; ++o)
    e[o] = o % 4 ? __funnelshift_r(a[o / 4], a[o / 4 + 1], 8 * (o % 4))
                 : a[o / 4];
}

// Eight window rows j0..j0+7 (j0 a multiple of 8) into the ring. PHASE 0:
// the first chunk, offset row j - r only for r <= j; 1: every offset row
// exists; 2: rows past K + 6 and offset rows past K - 1 skipped (PHASE 0
// skips the latter too, for K < 8). finish(jj, oy, x) takes offset row oy
// = j0 + jj - 7 when it is whole.
template <int G, int PHASE, typename Finish>
__device__ __forceinline__ void ring_rows8(uint32_t (&acc)[kRingBlk][G],
                                           const uint32_t* wrow, int ws,
                                           int shift,
                                           const uint32_t (&cw)[16], int j0,
                                           int k, Finish&& finish) {
#pragma unroll
  for (int jj = 0; jj < kRingBlk; ++jj) {
    const int j = j0 + jj;
    if (PHASE == 2 && j >= k + kRingBlk - 1) break;
    uint32_t e[G + 4];
    ring_columns<G>(wrow + j * ws, shift, e);
#pragma unroll
    for (int r = 0; r < kRingBlk; ++r) {
      if (PHASE == 0 && r > jj) continue;
      if (PHASE != 1 && j - r >= k) continue;
      uint32_t(&a)[G] = acc[(jj - r) & (kRingBlk - 1)];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        uint32_t v = r == 0 ? 0u : a[q];
        v = __dp4a(cw[2 * r], e[q], v);
        v = __dp4a(cw[2 * r + 1], e[q + 4], v);
        a[q] = v;
      }
      if (r == kRingBlk - 1) finish(jj, j - r, a);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kRingMaxThreads)
ring_search_kernel(const uint8_t* __restrict__ cur, int cur_ld,
                   const uint8_t* __restrict__ ref, int ref_ld,
                   int32_t* __restrict__ out_cost,
                   int32_t* __restrict__ out_idx, int out_ld, int nby,
                   int nbx, int tby, int tbx, int span, int frame_h,
                   int frame_w, int y_origin, int x_origin) {
  constexpr int B = kRingBlk;
  const RingLayout l = ring_layout(G, RingRow<G>::kWords, tby, tbx, span);
  const int K = 2 * span + 1, T = (K + G - 1) / G;
  extern __shared__ unsigned long long smem[];
  unsigned long long* red = smem;  // [threads]
  uint32_t* win = reinterpret_cast<uint32_t*>(smem) + l.red_words;
  uint32_t* cblk = win + l.win_words;    // [tby * tbx][16]
  uint32_t* plane = cblk + l.cur_words;  // [qh][qs]
  const int by0 = blockIdx.y * tby, bx0 = blockIdx.x * tbx;
  const int t = threadIdx.x, nwarps = l.threads / 32;
  const int warp = t >> 5, lane = t & 31;

  // The window's bytes, four to a word, zero past the halo's rows and
  // columns (tiles at the grid's end); the macroblocks' words.
  const int halo_h = nby * B + 2 * span, halo_w = nbx * B + 2 * span;
  for (int r = warp; r < l.win_h; r += nwarps) {
    const int gy = by0 * B + r;
    const uint8_t* src = ref + static_cast<size_t>(gy) * ref_ld + bx0 * B;
    for (int c = lane; c < l.ws; c += 32) {
      uint32_t v = 0;
      if (gy < halo_h) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (bx0 * B + 4 * c + b < halo_w)
            v |= static_cast<uint32_t>(src[4 * c + b]) << (8 * b);
      }
      win[r * l.ws + c] = v;
    }
  }
  for (int i = t; i < l.cur_words; i += l.threads) {
    const int m = i >> 4, k = i & 15;
    const int mr = m / tbx, mc = m - mr * tbx;
    uint32_t v = 0;
    if (by0 + mr < nby && bx0 + mc < nbx) {
      const uint8_t* p = cur +
                         static_cast<size_t>((by0 + mr) * B + (k >> 1)) *
                             cur_ld +
                         (bx0 + mc) * B + 4 * (k & 1);
#pragma unroll
      for (int b = 0; b < 4; ++b) v |= static_cast<uint32_t>(p[b]) << (8 * b);
    }
    cblk[i] = v;
  }
  __syncthreads();
  ring_plane(win, l, plane, t);
  __syncthreads();

  const int m = t / T, g = t - m * T;
  const int R = m / tbx, bm = m - R * tbx;
  const bool valid = m < tby * tbx && by0 + R < nby && bx0 + bm < nbx;
  uint32_t best_cost = kRingNoCost;
  int best_flat = span * K + span;
  const int ox0 = g * G;
  if (valid) {
    uint32_t cw[16];
    uint32_t qc = 0;  // Qcur
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      cw[i] = cblk[m * 16 + i];
      qc = __dp4a(cw[i], cw[i], qc);
    }
    const Range oy_ok = valid_offsets(y_origin + (by0 + R) * B, span, B,
                                      frame_h);
    const Range ox_ok = valid_offsets(x_origin + (bx0 + bm) * B, span, B,
                                      frame_w);
    // Per column: Qcur << 6, its place q, and bit 31 where it is invalid.
    uint32_t cq[G];
#pragma unroll
    for (int q = 0; q < G; ++q)
      cq[q] = (qc << 6) + q +
              (ox0 + q < ox_ok.lo || ox0 + q > ox_ok.hi ? 0x80000000u : 0u);
    // The thread's columns start at byte 8 * bm + ox0 of a window row:
    // word 2 * bm + ox0 / 4, byte ox0 % 4 of it.
    const uint32_t* wrow = win + R * B * l.ws + 2 * bm + ox0 / 4;
    const int shift = 8 * (ox0 & 3);
    const uint32_t* prow = plane + R * B * l.qs + bm * B + ox0;
    uint32_t chunk = 0xffffffffu;  // the chunk's least key
    auto finish = [&](int jj, int oy, const uint32_t(&x)[G]) {
      const uint32_t* p = prow + oy * l.qs;
      uint32_t least = 0xffffffffu;
#pragma unroll
      for (int q = 0; q < G; ++q)
        least = min(least, p[q] + cq[q] + (jj << 3) - (x[q] << 7));
      chunk = min(chunk, least | (oy < oy_ok.lo || oy > oy_ok.hi
                                      ? 0xffffffffu
                                      : 0u));
    };
    // The chunk at j0 into the best: its keys' offset rows are j0 - 7 + jj.
    auto flush = [&](int j0) {
      if ((chunk >> 6) < best_cost) {
        best_cost = chunk >> 6;
        best_flat = (j0 - 7 + static_cast<int>((chunk >> 3) & 7)) * K + ox0 +
                    static_cast<int>(chunk & 7);
      }
      chunk = 0xffffffffu;
    };
    uint32_t acc[B][G] = {};
    ring_rows8<G, 0>(acc, wrow, l.ws, shift, cw, 0, K, finish);
    flush(0);
    int j0 = B;
#pragma unroll 1
    for (; j0 + B <= K; j0 += B) {
      ring_rows8<G, 1>(acc, wrow, l.ws, shift, cw, j0, K, finish);
      flush(j0);
    }
#pragma unroll 1
    for (; j0 < K + B - 1; j0 += B) {
      ring_rows8<G, 2>(acc, wrow, l.ws, shift, cw, j0, K, finish);
      flush(j0);
    }
  }
  red[t] = best_cost < kRingNoCost
               ? (static_cast<unsigned long long>(best_cost) << 32) |
                     static_cast<unsigned>(best_flat)
               : kNoKey;
  __syncthreads();
  if (t < tby * tbx) {
    const int R2 = t / tbx, b2 = t - R2 * tbx;
    if (by0 + R2 < nby && bx0 + b2 < nbx) {
      unsigned long long best = red[t * T];
      for (int i = 1; i < T; ++i) {
        const unsigned long long v = red[t * T + i];
        best = v < best ? v : best;
      }
      const size_t o = static_cast<size_t>(by0 + R2) * out_ld + bx0 + b2;
      const bool none = best == kNoKey;
      out_cost[o] = none ? 0x7fffffff : static_cast<int32_t>(best >> 32);
      out_idx[o] = none ? span * K + span
                        : static_cast<int32_t>(best & 0xffffffffu);
    }
  }
}

// One launch of the G-column instance on tby x tbx macroblocks a CUDA block
// (clipped to the grid). Returns the cudaError_t of the launch.
template <int G>
int launch_ring(const void* cur, const void* ref, void* out_cost,
                void* out_idx, int cur_ld, int ref_ld, int out_ld, int nby,
                int nbx, int span, int frame_h, int frame_w, int y_origin,
                int x_origin, int tby, int tbx, cudaStream_t stream) {
  tby = tby < nby ? tby : nby;
  tbx = tbx < nbx ? tbx : nbx;
  const RingLayout l = ring_layout(G, RingRow<G>::kWords, tby, tbx, span);
  auto kernel = ring_search_kernel<G>;
  const size_t smem = ring_smem_bytes(l);
  if (l.threads > kRingMaxThreads || !reserve_smem(kernel, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nbx + tbx - 1) / tbx, (nby + tby - 1) / tby);
  kernel<<<grid, l.threads, smem, stream>>>(
      static_cast<const uint8_t*>(cur), cur_ld,
      static_cast<const uint8_t*>(ref), ref_ld,
      static_cast<int32_t*>(out_cost), static_cast<int32_t*>(out_idx),
      out_ld, nby, nbx, tby, tbx, span, frame_h, frame_w, y_origin,
      x_origin);
  return static_cast<int>(cudaGetLastError());
}

// The G-column instance's resources at tby x tbx macroblocks (clipped to
// an nby x nbx grid): out[6] = {registers per thread, local (spill) bytes
// per thread, dynamic shared memory bytes, macroblocks per CUDA block,
// resident CUDA blocks per SM, threads per CUDA block}. Returns the
// cudaError_t of the queries.
template <int G>
int ring_occupancy(int span, int nby, int nbx, int tby, int tbx, int* out) {
  tby = tby < nby ? tby : nby;
  tbx = tbx < nbx ? tbx : nbx;
  const RingLayout l = ring_layout(G, RingRow<G>::kWords, tby, tbx, span);
  auto kernel = ring_search_kernel<G>;
  const size_t smem = ring_smem_bytes(l);
  if (l.threads > kRingMaxThreads || !reserve_smem(kernel, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        l.threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = tby * tbx;
  out[4] = blocks;
  out[5] = l.threads;
  return 0;
}

}  // namespace me
