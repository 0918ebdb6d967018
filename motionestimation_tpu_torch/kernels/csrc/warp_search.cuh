// The warp-per-macroblock search body of me_phase_search (full_search.cu),
// me_chunked_search, me_chunked_u8_search and me_wide_search (chunked.cu)
// and me_ssim_fast_search (ssim.cu): the exact SSD, SAD or SSIM of full
// interior blocks of side BLK, with an optional cost or score volume.
//
// Contract: that of full_search.cu (SSD, SAD) or ssim.cu (SSIM): operands,
// global origin, validity, tie rule, and what a block with no winner gets
// (INT32_MAX or score 0, and the centre index). Every block of the tile is
// whole and inside the frame. With a volume (EMIT), vol[cand] is a [nby,
// out_ld] plane: each candidate's int32 cost or float32 score, INT32_MAX
// or -inf where the candidate is invalid.
//
// One CUDA block (kThreads threads) takes `tbx` macroblocks of one block
// row. Shared memory, in 32-bit words: the reduction slots [kWarps] (64-bit),
// the byte-offset window [win_h][ws] (word o packs window bytes o..o+3),
// the block's words [tbx][BLK][CS] (zero past BLK), then one region that
// holds the window's raw bytes [win_h][raw_w] until the window is built and,
// for SSD, the Qref plane [K][qs] after, for SSIM the interleaved plane of
// (Σref, Σref²) [K][qs] (int2). grid = (ceil(nbx / tbx), nby).
//
// - Packed bytes: the window is staged once per byte offset from a
//   coalesced load of its raw bytes and one funnel shift per word, so every
//   candidate reads aligned words and one __dp4a (SSD, SSIM) or one
//   VABSDIFF4 with accumulate (SAD) covers four pixels.
// - SSD as (Qcur - X) + (Qref - X): Qcur = Σ cur² once per block, X = Σ
//   cur·ref one __dp4a per word, Qref = Σ ref² over the candidate from a
//   plane built once per CUDA block by per-column sliding sums of the row
//   sums of ref² (a ring of BLK row sums in registers). Everything is exact
//   in int32 (Qref <= 255² * 32² < 2^27); the order of the additions changes
//   no value. SAD needs no plane.
// - SSIM from Σcur, Σcur² (once per block, with the score's block terms:
//   ssim_score.cuh), X = Σ cur·ref (one __dp4a per word) and Σref, Σref²
//   over the candidate, both from one 64-bit load of a plane built once per
//   CUDA block by the same per-column sliding sums, with a second ring for
//   the row sums of ref (__dp4a against 0x01010101; Σref < 2^18). Where the
//   pixel count is a power of two, its three divisions by the count are
//   multiplications.
// - Tails (blk % 4 != 0): the block's bytes past BLK are staged as zero,
//   which masks the tail word of every product; SAD and the row sums mask
//   the window's tail word.
// - A warp owns a macroblock (or, above blk 16 when the tile has fewer
//   macroblocks than warps, kWarps / tbx warps share one): its lanes take
//   the candidates in raster order, 32 (or 32 * kWarps / tbx) apart,
//   stepping (oy, ox) with no division. Each lane keeps the best 64-bit key
//   (SSD, SAD: cost << 32 | flat, lowest cost first in raster order; SSIM:
//   ssim_score.cuh's key, highest score above 0 first in raster order), one
//   warp_min reduces it, lane 0 writes it; warps that share a macroblock
//   meet in the reduction slots.
// - Banks: window and plane rows have a stride that is K modulo 32 entries,
//   so 32 consecutive candidates fall on 32 different banks (16 on 16 pairs
//   of banks for the 64-bit SSIM plane, a half-warp per wavefront) whatever
//   K is.
// - The block's words: in registers up to blk 16 (64 words); above, (72 to
//   256 words) every lane of the warp reads the same word, so they stay in
//   shared memory, read as 128-bit broadcasts (one load per four __dp4a),
//   rows padded to a multiple of four words, the last one to three words of
//   a row by one narrower load.
// - Tile: about 64 pixels of macroblocks, a multiple of kWarps, halved
//   while its shared memory exceeds what the card gives one block and,
//   above blk 16, kTileSmemBytes (four CUDA blocks, 16 warps, per SM): at
//   4K 32x32 +-31 one macroblock and its 3,969 candidates per CUDA block,
//   four warps on it.
//
// What bounds it: the frames are 2 bytes per pixel against K*K*blk*blk
// pixel-candidates per block, so not device memory but shared-memory loads
// and integer issue: one shared load per __dp4a (plus one 128-bit
// broadcast per four above blk 16) at one warp-wide load per SM per clock;
// for SSIM at small blk, the float score (three to six IEEE divisions and
// a square root per candidate). A volume adds one 4-byte store per
// candidate; lanes store to different planes, so the stores are not
// coalesced and set its time.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "ssim_score.cuh"

namespace me {

constexpr int kIntMax = 0x7fffffff;
constexpr size_t kTileSmemBytes = 55 * 1024;

// The cost form of an instance: exact SSD or SAD (int32 cost, lowest
// wins), or SSIM (float32 score, highest above 0 wins).
enum class Form { kSsd, kSad, kSsim };

// The type of a form's cost (output and volume entries).
template <Form F>
using CostT = std::conditional_t<F == Form::kSsim, float, int32_t>;

// Valid offsets o = d + span along one axis: 0 <= g + o - span <= frame - blk.
struct Range {
  int lo, hi;
};

__device__ __forceinline__ Range valid_offsets(int g, int span, int blk,
                                               int frame) {
  return {max(0, span - g), min(2 * span, frame - blk - g + span)};
}

// The least count >= `words` that is k modulo 32: as a row stride, it puts
// candidate c = oy * k + ox on bank c + const.
__host__ __device__ inline int bank_stride(int words, int k) {
  return words + ((k - words) % 32 + 32) % 32;
}

struct SearchLayout {
  int win_w;   // words per window row (byte offsets)
  int q_w;     // plane columns: candidate top-left columns of the tile
  int raw_w;   // raw bytes per window row, a multiple of 4
  int ws, qs;  // row strides of the window and of the plane (entries)
  int cs;      // words per staged block row
  int win_words, cur_words, region_words;
};

__host__ __device__ inline SearchLayout search_layout(int blk, int tbx,
                                                      int span, Form f) {
  SearchLayout l;
  const int k = 2 * span + 1, win_h = blk + 2 * span, cw = (blk + 3) / 4;
  l.win_w = tbx * blk + 2 * span;
  l.q_w = l.win_w - blk + 1;
  l.raw_w = 4 * ((l.win_w + 7) / 4);  // words o..o+3 read two raw words
  l.ws = bank_stride(l.win_w, k);
  l.qs = bank_stride(l.q_w, k);
  l.cs = blk <= 16 ? cw : (cw + 3) / 4 * 4;
  l.win_words = (win_h * l.ws + 3) / 4 * 4;  // the block's words 16-aligned
  l.cur_words = tbx * blk * l.cs;
  if (f == Form::kSsim) l.cur_words = (l.cur_words + 1) / 2 * 2;  // int2
  const int raw_words = win_h * l.raw_w / 4;
  const int plane_words =
      f == Form::kSad ? 0 : (f == Form::kSsim ? 2 : 1) * k * l.qs;
  l.region_words = raw_words > plane_words ? raw_words : plane_words;
  return l;
}

inline size_t search_smem_bytes(int blk, int tbx, int span, Form f) {
  const SearchLayout l = search_layout(blk, tbx, span, f);
  return sizeof(unsigned long long) * kWarps +
         sizeof(uint32_t) * (l.win_words + l.cur_words + l.region_words);
}

// acc + Σ |a_i - b_i| over the four bytes: one VABSDIFF4.U8.ACC on sm_90a,
// where __vsadu4(a, b) + acc leaves a separate add for about every second
// word and __dp4a(__vabsdiffu4(a, b), 0x01010101, acc) takes two.
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(acc));
  return d;
}

// A candidate's 64-bit key, least for the best: SSD, SAD: cost << 32 |
// flat (lowest cost first in raster order); SSIM: score_key.
template <Form F>
__device__ __forceinline__ unsigned long long cost_key(CostT<F> cost,
                                                       int flat) {
  if constexpr (F == Form::kSsim) {
    return score_key(cost, flat);
  } else {
    return (static_cast<unsigned long long>(static_cast<uint32_t>(cost))
            << 32) |
           static_cast<unsigned>(flat);
  }
}

// The volume's entry for an invalid candidate: INT32_MAX, or -inf.
template <Form F>
__device__ __forceinline__ CostT<F> invalid_cost() {
  if constexpr (F == Form::kSsim) {
    return __uint_as_float(kNegInfBits);
  } else {
    return kIntMax;
  }
}

// A macroblock's result from its best key: SSD, SAD: the cost, or
// INT32_MAX and the centre index without a valid candidate; SSIM: the
// score, or 0 and the centre index without a score above 0.
template <Form F>
__device__ __forceinline__ void write_key(unsigned long long best,
                                          CostT<F>* out_cost,
                                          int32_t* out_idx, size_t o,
                                          int centre) {
  const bool none = best == kNoKey;
  if constexpr (F == Form::kSsim) {
    out_cost[o] = none ? 0.0f : key_score(best);
  } else {
    out_cost[o] = none ? kIntMax : static_cast<int32_t>(best >> 32);
  }
  out_idx[o] = none ? centre : static_cast<int32_t>(best & 0xffffffffu);
}

// One column x of the plane over the raw bytes' space: the sliding sum
// over BLK rows of the row sums (columns x..x+BLK-1), kept in a ring of
// BLK in registers. SSD: Qref, from the row sums of ref²; SSIM: (Σref,
// Σref²), with a second ring for the row sums of ref.
template <int BLK, Form F>
__device__ __forceinline__ void plane_column(const uint32_t* win,
                                             const SearchLayout& l,
                                             int win_h, int x,
                                             uint32_t* plane) {
  constexpr bool SSIM = F == Form::kSsim;
  constexpr int CW = (BLK + 3) / 4;
  constexpr uint32_t kLast = (BLK & 3) ? (1u << (8 * (BLK & 3))) - 1u
                                       : 0xffffffffu;
  int ring[BLK];
  [[maybe_unused]] int ring1[SSIM ? BLK : 1];
#pragma unroll
  for (int i = 0; i < BLK; ++i) {
    ring[i] = 0;
    if constexpr (SSIM) ring1[i] = 0;
  }
  int s = 0;
  [[maybe_unused]] int s1 = 0;
  for (int r0 = 0; r0 < win_h; r0 += BLK) {
#pragma unroll
    for (int i = 0; i < BLK; ++i) {
      const int r = r0 + i;
      if (r < win_h) {
        const uint32_t* w = win + r * l.ws + x;
        uint32_t q = 0;
        [[maybe_unused]] uint32_t q1 = 0;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const uint32_t v = c == CW - 1 ? w[4 * c] & kLast : w[4 * c];
          q = __dp4a(v, v, q);
          if constexpr (SSIM) q1 = __dp4a(v, 0x01010101u, q1);
        }
        s += static_cast<int>(q) - ring[i];
        ring[i] = static_cast<int>(q);
        if constexpr (SSIM) {
          s1 += static_cast<int>(q1) - ring1[i];
          ring1[i] = static_cast<int>(q1);
        }
        if (r >= BLK - 1) {
          const int p = (r - (BLK - 1)) * l.qs + x;
          if constexpr (SSIM)
            reinterpret_cast<int2*>(plane)[p] = make_int2(s1, s);
          else
            reinterpret_cast<int32_t*>(plane)[p] = s;
        }
      }
    }
  }
}

template <int BLK, Form F, bool EMIT>
__global__ void __launch_bounds__(kThreads)
warp_search_kernel(const uint8_t* __restrict__ cur, int cur_ld,
                   const uint8_t* __restrict__ ref, int ref_ld,
                   CostT<F>* __restrict__ out_cost,
                   int32_t* __restrict__ out_idx,
                   CostT<F>* __restrict__ vol, int out_ld, int nby, int nbx,
                   int tbx, int span, int frame_h, int frame_w, int y_origin,
                   int x_origin) {
  constexpr bool SAD = F == Form::kSad, SSIM = F == Form::kSsim;
  constexpr int CW = (BLK + 3) / 4;  // packed words per block row
  constexpr bool kCurInRegs = BLK <= 16;
  constexpr bool kShare = !kCurInRegs;  // warps may share a macroblock
  constexpr uint32_t kLast = (BLK & 3) ? (1u << (8 * (BLK & 3))) - 1u
                                       : 0xffffffffu;
  // Above blk 16 the block's words are not masked: SAD there needs whole
  // words.
  static_assert(!SAD || kCurInRegs || BLK % 4 == 0);

  extern __shared__ unsigned long long smem[];
  constexpr int CS = kCurInRegs ? CW : (CW + 3) / 4 * 4;  // = l.cs
  const SearchLayout l = search_layout(BLK, tbx, span, F);
  const int K = 2 * span + 1;
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * tbx;
  const int ntile = min(tbx, nbx - bx0);
  const int win_h = BLK + 2 * span;
  const int halo_w = nbx * BLK + 2 * span;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  unsigned long long* red = smem;  // [kWarps]
  uint32_t* win = reinterpret_cast<uint32_t*>(smem + kWarps);
  uint32_t* cblk = win + l.win_words;
  uint32_t* region = cblk + l.cur_words;
  uint8_t* raw = reinterpret_cast<uint8_t*>(region);
  int32_t* qref = reinterpret_cast<int32_t*>(region);  // SSD
  int2* sums = reinterpret_cast<int2*>(region);        // SSIM: (Σref, Σref²)

  // Raw window bytes (zero past the halo) and the block's words.
  const int wy0 = by * BLK, wx0 = bx0 * BLK;
  for (int r = warp; r < win_h; r += kWarps) {
    const uint8_t* src = ref + static_cast<size_t>(wy0 + r) * ref_ld + wx0;
    for (int c = lane; c < l.raw_w; c += 32)
      raw[r * l.raw_w + c] = wx0 + c < halo_w ? src[c] : 0;
  }
  for (int i = threadIdx.x; i < tbx * BLK * CS; i += kThreads) {
    const int m = i / (BLK * CS), rw = i - m * (BLK * CS);
    const int r = rw / CS, w = rw - r * CS;
    uint32_t v = 0;
    if (m < ntile && w < CW) {
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
  if constexpr (!SAD) {
    for (int x = threadIdx.x; x < l.q_w; x += kThreads)
      plane_column<BLK, F>(win, l, win_h, x, region);
    __syncthreads();
  }

  // Warps per macroblock: above blk 16, kWarps / tbx when the tile is
  // shorter than the warps and divides them; else 1, a constant (at blk <=
  // 16 a runtime count costs registers, occupancy and time). Warp `warp`
  // takes macroblocks `slot`, slot + groups, ... and, of each, candidates
  // part * 32 + lane + j * step.
  const int wpm =
      kShare && tbx < kWarps && kWarps % tbx == 0 ? kWarps / tbx : 1;
  const int groups = kWarps / wpm;
  const int part = warp / groups, slot = warp - part * groups;
  const int first = part * 32 + lane, step = 32 * wpm;
  const int oy_first = first / K, ox_first = first - oy_first * K;
  const int oy_step = step / K, ox_step = step - oy_step * K;
  const Range oy_ok = valid_offsets(y_origin + by * BLK, span, BLK, frame_h);
  const size_t plane = static_cast<size_t>(nby) * out_ld;
  for (int m = slot; m < ntile; m += groups) {
    const Range ox_ok =
        valid_offsets(x_origin + (bx0 + m) * BLK, span, BLK, frame_w);
    const uint32_t* cb = cblk + m * BLK * CS;
    uint32_t creg[kCurInRegs ? BLK * CW : 1];
    uint32_t qcur = 0;
    if constexpr (kCurInRegs) {
#pragma unroll
      for (int i = 0; i < BLK * CW; ++i) {
        creg[i] = cb[i];
        if constexpr (!SAD) qcur = __dp4a(creg[i], creg[i], qcur);
      }
    } else if constexpr (!SAD && !SSIM) {
      for (int i = 0; i < BLK * CS; ++i) qcur = __dp4a(cb[i], cb[i], qcur);
    }
    // SSIM: Σcur (and above blk 16 Σcur²) and the block's terms of the
    // score.
    [[maybe_unused]] CurStats cst;
    if constexpr (SSIM) {
      uint32_t scur = 0;
      if constexpr (kCurInRegs) {
#pragma unroll
        for (int i = 0; i < BLK * CW; ++i)
          scur = __dp4a(creg[i], 0x01010101u, scur);
      } else {
        for (int i = 0; i < BLK * CS; ++i) {
          qcur = __dp4a(cb[i], cb[i], qcur);
          scur = __dp4a(cb[i], 0x01010101u, scur);
        }
      }
      cst = cur_stats<BLK * BLK>(static_cast<int>(scur),
                                 static_cast<int>(qcur), BLK * BLK);
    }
    const size_t o = static_cast<size_t>(by) * out_ld + bx0 + m;
    unsigned long long best = kNoKey;
    for (int oy = oy_first, ox = ox_first; oy < K;) {
      const uint32_t* wp = win + oy * l.ws + m * BLK + ox;
      uint32_t x = 0;  // Σ cur·ref (SSD, SSIM) or Σ |cur - ref| (SAD)
      if constexpr (kCurInRegs) {
#pragma unroll
        for (int r = 0; r < BLK; ++r) {
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            uint32_t v = wp[r * l.ws + 4 * c];
            if constexpr (SAD) {
              if (c == CW - 1) v &= kLast;
              x = sad4(creg[r * CW + c], v, x);
            } else {
              x = __dp4a(creg[r * CW + c], v, x);
            }
          }
        }
      } else {
        // Not unrolled whole: the compiler would hoist the block's words
        // out of the candidate loop into registers.
        const uint4* cq = reinterpret_cast<const uint4*>(cb);
#pragma unroll 4
        for (int r = 0; r < BLK; ++r) {
          const uint32_t* w = wp + r * l.ws;
#pragma unroll
          for (int q = 0; q < CW / 4; ++q) {
            const uint4 c = cq[r * (CS / 4) + q];
            if constexpr (SAD) {
              x = sad4(c.x, w[16 * q], x);
              x = sad4(c.y, w[16 * q + 4], x);
              x = sad4(c.z, w[16 * q + 8], x);
              x = sad4(c.w, w[16 * q + 12], x);
            } else {
              x = __dp4a(c.x, w[16 * q], x);
              x = __dp4a(c.y, w[16 * q + 4], x);
              x = __dp4a(c.z, w[16 * q + 8], x);
              x = __dp4a(c.w, w[16 * q + 12], x);
            }
          }
          if constexpr (CW % 4 == 2) {  // blk 21-24: two words past the quads
            const uint2 c = reinterpret_cast<const uint2*>(
                cq + r * (CS / 4) + CW / 4)[0];
            const int b = 16 * (CW / 4);
            if constexpr (SAD) {
              x = sad4(c.x, w[b], x);
              x = sad4(c.y, w[b + 4], x);
            } else {
              x = __dp4a(c.x, w[b], x);
              x = __dp4a(c.y, w[b + 4], x);
            }
          } else if constexpr (CW % 4 != 0) {  // blk 17-20: one; 25-28: three
            const uint4 c = cq[r * (CS / 4) + CW / 4];
            const int b = 16 * (CW / 4);
            x = __dp4a(c.x, w[b], x);
            if constexpr (CW % 4 == 3) {
              x = __dp4a(c.y, w[b + 4], x);
              x = __dp4a(c.z, w[b + 8], x);
            }
          }
        }
      }
      CostT<F> cost;
      if constexpr (SSIM) {
        const int2 sr = sums[oy * l.qs + m * BLK + ox];
        cost = ssim_score<BLK * BLK>(cst, sr.x, sr.y, static_cast<int>(x),
                                     BLK * BLK);
      } else if constexpr (SAD) {
        cost = static_cast<int>(x);
      } else {
        const int xi = static_cast<int>(x);
        cost = (static_cast<int>(qcur) - xi) +
               (qref[oy * l.qs + m * BLK + ox] - xi);
      }
      const bool ok = ox >= ox_ok.lo && ox <= ox_ok.hi &&
                      oy >= oy_ok.lo && oy <= oy_ok.hi;
      const int flat = oy * K + ox;
      if constexpr (EMIT)
        vol[static_cast<size_t>(flat) * plane + o] =
            ok ? cost : invalid_cost<F>();
      const unsigned long long key = cost_key<F>(cost, flat);
      if (ok && key < best) best = key;
      oy += oy_step;
      ox += ox_step;
      if (ox >= K) {
        ox -= K;
        ++oy;
      }
    }
    best = warp_min(best);
    if (wpm == 1) {
      if (lane == 0) write_key<F>(best, out_cost, out_idx, o, span * K + span);
    } else if (lane == 0) {
      red[m * wpm + part] = best;
    }
  }
  if (wpm > 1) {
    __syncthreads();
    if (threadIdx.x < ntile) {
      const int m = threadIdx.x;
      unsigned long long best = red[m * wpm];
      for (int p = 1; p < wpm; ++p) {
        const unsigned long long v = red[m * wpm + p];
        best = v < best ? v : best;
      }
      write_key<F>(best, out_cost, out_idx,
                   static_cast<size_t>(by) * out_ld + bx0 + m,
                   span * K + span);
    }
  }
}

// The tile: about 64 pixels of macroblocks, a multiple of kWarps, at most
// nbx, halved while its shared memory exceeds what the card gives one
// block or, above blk 16 (where warps can share a macroblock),
// kTileSmemBytes. Returns 0 if no tile fits.
template <int BLK, Form F, bool EMIT>
int search_tile(int nbx, int span, size_t* smem) {
  auto kernel = warp_search_kernel<BLK, F, EMIT>;
  int tbx = 64 / BLK / kWarps * kWarps;
  if (tbx < kWarps) tbx = kWarps;
  if (tbx > nbx) tbx = nbx;
  *smem = search_smem_bytes(BLK, tbx, span, F);
  while (tbx > 1 && ((BLK > 16 && *smem > kTileSmemBytes) ||
                     !reserve_smem(kernel, *smem))) {
    tbx /= 2;
    *smem = search_smem_bytes(BLK, tbx, span, F);
  }
  return reserve_smem(kernel, *smem) ? tbx : 0;
}

template <int BLK, Form F, bool EMIT>
int launch_instance(const void* cur, const void* ref, void* out_cost,
                    void* out_idx, void* vol, int cur_ld, int ref_ld,
                    int out_ld, int nby, int nbx, int span, int frame_h,
                    int frame_w, int y_origin, int x_origin,
                    cudaStream_t stream) {
  size_t smem = 0;
  const int tbx = search_tile<BLK, F, EMIT>(nbx, span, &smem);
  if (tbx == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nbx + tbx - 1) / tbx, nby);
  warp_search_kernel<BLK, F, EMIT><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(cur), cur_ld,
      static_cast<const uint8_t*>(ref), ref_ld,
      static_cast<CostT<F>*>(out_cost), static_cast<int32_t*>(out_idx),
      static_cast<CostT<F>*>(vol), out_ld, nby, nbx, tbx, span, frame_h,
      frame_w, y_origin, x_origin);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the body, with the volume when vol ([K*K][nby][out_ld] of
// the form's cost type) is not null. Returns the cudaError_t of the launch.
template <int BLK, Form F>
int launch_search(const void* cur, const void* ref, void* out_cost,
                  void* out_idx, void* vol, int cur_ld, int ref_ld,
                  int out_ld, int nby, int nbx, int span, int frame_h,
                  int frame_w, int y_origin, int x_origin,
                  cudaStream_t stream) {
  if (vol != nullptr)
    return launch_instance<BLK, F, true>(
        cur, ref, out_cost, out_idx, vol, cur_ld, ref_ld, out_ld, nby, nbx,
        span, frame_h, frame_w, y_origin, x_origin, stream);
  return launch_instance<BLK, F, false>(
      cur, ref, out_cost, out_idx, vol, cur_ld, ref_ld, out_ld, nby, nbx,
      span, frame_h, frame_w, y_origin, x_origin, stream);
}

// The search instance's resources (no volume) for a grid of nbx macroblocks
// a row: out[5] = {registers per thread, local (spill) bytes per thread,
// dynamic shared memory bytes, macroblocks per CUDA block, resident CUDA
// blocks per SM}. Returns the cudaError_t of the queries.
template <int BLK, Form F>
int search_occupancy(int nbx, int span, int* out) {
  auto kernel = warp_search_kernel<BLK, F, false>;
  size_t smem = 0;
  const int tbx = search_tile<BLK, F, false>(nbx, span, &smem);
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

}  // namespace me
