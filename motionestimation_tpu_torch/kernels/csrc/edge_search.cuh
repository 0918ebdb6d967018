// The search body of me_int_search (int_search.cu: exact SSD or SAD) and
// me_ssim_search (ssim_search.cu: SSIM): blocks with truncated extents, any
// blk, the last block row and column of a frame, or whole frames where no
// interior kernel applies, with an optional cost or score volume.
//
// Contract: that of full_search.cu (SSD, SAD) or ssim.cu (SSIM): operands,
// global origin, validity, tie rule, and what a block with no winner gets
// (INT32_MAX or score 0, and the centre index). A block's extents are bh =
// clip(frame_h - tl_y, 0, blk) and bw = clip(frame_w - tl_x, 0, blk); its
// cost or score covers those pixels only. With a volume (EMIT), vol[cand]
// is a [nby, out_ld] plane: each candidate's int32 cost or float32 score,
// INT32_MAX or -inf where the candidate is invalid.
//
// One CUDA block (kThreads threads) takes `tbx` macroblocks of one block
// row; all of them have the row's bh. Shared memory, in 32-bit words: the
// reduction slots [kWarps] (64-bit), the block's words [tbx][blk][cs] (zero
// past (bh, bw); cs a multiple of the vector width), the byte-offset
// window [bh + 2 span][ws] (word o packs window bytes o..o+3), the
// window's raw bytes [bh + 2 span][raw_w], and with a volume over tiles
// of kWarps macroblocks or more the tile's entries [K*K][tbx]. grid =
// (ceil(nbx / tbx), nby).
//
// - Packed bytes, as in warp_search.cuh: the window is staged once per
//   byte offset from a coalesced load of its raw bytes and one funnel shift
//   per word, so every candidate reads aligned words.
// - Runtime extents without planes of sums, so every extent costs the
//   same per word. With r the window word and m the macroblock's byte mask
//   (only the last word of a row has one, unless bw leaves whole words
//   out):
//     SAD:  one VABSDIFF4 with accumulate on r & m;
//     SSD:  d = __vabsdiffu4(c, r & m), then the unsigned __dp4a(d, d, acc),
//           exact in int32 while 255^2 * blk^2 < 2^31 (blk <= 181);
//     SSIM: X = __dp4a(c, r) (c is zero past bw), and Σref, Σref² by
//           __dp4a of r & m against 0x01010101 and against itself; Σcur,
//           Σcur² and the score's block terms once per macroblock.
// - A warp per macroblock, its lanes over the valid candidates only (the
//   rectangle of valid offsets, in raster order, stepping (oy, ox) with no
//   division); the 64-bit key (warp_search.cuh's cost_key) keeps "first in
//   raster order" under any order. Where the grid is short of two CUDA
//   blocks per SM (the edge slabs), two or four warps share a macroblock
//   and meet in the reduction slots.
// - Instances: CW = words per block row (1..8, blk <= 32) at compile time
//   with the block's row read as one 32-, 64- or 128-bit broadcast (two
//   above 16 bytes); CW = 0 for blk > 32, with runtime words per row read
//   as 128-bit broadcasts. blk, bh and bw are runtime.
// - Banks: the window's row stride is K modulo 32 words, so 32 consecutive
//   candidates of a block with its K*K window fall on 32 banks.
//
// What bounds it: K*K*bh*bw pixel-candidates per block against 2 bytes of
// frame per pixel, so shared-memory loads and integer issue, not device
// memory: per word one window load and a share of the block's broadcast,
// and 2 (SAD), 3 (SSD) or 4 (SSIM) integer operations. A volume adds one
// 4-byte entry per candidate. Over tiles of kWarps macroblocks or more
// (whole frames) the lanes put them in shared memory, and the CUDA block
// then stores each candidate's tbx macroblocks as consecutive entries (a
// whole 32-byte sector at tbx = 8), not one sector per entry. On the thin
// slabs (tiles of one or two) that would only add a barrier and a pass,
// so the lanes store their entries themselves.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "ssim_score.cuh"
#include "warp_search.cuh"

namespace me {
namespace edge {

// Words per staged block row: CW itself up to 2 (32- or 64-bit loads),
// else a multiple of 4 (128-bit loads); for CW = 0, from the runtime blk.
__host__ __device__ constexpr int row_words(int cw) {
  return cw <= 2 ? cw : (cw + 3) / 4 * 4;
}

struct EdgeLayout {
  int cs;      // words per staged block row
  int win_w;   // byte offsets per window row
  int ws;      // window row stride (words)
  int raw_w;   // raw bytes per window row, a multiple of 4
  int cur_words, win_words, raw_words;
  int vol_words;  // the tile's staged volume entries (0: not staged)
};

// Whether a tile stages its volume entries in shared memory.
__host__ __device__ inline bool stages_volume(bool emit, int tbx) {
  return emit && tbx >= kWarps;
}

// The layout for a tile of tbx macroblocks of side blk (rows sized for bh =
// blk) at CW (0: runtime words per row), with the volume's entries where
// the tile stages them (`emit`: the instance writes a volume).
__host__ __device__ inline EdgeLayout edge_layout(int blk, int tbx, int span,
                                                  int cw, bool emit) {
  EdgeLayout l;
  const int k = 2 * span + 1, win_h = blk + 2 * span;
  l.cs = row_words(cw > 0 ? cw : (blk + 3) / 4);
  // Candidate (oy, ox) of macroblock m reads offsets m*blk + ox + 4*c.
  l.win_w = (tbx - 1) * blk + 2 * span + 4 * (l.cs - 1) + 1;
  l.ws = bank_stride(l.win_w, k);
  l.raw_w = 4 * ((l.win_w + 7) / 4);  // words o..o+3 read two raw words
  l.cur_words = (tbx * blk * l.cs + 3) / 4 * 4;  // the window 16-aligned
  l.win_words = win_h * l.ws;
  l.raw_words = win_h * l.raw_w / 4;
  l.vol_words = stages_volume(emit, tbx) ? k * k * tbx : 0;
  return l;
}

inline size_t edge_smem_bytes(int blk, int tbx, int span, int cw,
                              bool emit) {
  const EdgeLayout l = edge_layout(blk, tbx, span, cw, emit);
  return sizeof(unsigned long long) * kWarps +
         sizeof(uint32_t) *
             (l.cur_words + l.win_words + l.raw_words + l.vol_words);
}

// The low n bytes of a word (n clipped to 0..4).
__device__ __forceinline__ uint32_t byte_mask(int n) {
  return n >= 4 ? 0xffffffffu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
}

// A candidate's sums: SSD, SAD: the cost in `a`; SSIM: Σcur·ref in `a`,
// Σref in s1, Σref² in s2.
struct Sums {
  uint32_t a = 0, s1 = 0, s2 = 0;
};

// One word: c the block's word (zero past its extent), r the window word,
// m its byte mask where MASK.
template <Form F, bool MASK>
__device__ __forceinline__ void word(Sums& s, uint32_t c, uint32_t r,
                                     uint32_t m) {
  const uint32_t rm = MASK ? r & m : r;
  if constexpr (F == Form::kSad) {
    s.a = sad4(c, rm, s.a);
  } else if constexpr (F == Form::kSsd) {
    const uint32_t d = __vabsdiffu4(c, rm);
    s.a = __dp4a(d, d, s.a);
  } else {
    s.a = __dp4a(c, r, s.a);
    s.s1 = __dp4a(rm, 0x01010101u, s.s1);
    s.s2 = __dp4a(rm, rm, s.s2);
  }
}

// The CW words of a staged block row, as one broadcast load (two above 16
// bytes).
template <int CW>
__device__ __forceinline__ void load_row(const uint32_t* p,
                                         uint32_t (&c)[CW]) {
  if constexpr (CW == 1) {
    c[0] = p[0];
  } else if constexpr (CW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    c[0] = v.x;
    c[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < CW; q += 4) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[q / 4];
      c[q] = v.x;
      if (q + 1 < CW) c[q + 1] = v.y;
      if (q + 2 < CW) c[q + 2] = v.z;
      if (q + 3 < CW) c[q + 3] = v.w;
    }
  }
}

// What a macroblock's candidates share: its staged words, rows, masks.
struct Block {
  const uint32_t* cb;  // staged words [bh][cs]
  int bh;
  int cwv;             // words per row holding a pixel of the block
  uint32_t mlast;      // byte mask of word cwv - 1
};

// The sums of the candidate whose window starts at wp (row stride ws).
// CW > 0: NARROW where the row's last words hold no pixel (cwv < CW), so
// every word takes its mask; else only word CW - 1. CW = 0: quads of
// words, the last one masked.
template <Form F, int CW, bool NARROW>
__device__ __forceinline__ Sums candidate(const uint32_t* wp, int ws,
                                          const Block& b, int cs) {
  Sums s;
  if constexpr (CW > 0) {
    constexpr int CS = row_words(CW);
    uint32_t m[CW];
#pragma unroll
    for (int k = 0; k < CW; ++k)
      m[k] = k < b.cwv - 1 ? 0xffffffffu : k == b.cwv - 1 ? b.mlast : 0u;
    const uint32_t* cr = b.cb;
    auto row = [&](const uint32_t* w) {
      uint32_t c[CW];
      load_row<CW>(cr, c);
#pragma unroll
      for (int k = 0; k < CW; ++k) {
        if constexpr (NARROW)
          word<F, true>(s, c[k], w[4 * k], m[k]);
        else if (k == CW - 1)
          word<F, true>(s, c[k], w[4 * k], b.mlast);
        else
          word<F, false>(s, c[k], w[4 * k], 0u);
      }
      cr += CS;
    };
    if constexpr (CW <= 4) {
      // Up to 16 rows: unrolled whole, leaving after the block's last.
#pragma unroll
      for (int r = 0; r < 4 * CW; ++r) {
        if (r >= b.bh) break;
        row(wp + r * ws);
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < b.bh; ++r) row(wp + r * ws);
    }
  } else {
    // Quads 0..nq-2 whole; the last one masked word by word.
    const int nq = max(1, (b.cwv + 3) / 4), last = 4 * (nq - 1);
    uint32_t mq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      mq[k] = last + k < b.cwv - 1 ? 0xffffffffu
              : last + k == b.cwv - 1 ? b.mlast
                                      : 0u;
    for (int r = 0; r < b.bh; ++r) {
      const uint4* cq = reinterpret_cast<const uint4*>(b.cb + r * cs);
      const uint32_t* w = wp + r * ws;
#pragma unroll 2
      for (int q = 0; q < nq - 1; ++q) {
        const uint4 c = cq[q];
        word<F, false>(s, c.x, w[16 * q], 0u);
        word<F, false>(s, c.y, w[16 * q + 4], 0u);
        word<F, false>(s, c.z, w[16 * q + 8], 0u);
        word<F, false>(s, c.w, w[16 * q + 12], 0u);
      }
      const uint4 c = cq[nq - 1];
      word<F, true>(s, c.x, w[4 * last], mq[0]);
      word<F, true>(s, c.y, w[4 * last + 4], mq[1]);
      word<F, true>(s, c.z, w[4 * last + 8], mq[2]);
      word<F, true>(s, c.w, w[4 * last + 12], mq[3]);
    }
  }
  return s;
}

// The lanes' scan of one macroblock's valid candidates (the rectangle
// [oy.lo, oy.hi] x [ox.lo, ox.hi] of offsets, raster order): lane `first`,
// then every `step`-th. Returns the lane's best key; with EMIT, puts each
// valid candidate's cost at vrow[flat * vstride].
template <Form F, int CW, bool EMIT, bool NARROW>
__device__ __forceinline__ unsigned long long scan(
    const uint32_t* win, int ws, const Block& b, int cs, int K, Range oy,
    Range ox, int first, int step, const CurStats& cst, int count,
    CostT<F>* vrow, size_t vstride) {
  unsigned long long best = kNoKey;
  const int nx = ox.hi - ox.lo + 1, ny = oy.hi - oy.lo + 1;
  if (nx <= 0 || ny <= 0) return best;
  const int nv = nx * ny;
  const int dy = step / nx, dx = step - dy * nx;
  int y = oy.lo + first / nx, x = ox.lo + first % nx;
  for (int j = first; j < nv; j += step) {
    const Sums s = candidate<F, CW, NARROW>(win + y * ws + x, ws, b, cs);
    CostT<F> cost;
    if constexpr (F == Form::kSsim) {
      cost = ssim_score(cst, static_cast<int>(s.s1), static_cast<int>(s.s2),
                        static_cast<int>(s.a), count);
    } else {
      cost = static_cast<int>(s.a);
    }
    const int flat = y * K + x;
    if constexpr (EMIT) vrow[flat * vstride] = cost;
    const unsigned long long key = cost_key<F>(cost, flat);
    best = key < best ? key : best;
    x += dx;
    y += dy;
    if (x > ox.hi) {
      x -= nx;
      ++y;
    }
  }
  return best;
}

template <Form F, int CW, bool EMIT>
__global__ void __launch_bounds__(kThreads)
edge_search_kernel(const uint8_t* __restrict__ cur, int cur_ld,
                   const uint8_t* __restrict__ ref, int ref_ld,
                   CostT<F>* __restrict__ out_cost,
                   int32_t* __restrict__ out_idx, CostT<F>* __restrict__ vol,
                   int out_ld, int nby, int nbx, int blk, int tbx, int span,
                   int frame_h, int frame_w, int y_origin, int x_origin) {
  constexpr bool SSIM = F == Form::kSsim;
  extern __shared__ unsigned long long smem[];
  const EdgeLayout l = edge_layout(blk, tbx, span, CW, EMIT);
  const int cs = l.cs;
  const int K = 2 * span + 1, KK = K * K;
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * tbx;
  const int ntile = min(tbx, nbx - bx0);
  const int gy = y_origin + by * blk;
  const int bh = max(0, min(blk, frame_h - gy));
  const int win_h = bh + 2 * span;
  // The halo's columns: the tile's in-frame pixels plus span each side.
  const int halo_w = min(nbx * blk, max(0, frame_w - x_origin)) + 2 * span;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  unsigned long long* red = smem;  // [kWarps]
  uint32_t* cblk = reinterpret_cast<uint32_t*>(smem + kWarps);
  uint32_t* win = cblk + l.cur_words;
  uint8_t* raw = reinterpret_cast<uint8_t*>(win + l.win_words);
  // The volume's entries: staged, candidate c of macroblock m at vtile[c *
  // tbx + m]; else straight to the volume.
  const bool staged = stages_volume(EMIT, tbx);
  CostT<F>* vtile = reinterpret_cast<CostT<F>*>(win + l.win_words +
                                                l.raw_words);
  const size_t plane = static_cast<size_t>(nby) * out_ld;
  const size_t vstride = staged ? tbx : plane;

  // Raw window bytes (zero past the halo), four to a lane so that each
  // lane has four loads in flight, and the block's words (zero past the
  // block's extents).
  const int wy0 = by * blk, wx0 = bx0 * blk;
  for (int r = warp; r < win_h; r += kWarps) {
    const uint8_t* src = ref + static_cast<size_t>(wy0 + r) * ref_ld + wx0;
    for (int c = 4 * lane; c < l.raw_w; c += 128) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (wx0 + c + b < halo_w) v |= static_cast<uint32_t>(src[c + b])
                                       << (8 * b);
      *reinterpret_cast<uint32_t*>(raw + r * l.raw_w + c) = v;
    }
  }
  for (int i = threadIdx.x; i < tbx * blk * cs; i += kThreads) {
    const int m = i / (blk * cs), rw = i - m * (blk * cs);
    const int r = rw / cs, w = rw - r * cs;
    const int bw = max(0, min(blk, frame_w - x_origin - (bx0 + m) * blk));
    uint32_t v = 0;
    if (m < ntile && r < bh && 4 * w < bw) {
      const uint8_t* p = cur + static_cast<size_t>(wy0 + r) * cur_ld +
                         (bx0 + m) * blk + 4 * w;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * w + b < bw) v |= static_cast<uint32_t>(p[b]) << (8 * b);
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

  // Warps per macroblock: kWarps / tbx where the tile is shorter than the
  // warps and divides them, else 1. Warp `warp` takes macroblocks slot,
  // slot + groups, ... and, of each, valid candidates part * 32 + lane + j
  // * step.
  const int wpm = tbx < kWarps && kWarps % tbx == 0 ? kWarps / tbx : 1;
  const int groups = kWarps / wpm;
  const int part = warp / groups, slot = warp - part * groups;
  const int first = part * 32 + lane, step = 32 * wpm;
  const Range oy = {max(0, span - gy),
                    min(2 * span, frame_h - bh - gy + span)};
  const int centre = span * K + span;
  for (int m = slot; m < ntile; m += groups) {
    const int gx = x_origin + (bx0 + m) * blk;
    const int bw = max(0, min(blk, frame_w - gx));
    const Range ox = {max(0, span - gx),
                      min(2 * span, frame_w - bw - gx + span)};
    Block b;
    b.cb = cblk + m * blk * cs;
    b.bh = bh;
    b.cwv = (bw + 3) / 4;
    b.mlast = byte_mask(bw - 4 * (b.cwv - 1));
    const int count = bh * bw;
    CurStats cst{};
    if constexpr (SSIM) {
      uint32_t sc = 0, qc = 0;
      for (int i = lane; i < bh * cs; i += 32) {
        sc = __dp4a(b.cb[i], 0x01010101u, sc);
        qc = __dp4a(b.cb[i], b.cb[i], qc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sc += __shfl_xor_sync(0xffffffffu, sc, off);
        qc += __shfl_xor_sync(0xffffffffu, qc, off);
      }
      cst = cur_stats(static_cast<int>(sc), static_cast<int>(qc), count);
    }
    const size_t o = static_cast<size_t>(by) * out_ld + bx0 + m;
    CostT<F>* vrow = !EMIT ? nullptr : staged ? vtile + m : vol + o;
    if constexpr (EMIT) {
      // The invalid candidates' entries; the scan writes the valid ones.
      int y = first / K, x = first - (first / K) * K;
      const int dy = step / K, dx = step - dy * K;
      for (int c = first; c < KK; c += step) {
        if (y < oy.lo || y > oy.hi || x < ox.lo || x > ox.hi)
          vrow[c * vstride] = invalid_cost<F>();
        x += dx;
        y += dy;
        if (x >= K) {
          x -= K;
          ++y;
        }
      }
    }
    unsigned long long best;
    if constexpr (CW > 0) {
      best = b.cwv < CW
                 ? scan<F, CW, EMIT, true>(win + m * blk, l.ws, b, cs, K, oy,
                                           ox, first, step, cst, count, vrow,
                                           vstride)
                 : scan<F, CW, EMIT, false>(win + m * blk, l.ws, b, cs, K,
                                            oy, ox, first, step, cst, count,
                                            vrow, vstride);
    } else {
      best = scan<F, CW, EMIT, false>(win + m * blk, l.ws, b, cs, K, oy, ox,
                                      first, step, cst, count, vrow, vstride);
    }
    best = warp_min(best);
    if (wpm == 1) {
      if (lane == 0) write_key<F>(best, out_cost, out_idx, o, centre);
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
                   static_cast<size_t>(by) * out_ld + bx0 + m, centre);
    }
  }
  if (staged) {
    // The tile's entries to the volume, each candidate's ntile macroblocks
    // consecutive.
    __syncthreads();
    CostT<F>* dst = vol + static_cast<size_t>(by) * out_ld + bx0;
    for (int i = threadIdx.x; i < KK * ntile; i += kThreads) {
      const int c = i / ntile, m = i - c * ntile;
      dst[static_cast<size_t>(c) * plane + m] = vtile[c * tbx + m];
    }
  }
}

// The tile: where the grid has at least four macroblocks per warp slot of
// two CUDA blocks per SM, kWarps macroblocks (times a power of two up to
// 16 / blk, sharing more of the window at small blk), a warp each; else
// two or one, shared by two or four warps. Halved while its shared memory
// exceeds kTileSmemBytes or what the card gives one block. Returns 0 if
// no tile fits.
// The current card's SMs, queried once per card (0 if the query fails).
inline int sm_count() {
  static int cached[64] = {};
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = n;
  return n;
}

template <Form F, int CW, bool EMIT>
int edge_tile(int nby, int nbx, int blk, int span, size_t* smem) {
  auto kernel = edge_search_kernel<F, CW, EMIT>;
  const int sms = sm_count();
  if (sms == 0) return 0;
  const long long fill = 2LL * sms, mbs = static_cast<long long>(nby) * nbx;
  int tbx;
  if (mbs >= fill * kWarps) {
    tbx = kWarps;
    while (2 * tbx / kWarps <= 16 / blk) tbx *= 2;
  } else {
    tbx = mbs >= 2 * fill ? 2 : 1;
  }
  if (tbx > nbx) tbx = nbx;
  *smem = edge_smem_bytes(blk, tbx, span, CW, EMIT);
  while (tbx > 1 && (*smem > kTileSmemBytes || !reserve_smem(kernel, *smem))) {
    tbx /= 2;
    *smem = edge_smem_bytes(blk, tbx, span, CW, EMIT);
  }
  return reserve_smem(kernel, *smem) ? tbx : 0;
}

template <Form F, int CW, bool EMIT>
int launch_edge(const void* cur, const void* ref, void* out_cost,
                void* out_idx, void* vol, int cur_ld, int ref_ld, int out_ld,
                int nby, int nbx, int blk, int span, int frame_h,
                int frame_w, int y_origin, int x_origin,
                cudaStream_t stream) {
  size_t smem = 0;
  const int tbx = edge_tile<F, CW, EMIT>(nby, nbx, blk, span, &smem);
  if (tbx == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nbx + tbx - 1) / tbx, nby);
  edge_search_kernel<F, CW, EMIT><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(cur), cur_ld,
      static_cast<const uint8_t*>(ref), ref_ld,
      static_cast<CostT<F>*>(out_cost), static_cast<int32_t*>(out_idx),
      static_cast<CostT<F>*>(vol), out_ld, nby, nbx, blk, tbx, span, frame_h,
      frame_w, y_origin, x_origin);
  return static_cast<int>(cudaGetLastError());
}

// The resources of the search instance (no volume) for an [nby, nbx] grid,
// as search_occupancy (warp_search.cuh) reports them.
template <Form F, int CW>
int edge_occupancy(int nby, int nbx, int blk, int span, int* out) {
  auto kernel = edge_search_kernel<F, CW, false>;
  size_t smem = 0;
  const int tbx = edge_tile<F, CW, false>(nby, nbx, blk, span, &smem);
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

}  // namespace edge
}  // namespace me

// The words-per-row instances: CW 1..8 (blk <= 32) and 0 (runtime, blk >
// 32). CASE(C) expands once per instance.
#define ME_EDGE_CW(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(0)
