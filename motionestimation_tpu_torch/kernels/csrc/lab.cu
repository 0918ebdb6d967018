// The speed-of-light tools for NVIDIA Hopper (sm_90a): the elementwise
// peak microbenchmarks and every scheme of the full-search lab.
//
// Nine kernels, each behind an extern "C" launcher loaded with ctypes:
//
// me_lab_peak (P1) — replaces `make_kernel` of tools/vpu_peak.py (:44,
//   `pallas_call` :78). Four accumulator streams per element of a float32
//   [rows, cols] plane, `inner` ops per iteration, `outer` iterations; each
//   iteration restarts streams 1-3 from a * {1/2, 1/4, 1/8} and ends with
//   stream 0 <- (s0 + s1) + (s2 + s3). Mixes:
//     fma  (0): s = fmaf(a, s, 1), inner / 4 steps of the four streams;
//     mix  (1): d = s - a; s = fmaf(d, d, s), inner / 8 steps;
//     roll (2): s[c] += s[(c + 1) % cols], inner / 8 steps (the TPU lane
//               rotation `pltpu.roll(x, cols - 1, 1)`).
// me_lab_chain (P2) — replaces `run_chain` of tools/vpu_peak.py (:99,
//   `pallas_call` :124): for each of `reps` repetitions,
//   out[g][x] = min over dy < 25 of sum_{r<8} (c[r*G+g][x] - e[(dy+r)*G+g][x])^2.
// me_lab_phase (L2) — replaces `make_phase_kernel` of tools/kern_lab.py
//   (:357, `pallas_call` :451): exact SSD by the cross term
//   (Qcur - X) + (Qref - X), X = sum c*e, or SAD, over float32 planes; the
//   lexicographic (cost, flat) minimum from (3e8, 625), invalid candidates
//   costing 3e8. Outputs float32 cost and int32 flat index per block.
// me_lab_diff (L4) — replaces `make_p4_kernel` of tools/kern_lab.py (:657,
//   `pallas_call` :730): SSD by the diff form sum (c - e)^2, or SAD, packed
//   as key = cost * 625 + flat - 2^31 in wrapping 32-bit arithmetic,
//   INT32_MAX where the candidate is invalid; the minimum key per block.
// me_lab_padded (L1) — replaces `make_kernel` of tools/kern_lab.py (:74,
//   `pallas_call` :241): no candidate masked, all 625 read the zero-padded
//   reference; the first minimum of (cost, flat) from the start pair (3e8,
//   312). NOP: the start pair; L0: SSD (Qcur - X) + (Qref - X); M1: L0
//   with each product a bfloat16 hi + lo pair (exact); M2: SAD over
//   bfloat16 |c - e| (exact); M3: L0 with each product rounded to bfloat16
//   (round to nearest even; the TPU's DEFAULT-precision matmul, as the port
//   defines it); "L1": X the raw product cur[y0 + R][c] * ref[y0 + R + oy]
//   [c + ox] at the stripe's row R (no block sum, no slide: an ablation).
// me_lab_p3 (L3) — replaces `make_p3_kernel` (:504, `pallas_call` :613):
//   L4's key by the cross term (Qcur + Qref) - 2X, or SAD; nochain ("P3A":
//   X the r = 0 term at offset row 0, 0 elsewhere, the rows the TPU kernel
//   leaves unwritten taken as 0) and nofold ("P3B": per block the least
//   over ox of int32 sum_r cur[8R + r][c] * ref[8R + r][c + ox]).
// me_lab_p5 (L5, `make_p5_kernel` :773, `pallas_call` :854): L4's key by
//   the diff form or SAD, over float32 or bfloat16 planes.
// me_lab_p6 (L6, `make_p6_kernel` :898, `pallas_call` :997): L4's key by
//   the cross term (Qcur - X) + (Qref - X), float32 or bfloat16 planes.
// me_lab_p7 (L7, `make_p7_kernel` :1044, `pallas_call` :1121): L4's key by
//   the diff form or SAD over bfloat16 planes.
// Several launchers share one instance of lab_search_kernel: P3S, P5S and
// L4's SAD; P5 and L4's SSD; P7 and P5B; P7S and P5SB.
//
// Lab contract (L1-L7): cur float32 [frame_h, frame_w] of integer pixels
// 0..255; ref float32 halo, at least [frame_h + 24, frame_w + 24], with
// reference pixel (y, x) at [y + 12, x + 12]. Blocks 8x8, span 12 (K = 25),
// flat = (dy + 12) * 25 + (dx + 12). A candidate is valid iff its window
// lies inside the frame (kern_lab.py:405-410; L1 and P3B mask nothing).
// Every partial sum is an
// integer below 2^24 (at most 64 * 255^2), so float32 is exact in any
// order, and cost * 625 + flat < 2^32: the unsigned key orders as the TPU's
// wrapped int32 key does. Outputs are [frame_h / 8, frame_w / 8], block
// starts only (the TPU kernels write every lane and the tool reads [:, ::8]).
//
// Design. P1: one thread per element with the four streams in registers.
// Each iteration reads `a` through an XOR with (iteration & mask), where
// the launcher passes mask 0: the value is unchanged, but no compiler pass
// (ptxas optimises the PTX too, and sees through an empty asm statement)
// can prove the restarted streams loop-invariant and hoist their chains
// out of the loop; the TPU kernel recomputes them too. The roll mix runs
// one CUDA block per row (cols <= 1024 threads): a step takes the right
// neighbour by a
// warp shuffle, and lane 31 takes the next warp's lane 0 from shared memory
// (double-buffered, one barrier per step); the last column wraps to the
// first. P2: one thread per (g, x) holding its 8 C and 32 E values in
// registers; each repetition reads the C values through the same XOR and
// feeds a minimum carried across repetitions, so the `reps` repetitions
// are neither folded into one nor dead. L2/L4: one CUDA block
// per `tile_h` pixel rows (the TPU stripe height) and `tbx` macroblocks,
// staging the current tile and its reference window as float32 in shared
// memory (L2 SSD also the Qref box-sum plane, column sums then row sums,
// once per CUDA block); 128 threads split each macroblock's 625 candidates
// and keep the best as a 64-bit key, reduced by common.cuh. The TPU
// choreography (phase-plane permutation matmuls, lane rolls of E, the
// static min tree) is not carried over. L3 and L5-L7 are template axes of
// the same kernel: the cost form, the key, the ablation, and bfloat16
// staging, whose window is kept in two copies shifted by one column so
// that a candidate at any column offset reads aligned pairs. L1 is its own
// kernel: a product stage writes each group of five candidates' products
// for the whole tile to a shared-memory scratch (the TPU's `p_ref`), and a
// compaction stage reads them back for the block sums.
//
// What bounds it. P1 and P2 are FP32-lane issue: one FMA (or sub) per lane
// per clock, 128 lanes per SM. L2-L7: one shared-memory load and one FMA per
// pixel-candidate (2.62 G at 2048x2048); the load, 32 lanes per SM per
// clock, comes first; bfloat16 pairs halve the loads. L1 adds a shared store
// and a load per pixel-candidate for the product scratch, and its 161 KB of
// shared memory at tile_h 128 leaves one CUDA block of 8 warps per SM, too
// few to hide the latency of the scratch's loads and stores (on an H100 the
// product stage alone, variant "L1", takes ~4.6x L4's whole search).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using me::kNoKey;
using me::kThreads;
using me::kWarps;
using me::reserve_smem;
using me::warp_store_min;

constexpr int kBlk = 8;
constexpr int kSpan = 12;
constexpr int kK = 2 * kSpan + 1;
constexpr uint32_t kBig = 300000000u;  // the lab's BIG = 3e8, exact in f32
constexpr int kChainBlk = 8;
constexpr int kChainK = 25;

// v with its bits XORed by `flip`: v itself when flip is 0, which the
// compiler cannot prove when flip depends on a kernel argument.
__device__ __forceinline__ float flipped(float v, int flip) {
  return __int_as_float(__float_as_int(v) ^ flip);
}

// ---------------------------------------------------------------------------
// P1, fma and mix: one thread per element.
template <int MIX>
__global__ void __launch_bounds__(256)
peak_kernel(const float* __restrict__ a_in, float* __restrict__ out, int n,
            int inner, int outer, int mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a_i = a_in[i];
  float x = a_i;
  for (int it = 0; it < outer; ++it) {
    const float a = flipped(a_i, it & mask);
    float s0 = x, s1 = a * 0.5f, s2 = a * 0.25f, s3 = a * 0.125f;
    if (MIX == 0) {
#pragma unroll 16
      for (int k = 0; k < inner / 4; ++k) {
        s0 = fmaf(a, s0, 1.0f);
        s1 = fmaf(a, s1, 1.0f);
        s2 = fmaf(a, s2, 1.0f);
        s3 = fmaf(a, s3, 1.0f);
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < inner / 8; ++k) {
        const float d0 = s0 - a, d1 = s1 - a, d2 = s2 - a, d3 = s3 - a;
        s0 = fmaf(d0, d0, s0);
        s1 = fmaf(d1, d1, s1);
        s2 = fmaf(d2, d2, s2);
        s3 = fmaf(d3, d3, s3);
      }
    }
    x = (s0 + s1) + (s2 + s3);
  }
  out[i] = x;
}

// P1, roll: one CUDA block per row, blockDim.x == cols (a multiple of 32,
// at most 1024). hand: [2][4][cols / 32] floats, each warp's lane-0 values.
__global__ void __launch_bounds__(1024)
peak_roll_kernel(const float* __restrict__ a_in, float* __restrict__ out,
                 int cols, int inner, int outer, int mask) {
  extern __shared__ float hand[];
  const int c = threadIdx.x, lane = c & 31, warp = c >> 5;
  const int nw = cols >> 5;
  const int next = warp + 1 == nw ? 0 : warp + 1;
  const size_t i = static_cast<size_t>(blockIdx.x) * cols + c;
  const float a_i = a_in[i];
  float x = a_i;
  int buf = 0;
  for (int it = 0; it < outer; ++it) {
    const float a = flipped(a_i, it & mask);
    float s[4] = {x, a * 0.5f, a * 0.25f, a * 0.125f};
    for (int k = 0; k < inner / 8; ++k) {
      float* h = hand + buf * 4 * nw;
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) h[j * nw + warp] = s[j];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float nb = __shfl_down_sync(0xffffffffu, s[j], 1);
        if (lane == 31) nb = h[j * nw + next];
        s[j] += nb;
      }
      buf ^= 1;
    }
    x = (s[0] + s[1]) + (s[2] + s[3]);
  }
  out[i] = x;
}

// ---------------------------------------------------------------------------
// P2: one thread per (g, x) of the [g_rows, w] output.
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ c, const float* __restrict__ e,
             float* __restrict__ out, int g_rows, int w, int reps,
             int mask) {
  constexpr int kPhase = kChainBlk + kChainK - 1;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= g_rows * w) return;
  const int g = i / w, x = i - g * w;
  float c0[kChainBlk], er[kPhase];
#pragma unroll
  for (int r = 0; r < kChainBlk; ++r)
    c0[r] = c[static_cast<size_t>(r * g_rows + g) * w + x];
#pragma unroll
  for (int p = 0; p < kPhase; ++p)
    er[p] = e[static_cast<size_t>(p * g_rows + g) * w + x];
  // The minimum runs on across repetitions (each gives the same value), so
  // no repetition's work is dead.
  float total = __int_as_float(0x7f800000);  // +inf
  for (int rep = 0; rep < reps; ++rep) {
    float cr[kChainBlk];
#pragma unroll
    for (int r = 0; r < kChainBlk; ++r) cr[r] = flipped(c0[r], rep & mask);
#pragma unroll
    for (int dy = 0; dy < kChainK; ++dy) {
      float d = cr[0] - er[dy];
      float acc = d * d;
#pragma unroll
      for (int r = 1; r < kChainBlk; ++r) {
        d = cr[r] - er[dy + r];
        acc = fmaf(d, d, acc);
      }
      total = fminf(total, acc);
    }
  }
  out[i] = total;
}

// ---------------------------------------------------------------------------
// L2 / L3 / L4 / L5 / L6 / L7. FORM: 0 = SSD by the cross term
// (Qcur - X) + (Qref - X) (L2, L6), 1 = SSD by the diff form (L4, L5, L7),
// 2 = SAD, 3 = SSD by the cross term (Qcur + Qref) - 2X (L3). KEY: false
// writes L2's (cost, idx), true the packed key. ABL: 0, or L3's ablations
// 1 = nochain (X is the r = 0 term at offset row 0, else 0) and 2 = nofold
// (the first column's 8-term chain at offset row 0, unmasked, least over
// ox). BF16: the window and tile staged as bfloat16 pairs, the window in
// two copies shifted by one column so that every candidate reads aligned
// __nv_bfloat162 pairs, two pixels per 32-bit shared load.
// grid = (ceil(nbx / tbx), frame_h / tile_h).
struct LabLayout {
  int tile_h, tw, win_h, win_w, q_h, q_w, nblk;
  __host__ __device__ LabLayout(int tile_h_, int tbx)
      : tile_h(tile_h_), tw(tbx * kBlk), win_h(tile_h_ + 2 * kSpan),
        win_w(tbx * kBlk + 2 * kSpan), q_h(tile_h_ - kBlk + 2 * kSpan + 1),
        q_w(tbx * kBlk - kBlk + 2 * kSpan + 1),
        nblk((tile_h_ / kBlk) * tbx) {}
  // Bytes of shared memory: key slots, window, current tile, and for the
  // cross term the column-sum and Qref planes. With bf16 the window is two
  // bfloat16 copies (the same bytes as one float32 copy) and the tile half.
  __host__ __device__ size_t bytes(bool qref, bool bf16) const {
    size_t floats = static_cast<size_t>(win_h) * win_w +
                    static_cast<size_t>(tile_h) * tw / (bf16 ? 2 : 1);
    if (qref)
      floats += static_cast<size_t>(q_h) * win_w + static_cast<size_t>(q_h) * q_w;
    return sizeof(unsigned long long) * nblk * kWarps + sizeof(float) * floats;
  }
};

// Window pixel (r, c) from the float32 window or bfloat16 copy 0.
template <bool BF16>
__device__ __forceinline__ float win_at(const float* win,
                                        const __nv_bfloat162* win16, int ld,
                                        int r, int c) {
  if constexpr (BF16) {
    const __nv_bfloat162 p = win16[r * (ld / 2) + (c >> 1)];
    return (c & 1) ? __high2float(p) : __low2float(p);
  } else {
    return win[r * ld + c];
  }
}

template <int FORM, bool KEY, int ABL, bool BF16>
__global__ void __launch_bounds__(kThreads)
lab_search_kernel(const float* __restrict__ cur, int cur_ld,
                  const float* __restrict__ ref, int ref_ld,
                  float* __restrict__ out_cost, int32_t* __restrict__ out_idx,
                  int32_t* __restrict__ out_key, int out_ld, int frame_h,
                  int frame_w, int tile_h, int tbx, int flip) {
  constexpr bool kQref = FORM == 0 || FORM == 3;
  static_assert(KEY || (ABL == 0 && !BF16), "L2 has no ablation or bf16");
  static_assert(ABL == 0 || FORM == 3, "the ablations are L3's");
  extern __shared__ unsigned long long smem[];
  const LabLayout L(tile_h, tbx);
  const int nbx = frame_w / kBlk;
  const int bx0 = blockIdx.x * tbx;
  const int ntile = min(tbx, nbx - bx0);
  const int y0 = blockIdx.y * tile_h, x0 = bx0 * kBlk;
  const int pw = L.win_w / 2, tpw = L.tw / 2;  // bfloat16 pairs per row

  unsigned long long* red = smem;                                    // [nblk*kWarps]
  float* win = reinterpret_cast<float*>(red + L.nblk * kWarps);      // [win_h*win_w]
  __nv_bfloat162* win16 = reinterpret_cast<__nv_bfloat162*>(win);    // [2][win_h*pw]
  float* cblk = win + L.win_h * L.win_w;                             // [tile_h*tw]
  __nv_bfloat162* cblk16 = reinterpret_cast<__nv_bfloat162*>(cblk);  // [tile_h*tpw]
  float* colsq = cblk + L.tile_h * L.tw / (BF16 ? 2 : 1);            // [q_h*win_w]
  float* qref = colsq + L.q_h * L.win_w;                             // [q_h*q_w]

  // Stage the window and the current tile; columns past the frame's last
  // macroblock of this CUDA block are zero and never read by a candidate.
  const int used_w = ntile * kBlk + 2 * kSpan;
  auto ref_at = [&](int r, int c) {
    return c < used_w ? ref[static_cast<size_t>(y0 + r) * ref_ld + x0 + c]
                      : 0.0f;
  };
  auto cur_at = [&](int r, int c) {
    return c < ntile * kBlk
               ? cur[static_cast<size_t>(y0 + r) * cur_ld + x0 + c]
               : 0.0f;
  };
  if constexpr (BF16) {
    // Copy s, pair q of row r: window columns (2q + s, 2q + s + 1).
    for (int i = threadIdx.x; i < 2 * L.win_h * pw; i += kThreads) {
      const int s = i / (L.win_h * pw), rem = i - s * L.win_h * pw;
      const int r = rem / pw, c = 2 * (rem - r * pw) + s;
      win16[i] = __floats2bfloat162_rn(ref_at(r, c), ref_at(r, c + 1));
    }
    for (int i = threadIdx.x; i < L.tile_h * tpw; i += kThreads) {
      const int r = i / tpw, c = 2 * (i - r * tpw);
      cblk16[i] = __floats2bfloat162_rn(cur_at(r, c), cur_at(r, c + 1));
    }
  } else {
    for (int i = threadIdx.x; i < L.win_h * L.win_w; i += kThreads) {
      const int r = i / L.win_w;
      win[i] = ref_at(r, i - r * L.win_w);
    }
    for (int i = threadIdx.x; i < L.tile_h * L.tw; i += kThreads) {
      const int r = i / L.tw;
      cblk[i] = cur_at(r, i - r * L.tw);
    }
  }
  __syncthreads();
  if constexpr (kQref) {
    // Qref[y][x] = sum over the 8x8 box at window (y, x) of ref^2.
    for (int i = threadIdx.x; i < L.q_h * L.win_w; i += kThreads) {
      const int r = i / L.win_w, c = i - r * L.win_w;
      float s = 0.0f;
#pragma unroll
      for (int a = 0; a < kBlk; ++a) {
        const float v = win_at<BF16>(win, win16, L.win_w, r + a, c);
        s = fmaf(v, v, s);
      }
      colsq[i] = s;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < L.q_h * L.q_w; i += kThreads) {
      const int r = i / L.q_w, c = i - r * L.q_w;
      float s = 0.0f;
#pragma unroll
      for (int b = 0; b < kBlk; ++b) s += colsq[r * L.win_w + c + b];
      qref[i] = s;
    }
    __syncthreads();
  }

  for (int m = 0; m < L.nblk; ++m) {
    const int R = m / tbx, bm = m - R * tbx;
    unsigned long long best = kNoKey;
    if (bm < ntile) {
      float creg[kBlk * kBlk];
      float qcur = 0.0f;
#pragma unroll
      for (int r = 0; r < kBlk; ++r) {
#pragma unroll
        for (int q = 0; q < kBlk / 2; ++q) {
          float2 v;
          if constexpr (BF16) {
            v = __bfloat1622float2(cblk16[(R * kBlk + r) * tpw + bm * 4 + q]);
          } else {
            const float* cb = cblk + (R * kBlk + r) * L.tw + bm * kBlk + 2 * q;
            v = make_float2(cb[0], cb[1]);
          }
          creg[r * kBlk + 2 * q] = v.x;
          creg[r * kBlk + 2 * q + 1] = v.y;
          if constexpr (kQref) qcur = fmaf(v.y, v.y, fmaf(v.x, v.x, qcur));
        }
      }
      const int gy = y0 + R * kBlk, gx = x0 + bm * kBlk;
      // Valid offsets o = d + span: 0 <= g + o - span <= frame - 8.
      const int oy_lo = max(0, kSpan - gy);
      const int oy_hi = min(2 * kSpan, frame_h - kBlk - gy + kSpan);
      const int ox_lo = max(0, kSpan - gx);
      const int ox_hi = min(2 * kSpan, frame_w - kBlk - gx + kSpan);
      for (int cand = threadIdx.x; cand < kK * kK; cand += kThreads) {
        const int oy = cand / kK, ox = cand - oy * kK;
        unsigned long long key;
        if (ABL != 2 &&
            (oy < oy_lo || oy > oy_hi || ox < ox_lo || ox > ox_hi)) {
          key = KEY ? 0xffffffffull
                    : (static_cast<unsigned long long>(kBig) << 32) |
                          static_cast<unsigned>(cand);
        } else {
          const int row = R * kBlk + oy, col = bm * kBlk + ox;
          const float* wp = win + row * L.win_w + col;
          // Copy (col & 1) holds the pairs that start at col.
          const __nv_bfloat162* wq =
              win16 + (col & 1) * L.win_h * pw + row * pw + (col >> 1);
          float acc = 0.0f, col0 = 0.0f;
          auto term = [&](float c, float e, bool first_col) {
            if (ABL == 2 && first_col) {
              col0 = fmaf(c, e, col0);
            } else if constexpr (FORM == 0 || FORM == 3) {
              acc = fmaf(c, e, acc);
            } else if constexpr (FORM == 1) {
              const float d = c - e;
              acc = fmaf(d, d, acc);
            } else {
              acc += fabsf(c - e);
            }
          };
          if constexpr (ABL == 1) {
            // nochain: the TPU kernel writes only the first term of the
            // offset-row-0 chain; the rest of its buffer is taken as 0.
            if (oy == 0) {
#pragma unroll
              for (int k = 0; k < kBlk; ++k)
                acc = fmaf(creg[k], win_at<BF16>(win, win16, L.win_w, row, col + k),
                           acc);
            }
          } else {
#pragma unroll
            for (int r = 0; r < kBlk; ++r) {
#pragma unroll
              for (int q = 0; q < kBlk / 2; ++q) {
                float2 e;
                if constexpr (BF16) {
                  e = __bfloat1622float2(wq[r * pw + q]);
                } else {
                  e = make_float2(wp[r * L.win_w + 2 * q],
                                  wp[r * L.win_w + 2 * q + 1]);
                }
                term(creg[r * kBlk + 2 * q], e.x, q == 0);
                term(creg[r * kBlk + 2 * q + 1], e.y, false);
              }
            }
          }
          if constexpr (ABL == 2) {
            // nofold: the int32 chain value, ordered as unsigned; the other
            // offset rows' chains reach the key only through (bits & flip),
            // flip being 0, so they stay computed and never win.
            const uint32_t live = __float_as_uint(acc) & static_cast<uint32_t>(flip);
            key = (oy == 0 ? static_cast<uint32_t>(static_cast<int32_t>(col0)) ^
                                 0x80000000u
                           : 0xffffffffu) ^ live;
          } else {
            float cost = acc;
            if constexpr (FORM == 0)
              cost = (qcur - acc) +
                     (qref[(R * kBlk + oy) * L.q_w + bm * kBlk + ox] - acc);
            if constexpr (FORM == 3)
              cost = (qcur + qref[(R * kBlk + oy) * L.q_w + bm * kBlk + ox]) -
                     (acc + acc);
            const uint32_t ic = static_cast<uint32_t>(cost);  // exact, >= 0
            key = KEY ? static_cast<unsigned long long>(
                            ic * static_cast<uint32_t>(kK * kK) +
                            static_cast<uint32_t>(cand))
                      : (static_cast<unsigned long long>(ic) << 32) |
                            static_cast<unsigned>(cand);
          }
        }
        best = key < best ? key : best;
      }
    }
    warp_store_min(best, red, m);
  }
  __syncthreads();
  for (int m = threadIdx.x; m < L.nblk; m += kThreads) {
    const int R = m / tbx, bm = m - R * tbx;
    if (bm >= ntile) continue;
    const unsigned long long best = me::slot_min(red, m);
    const size_t o =
        static_cast<size_t>(blockIdx.y * (tile_h / kBlk) + R) * out_ld + bx0 + bm;
    if constexpr (KEY) {
      // key - 2^31 in wrapping int32: flip the top bit.
      out_key[o] = static_cast<int32_t>(static_cast<uint32_t>(best) ^ 0x80000000u);
    } else {
      out_cost[o] = static_cast<float>(static_cast<uint32_t>(best >> 32));
      out_idx[o] = static_cast<int32_t>(best & 0xffffffffu);
    }
  }
}

bool lab_shape_ok(int tile_h, int frame_h, int frame_w) {
  return tile_h > 0 && tile_h % kBlk == 0 && frame_h % tile_h == 0 &&
         frame_w % kBlk == 0 && frame_w > 0;
}

template <int FORM, bool KEY, int ABL = 0, bool BF16 = false>
int launch_lab(const void* cur, const void* ref, void* out_cost,
               void* out_idx, void* out_key, int cur_ld, int ref_ld,
               int out_ld, int frame_h, int frame_w, int tile_h,
               cudaStream_t stream) {
  if (!lab_shape_ok(tile_h, frame_h, frame_w))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool kQref = FORM == 0 || FORM == 3;
  auto kernel = lab_search_kernel<FORM, KEY, ABL, BF16>;
  const int nbx = frame_w / kBlk;
  int tbx = nbx < 8 ? nbx : 8;  // 64 pixels of macroblocks per CUDA block
  while (!reserve_smem(kernel, LabLayout(tile_h, tbx).bytes(kQref, BF16)) &&
         tbx > 1)
    tbx /= 2;
  const size_t smem = LabLayout(tile_h, tbx).bytes(kQref, BF16);
  if (!reserve_smem(kernel, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nbx + tbx - 1) / tbx, frame_h / tile_h);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(cur), cur_ld, static_cast<const float*>(ref),
      ref_ld, static_cast<float*>(out_cost), static_cast<int32_t*>(out_idx),
      static_cast<int32_t*>(out_key), out_ld, frame_h, frame_w, tile_h, tbx,
      0);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// L1: the unmasked search over the zero-padded reference through a product
// scratch. VAR (PadVariant) picks the TPU variant; the scratch holds, per
// candidate of a group of kGroup, the [tile_h, tw] products: float32 (L0,
// "L1"), a bfloat16 hi/lo pair (M1), bfloat16 |c - e| (M2) or the product
// rounded to bfloat16 (M3). Each group is one product stage, a barrier, one
// compaction stage (the 8x8 block sums of the scratch, or for "L1" the raw
// product at the stripe's row R and the block's first column), the cost,
// and a shared 64-bit atomic minimum of (cost ordered as int32, flat) per
// block, which is the first minimum in raster order whatever the order of
// the threads. grid = (ceil(nbx / tbx), frame_h / tile_h).
enum PadVariant { kNop = 0, kL0 = 1, kRaw = 2, kM1 = 3, kM2 = 4, kM3 = 5 };
constexpr int kGroup = 5;  // candidates per product stage: the tool's chunk
constexpr int kPadThreads = 256;
static_assert(kK % kGroup == 0, "groups cover the offset row");

__host__ __device__ constexpr bool pad_qsums(int var) { return var != kNop && var != kM2; }
__host__ __device__ constexpr size_t pad_prod_bytes(int var) {
  return var == kM2 || var == kM3 ? 2 : 4;
}

struct PadLayout : LabLayout {
  using LabLayout::LabLayout;
  // Bytes: a key and a Qcur per block, window, current tile, the Qref
  // plane, and one region that first holds the Qref column sums and then
  // the product scratch.
  __host__ __device__ size_t scratch_bytes(int var) const {
    const size_t prod = kGroup * pad_prod_bytes(var) * tile_h * tw;
    const size_t cols = sizeof(float) * q_h * win_w;
    return var == kNop ? 0 : (pad_qsums(var) && cols > prod ? cols : prod);
  }
  __host__ __device__ size_t bytes(int var) const {
    size_t b = (sizeof(unsigned long long) + sizeof(float)) * nblk +
               sizeof(float) * (static_cast<size_t>(win_h) * win_w +
                                static_cast<size_t>(tile_h) * tw);
    if (pad_qsums(var)) b += sizeof(float) * q_h * q_w;
    return b + scratch_bytes(var);
  }
};

template <int VAR>
using PadProd = std::conditional_t<
    VAR == kM1, __nv_bfloat162,
    std::conditional_t<VAR == kM2 || VAR == kM3, __nv_bfloat16, float>>;

template <int VAR>
__device__ __forceinline__ void pad_store(PadProd<VAR>* p, float c, float e) {
  if constexpr (VAR == kM1) {
    const float prod = c * e;  // exact: an integer <= 65025
    const __nv_bfloat16 hi = __float2bfloat16_rn(prod);
    *p = __halves2bfloat162(hi,
                            __float2bfloat16_rn(prod - __bfloat162float(hi)));
  } else if constexpr (VAR == kM2) {
    *p = __float2bfloat16_rn(fabsf(c - e));
  } else if constexpr (VAR == kM3) {
    *p = __float2bfloat16_rn(c * e);
  } else {
    *p = c * e;
  }
}

template <int VAR>
__device__ __forceinline__ float pad_load(const PadProd<VAR>* p) {
  if constexpr (VAR == kM1) {
    return __low2float(*p) + __high2float(*p);
  } else if constexpr (VAR == kM2 || VAR == kM3) {
    return __bfloat162float(*p);
  } else {
    return *p;
  }
}

// A cost (an integer in float32, possibly negative for M3 and "L1") and a
// flat index as one key whose unsigned order is (cost, flat)'s.
__device__ __forceinline__ unsigned long long pad_key(float cost, int flat) {
  const uint32_t c = static_cast<uint32_t>(static_cast<int32_t>(cost)) ^
                     0x80000000u;
  return (static_cast<unsigned long long>(c) << 32) |
         static_cast<uint32_t>(flat);
}

template <int VAR>
__global__ void __launch_bounds__(kPadThreads)
lab_padded_kernel(const float* __restrict__ cur, int cur_ld,
                  const float* __restrict__ ref, int ref_ld,
                  float* __restrict__ out_cost, int32_t* __restrict__ out_idx,
                  int out_ld, int frame_w, int tile_h, int tbx, int flip) {
  using P = PadProd<VAR>;
  constexpr bool kQ = pad_qsums(VAR);
  extern __shared__ unsigned long long smem[];
  const PadLayout L(tile_h, tbx);
  const int nbx = frame_w / kBlk;
  const int bx0 = blockIdx.x * tbx;
  const int ntile = min(tbx, nbx - bx0);
  const int y0 = blockIdx.y * tile_h, x0 = bx0 * kBlk;
  const int plane = L.tile_h * L.tw;  // products per candidate

  unsigned long long* best = smem;                              // [nblk]
  float* qcur = reinterpret_cast<float*>(best + L.nblk);        // [nblk]
  float* win = qcur + L.nblk;                                   // [win_h*win_w]
  float* cblk = win + L.win_h * L.win_w;                        // [tile_h*tw]
  float* qref = cblk + plane;                                   // [q_h*q_w]
  float* colsq = qref + (kQ ? L.q_h * L.q_w : 0);               // [q_h*win_w]
  P* prod = reinterpret_cast<P*>(colsq);                        // [kGroup*plane]

  // Stage the window and the tile. No candidate is masked: all 625 read
  // the zero-padded reference. Columns past the frame's last macroblock of
  // this CUDA block are zero and reach no output.
  const int used_w = ntile * kBlk + 2 * kSpan;
  uint32_t live = 0;
  if (VAR == kNop && threadIdx.x == 0) *reinterpret_cast<uint32_t*>(best) = 0;
  for (int i = threadIdx.x; i < L.win_h * L.win_w; i += kPadThreads) {
    const int r = i / L.win_w, c = i - r * L.win_w;
    const float v = c < used_w
                        ? ref[static_cast<size_t>(y0 + r) * ref_ld + x0 + c]
                        : 0.0f;
    win[i] = v;
    live |= __float_as_uint(v);
  }
  for (int i = threadIdx.x; i < plane; i += kPadThreads) {
    const int r = i / L.tw, c = i - r * L.tw;
    const float v = c < ntile * kBlk
                        ? cur[static_cast<size_t>(y0 + r) * cur_ld + x0 + c]
                        : 0.0f;
    cblk[i] = v;
    live |= __float_as_uint(v);
  }
  __syncthreads();

  if constexpr (VAR == kNop) {
    // The start pair only. Every staged value reaches the cost through
    // (live & flip), flip being 0, so the staging is not dead code.
    live = __reduce_or_sync(0xffffffffu, live);
    if ((threadIdx.x & 31) == 0)
      atomicOr(reinterpret_cast<uint32_t*>(best), live);
    __syncthreads();
    const uint32_t all = *reinterpret_cast<uint32_t*>(best) &
                         static_cast<uint32_t>(flip);
    for (int m = threadIdx.x; m < L.nblk; m += kPadThreads) {
      const int R = m / tbx, bm = m - R * tbx;
      if (bm >= ntile) continue;
      const size_t o = static_cast<size_t>(blockIdx.y * (tile_h / kBlk) + R) *
                           out_ld + bx0 + bm;
      out_cost[o] = __uint_as_float(__float_as_uint(static_cast<float>(kBig)) ^ all);
      out_idx[o] = kSpan * kK + kSpan;
    }
    return;
  } else {
    if constexpr (kQ) {
      for (int m = threadIdx.x; m < L.nblk; m += kPadThreads) {
        const int R = m / tbx, bm = m - R * tbx;
        float s = 0.0f;
        for (int r = 0; r < kBlk; ++r)
          for (int k = 0; k < kBlk; ++k) {
            const float v = cblk[(R * kBlk + r) * L.tw + bm * kBlk + k];
            s = fmaf(v, v, s);
          }
        qcur[m] = s;
      }
      for (int i = threadIdx.x; i < L.q_h * L.win_w; i += kPadThreads) {
        const int r = i / L.win_w, c = i - r * L.win_w;
        float s = 0.0f;
#pragma unroll
        for (int a = 0; a < kBlk; ++a) {
          const float v = win[(r + a) * L.win_w + c];
          s = fmaf(v, v, s);
        }
        colsq[i] = s;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < L.q_h * L.q_w; i += kPadThreads) {
        const int r = i / L.q_w, c = i - r * L.q_w;
        float s = 0.0f;
#pragma unroll
        for (int b = 0; b < kBlk; ++b) s += colsq[r * L.win_w + c + b];
        qref[i] = s;
      }
    }
    // The tool's start pair (3e8, centre): no cost reaches 3e8.
    for (int m = threadIdx.x; m < L.nblk; m += kPadThreads)
      best[m] = pad_key(static_cast<float>(kBig), kSpan * kK + kSpan);
    __syncthreads();  // also: the column sums are read before reuse

    // Product stage mapping: a thread keeps one column and every rstep-th
    // row, so the stage's addresses need no division.
    const int rstep = kPadThreads / L.tw;
    const int pc = threadIdx.x % L.tw, pr = threadIdx.x / L.tw;
    for (int oy = 0; oy < kK; ++oy) {
      for (int ox0 = 0; ox0 < kK; ox0 += kGroup) {
        // Product stage: every pixel of the tile against each candidate.
        if (pr < rstep) {
#pragma unroll
          for (int t = 0; t < kGroup; ++t) {
            const float* e = win + oy * L.win_w + pc + ox0 + t;
            for (int r = pr; r < L.tile_h; r += rstep)
              pad_store<VAR>(prod + t * plane + r * L.tw + pc,
                             cblk[r * L.tw + pc], e[r * L.win_w]);
          }
        }
        __syncthreads();
        // Compaction stage: per (candidate, block), from the scratch.
        for (int i = threadIdx.x; i < kGroup * L.nblk; i += kPadThreads) {
          const int t = i / L.nblk, m = i - t * L.nblk;
          const int R = m / tbx, bm = m - R * tbx;
          if (bm >= ntile) continue;
          const P* p = prod + t * plane + bm * kBlk;
          float x;
          if constexpr (VAR == kRaw) {
            x = pad_load<VAR>(p + R * L.tw);  // the stripe's row R, not 8R
          } else {
            x = 0.0f;
#pragma unroll
            for (int a = 0; a < kBlk; ++a)
#pragma unroll
              for (int b = 0; b < kBlk; ++b)
                x += pad_load<VAR>(p + (R * kBlk + a) * L.tw + b);
          }
          const int ox = ox0 + t;
          float cost = x;
          if constexpr (kQ)
            cost = (qcur[m] - x) +
                   (qref[(R * kBlk + oy) * L.q_w + bm * kBlk + ox] - x);
          atomicMin(best + m, pad_key(cost, oy * kK + ox));
        }
        __syncthreads();
      }
    }
    for (int m = threadIdx.x; m < L.nblk; m += kPadThreads) {
      const int R = m / tbx, bm = m - R * tbx;
      if (bm >= ntile) continue;
      const size_t o = static_cast<size_t>(blockIdx.y * (tile_h / kBlk) + R) *
                           out_ld + bx0 + bm;
      out_cost[o] = static_cast<float>(static_cast<int32_t>(
          static_cast<uint32_t>(best[m] >> 32) ^ 0x80000000u));
      out_idx[o] = static_cast<int32_t>(best[m] & 0xffffffffu);
    }
  }
}

template <int VAR>
int launch_padded(const void* cur, const void* ref, void* out_cost,
                  void* out_idx, int cur_ld, int ref_ld, int out_ld,
                  int frame_h, int frame_w, int tile_h, cudaStream_t stream) {
  if (!lab_shape_ok(tile_h, frame_h, frame_w))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lab_padded_kernel<VAR>;
  const int nbx = frame_w / kBlk;
  int tbx = nbx < 4 ? nbx : 4;  // 32 pixels of macroblocks per CUDA block
  while (!reserve_smem(kernel, PadLayout(tile_h, tbx).bytes(VAR)) && tbx > 1)
    tbx /= 2;
  const size_t smem = PadLayout(tile_h, tbx).bytes(VAR);
  if (!reserve_smem(kernel, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nbx + tbx - 1) / tbx, frame_h / tile_h);
  kernel<<<grid, kPadThreads, smem, stream>>>(
      static_cast<const float*>(cur), cur_ld, static_cast<const float*>(ref),
      ref_ld, static_cast<float*>(out_cost), static_cast<int32_t*>(out_idx),
      out_ld, frame_w, tile_h, tbx, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mix: 0 = fma, 1 = mix, 2 = roll (cols a multiple of 32, at most 1024).
// a, out: float32 [rows, cols], contiguous. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int me_lab_peak(const void* a, void* out, int rows, int cols,
                           int inner, int outer, int mix, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  float* op = static_cast<float*>(out);
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mix == 2) {
    if (cols % 32 || cols > 1024) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * 2 * 4 * (cols / 32);
    peak_roll_kernel<<<rows, cols, smem, s>>>(ap, op, cols, inner, outer, 0);
    return static_cast<int>(cudaGetLastError());
  }
  const int n = rows * cols;
  const int grid = (n + 255) / 256;
  if (mix == 0) {
    peak_kernel<0><<<grid, 256, 0, s>>>(ap, op, n, inner, outer, 0);
  } else if (mix == 1) {
    peak_kernel<1><<<grid, 256, 0, s>>>(ap, op, n, inner, outer, 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// c: float32 [blk * g_rows, w], e: float32 [(blk + k - 1) * g_rows, w],
// out: float32 [g_rows, w], all contiguous; blk must be 8 and k 25.
extern "C" int me_lab_chain(const void* c, const void* e, void* out,
                            int g_rows, int w, int blk, int k, int reps,
                            void* stream) {
  if (blk != kChainBlk || k != kChainK || g_rows <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = g_rows * w;
  chain_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<const float*>(e),
      static_cast<float*>(out), g_rows, w, reps, 0);
  return static_cast<int>(cudaGetLastError());
}

// sad: 0 = SSD (the cross term), 1 = SAD. out_cost float32 and out_idx
// int32, [frame_h / 8][out_ld].
extern "C" int me_lab_phase(const void* cur, const void* ref, void* out_cost,
                            void* out_idx, int cur_ld, int ref_ld, int out_ld,
                            int frame_h, int frame_w, int tile_h, int sad,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sad)
    return launch_lab<2, false>(cur, ref, out_cost, out_idx, nullptr, cur_ld,
                                ref_ld, out_ld, frame_h, frame_w, tile_h, s);
  return launch_lab<0, false>(cur, ref, out_cost, out_idx, nullptr, cur_ld,
                              ref_ld, out_ld, frame_h, frame_w, tile_h, s);
}

// sad: 0 = SSD (the diff form), 1 = SAD. out_key int32 [frame_h / 8][out_ld].
extern "C" int me_lab_diff(const void* cur, const void* ref, void* out_key,
                           int cur_ld, int ref_ld, int out_ld, int frame_h,
                           int frame_w, int tile_h, int sad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sad)
    return launch_lab<2, true>(cur, ref, nullptr, nullptr, out_key, cur_ld,
                               ref_ld, out_ld, frame_h, frame_w, tile_h, s);
  return launch_lab<1, true>(cur, ref, nullptr, nullptr, out_key, cur_ld,
                             ref_ld, out_ld, frame_h, frame_w, tile_h, s);
}

// variant: 0 NOP, 1 L0, 2 "L1", 3 M1, 4 M2, 5 M3. out_cost float32 and
// out_idx int32, [frame_h / 8][out_ld].
extern "C" int me_lab_padded(const void* cur, const void* ref, void* out_cost,
                             void* out_idx, int cur_ld, int ref_ld, int out_ld,
                             int frame_h, int frame_w, int tile_h, int variant,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ME_PADDED(V)                                                        \
  case V:                                                                   \
    return launch_padded<V>(cur, ref, out_cost, out_idx, cur_ld, ref_ld,    \
                            out_ld, frame_h, frame_w, tile_h, s);
  switch (variant) {
    ME_PADDED(kNop)
    ME_PADDED(kL0)
    ME_PADDED(kRaw)
    ME_PADDED(kM1)
    ME_PADDED(kM2)
    ME_PADDED(kM3)
  }
#undef ME_PADDED
  return static_cast<int>(cudaErrorInvalidValue);
}

// The key-form launchers below write out_key int32 [frame_h / 8][out_ld].
#define ME_KEY(FORM, ABL, BF16)                                                \
  launch_lab<FORM, true, ABL, BF16>(cur, ref, nullptr, nullptr, out_key,       \
                                    cur_ld, ref_ld, out_ld, frame_h, frame_w,  \
                                    tile_h, static_cast<cudaStream_t>(stream))

// sad: 0 = SSD by the cross term (Qcur + Qref) - 2X, 1 = SAD; ablate: 0,
// 1 = nochain, 2 = nofold (SSD only).
extern "C" int me_lab_p3(const void* cur, const void* ref, void* out_key,
                         int cur_ld, int ref_ld, int out_ld, int frame_h,
                         int frame_w, int tile_h, int sad, int ablate,
                         void* stream) {
  if (sad) return ablate ? static_cast<int>(cudaErrorInvalidValue) : ME_KEY(2, 0, false);
  switch (ablate) {
    case 0: return ME_KEY(3, 0, false);
    case 1: return ME_KEY(3, 1, false);
    case 2: return ME_KEY(3, 2, false);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// sad: 0 = SSD by the diff form, 1 = SAD; bf16: bfloat16 planes.
extern "C" int me_lab_p5(const void* cur, const void* ref, void* out_key,
                         int cur_ld, int ref_ld, int out_ld, int frame_h,
                         int frame_w, int tile_h, int sad, int bf16,
                         void* stream) {
  if (bf16) return sad ? ME_KEY(2, 0, true) : ME_KEY(1, 0, true);
  return sad ? ME_KEY(2, 0, false) : ME_KEY(1, 0, false);
}

// SSD by the cross term (Qcur - X) + (Qref - X); bf16: bfloat16 planes.
extern "C" int me_lab_p6(const void* cur, const void* ref, void* out_key,
                         int cur_ld, int ref_ld, int out_ld, int frame_h,
                         int frame_w, int tile_h, int bf16, void* stream) {
  return bf16 ? ME_KEY(0, 0, true) : ME_KEY(0, 0, false);
}

// sad: 0 = SSD by the diff form, 1 = SAD, over bfloat16 planes.
extern "C" int me_lab_p7(const void* cur, const void* ref, void* out_key,
                         int cur_ld, int ref_ld, int out_ld, int frame_h,
                         int frame_w, int tile_h, int sad, void* stream) {
  return sad ? ME_KEY(2, 0, true) : ME_KEY(1, 0, true);
}
#undef ME_KEY
