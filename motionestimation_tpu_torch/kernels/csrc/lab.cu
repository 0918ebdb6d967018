// The speed-of-light tools for NVIDIA Hopper (sm_90a): the elementwise
// peak microbenchmarks and the two endpoint schemes of the full-search lab.
//
// Four kernels, each behind an extern "C" launcher loaded with ctypes:
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
//
// Lab contract (L2, L4): cur float32 [frame_h, frame_w] of integer pixels
// 0..255; ref float32 halo, at least [frame_h + 24, frame_w + 24], with
// reference pixel (y, x) at [y + 12, x + 12]. Blocks 8x8, span 12 (K = 25),
// flat = (dy + 12) * 25 + (dx + 12). A candidate is valid iff its window
// lies inside the frame (kern_lab.py:405-410). Every partial sum is an
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
// static min tree) is not carried over.
//
// What bounds it. P1 and P2 are FP32-lane issue: one FMA (or sub) per lane
// per clock, 128 lanes per SM. L2/L4: one shared-memory load and one FMA per
// pixel-candidate (2.62 G at 2048x2048); the load, 32 lanes per SM per
// clock, comes first.

#include <cuda_runtime.h>
#include <stdint.h>

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
// L2 / L4. FORM: 0 = SSD by the cross term, 1 = SSD by the diff form,
// 2 = SAD. KEY: false writes L2's (cost, idx), true L4's packed key.
// grid = (ceil(nbx / tbx), frame_h / tile_h).
struct LabLayout {
  int tile_h, tw, win_h, win_w, q_h, q_w, nblk;
  __host__ __device__ LabLayout(int tile_h_, int tbx)
      : tile_h(tile_h_), tw(tbx * kBlk), win_h(tile_h_ + 2 * kSpan),
        win_w(tbx * kBlk + 2 * kSpan), q_h(tile_h_ - kBlk + 2 * kSpan + 1),
        q_w(tbx * kBlk - kBlk + 2 * kSpan + 1),
        nblk((tile_h_ / kBlk) * tbx) {}
  // Bytes of shared memory: key slots, window, current tile, and for the
  // cross term the column-sum and Qref planes.
  __host__ __device__ size_t bytes(bool qref) const {
    size_t floats = static_cast<size_t>(win_h) * win_w +
                    static_cast<size_t>(tile_h) * tw;
    if (qref)
      floats += static_cast<size_t>(q_h) * win_w + static_cast<size_t>(q_h) * q_w;
    return sizeof(unsigned long long) * nblk * kWarps + sizeof(float) * floats;
  }
};

template <int FORM, bool KEY>
__global__ void __launch_bounds__(kThreads)
lab_search_kernel(const float* __restrict__ cur, int cur_ld,
                  const float* __restrict__ ref, int ref_ld,
                  float* __restrict__ out_cost, int32_t* __restrict__ out_idx,
                  int32_t* __restrict__ out_key, int out_ld, int frame_h,
                  int frame_w, int tile_h, int tbx) {
  constexpr bool kQref = FORM == 0;
  extern __shared__ unsigned long long smem[];
  const LabLayout L(tile_h, tbx);
  const int nbx = frame_w / kBlk;
  const int bx0 = blockIdx.x * tbx;
  const int ntile = min(tbx, nbx - bx0);
  const int y0 = blockIdx.y * tile_h, x0 = bx0 * kBlk;

  unsigned long long* red = smem;                                    // [nblk*kWarps]
  float* win = reinterpret_cast<float*>(red + L.nblk * kWarps);      // [win_h*win_w]
  float* cblk = win + L.win_h * L.win_w;                             // [tile_h*tw]
  float* colsq = cblk + L.tile_h * L.tw;                             // [q_h*win_w]
  float* qref = colsq + L.q_h * L.win_w;                             // [q_h*q_w]

  // Stage the window and the current tile; columns past the frame's last
  // macroblock of this CUDA block are zero and never read by a candidate.
  const int used_w = ntile * kBlk + 2 * kSpan;
  for (int i = threadIdx.x; i < L.win_h * L.win_w; i += kThreads) {
    const int r = i / L.win_w, c = i - r * L.win_w;
    win[i] = c < used_w ? ref[static_cast<size_t>(y0 + r) * ref_ld + x0 + c]
                        : 0.0f;
  }
  for (int i = threadIdx.x; i < L.tile_h * L.tw; i += kThreads) {
    const int r = i / L.tw, c = i - r * L.tw;
    cblk[i] = c < ntile * kBlk
                  ? cur[static_cast<size_t>(y0 + r) * cur_ld + x0 + c]
                  : 0.0f;
  }
  __syncthreads();
  if constexpr (kQref) {
    // Qref[y][x] = sum over the 8x8 box at window (y, x) of ref^2.
    for (int i = threadIdx.x; i < L.q_h * L.win_w; i += kThreads) {
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
      const float* cb = cblk + R * kBlk * L.tw + bm * kBlk;
      float creg[kBlk * kBlk];
      float qcur = 0.0f;
#pragma unroll
      for (int r = 0; r < kBlk; ++r) {
#pragma unroll
        for (int k = 0; k < kBlk; ++k) {
          const float v = cb[r * L.tw + k];
          creg[r * kBlk + k] = v;
          if constexpr (kQref) qcur = fmaf(v, v, qcur);
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
        if (oy < oy_lo || oy > oy_hi || ox < ox_lo || ox > ox_hi) {
          key = KEY ? 0xffffffffull
                    : (static_cast<unsigned long long>(kBig) << 32) |
                          static_cast<unsigned>(cand);
        } else {
          const float* wp = win + (R * kBlk + oy) * L.win_w + bm * kBlk + ox;
          float acc = 0.0f;
#pragma unroll
          for (int r = 0; r < kBlk; ++r) {
#pragma unroll
            for (int k = 0; k < kBlk; ++k) {
              const float c = creg[r * kBlk + k];
              const float e = wp[r * L.win_w + k];
              if constexpr (FORM == 0) {
                acc = fmaf(c, e, acc);
              } else if constexpr (FORM == 1) {
                const float d = c - e;
                acc = fmaf(d, d, acc);
              } else {
                acc += fabsf(c - e);
              }
            }
          }
          float cost = acc;
          if constexpr (kQref)
            cost = (qcur - acc) +
                   (qref[(R * kBlk + oy) * L.q_w + bm * kBlk + ox] - acc);
          const uint32_t ic = static_cast<uint32_t>(cost);  // exact, >= 0
          key = KEY ? static_cast<unsigned long long>(
                          ic * static_cast<uint32_t>(kK * kK) +
                          static_cast<uint32_t>(cand))
                    : (static_cast<unsigned long long>(ic) << 32) |
                          static_cast<unsigned>(cand);
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

template <int FORM, bool KEY>
int launch_lab(const void* cur, const void* ref, void* out_cost,
               void* out_idx, void* out_key, int cur_ld, int ref_ld,
               int out_ld, int frame_h, int frame_w, int tile_h,
               cudaStream_t stream) {
  if (tile_h <= 0 || tile_h % kBlk || frame_h % tile_h || frame_w % kBlk ||
      frame_w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lab_search_kernel<FORM, KEY>;
  const int nbx = frame_w / kBlk;
  int tbx = nbx < 8 ? nbx : 8;  // 64 pixels of macroblocks per CUDA block
  while (!reserve_smem(kernel, LabLayout(tile_h, tbx).bytes(FORM == 0)) &&
         tbx > 1)
    tbx /= 2;
  const size_t smem = LabLayout(tile_h, tbx).bytes(FORM == 0);
  if (!reserve_smem(kernel, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nbx + tbx - 1) / tbx, frame_h / tile_h);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(cur), cur_ld, static_cast<const float*>(ref),
      ref_ld, static_cast<float*>(out_cost), static_cast<int32_t*>(out_idx),
      static_cast<int32_t*>(out_key), out_ld, frame_h, frame_w, tile_h, tbx);
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
