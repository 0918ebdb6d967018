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
//   INT32_MAX where the candidate is invalid; the minimum key per block
//   (lab_key_kernel).
// me_lab_padded (L1) — replaces `make_kernel` of tools/kern_lab.py (:74,
//   `pallas_call` :241): no candidate masked, all 625 read the zero-padded
//   reference; the first minimum of (cost, flat) from the start pair (3e8,
//   312). NOP: the start pair; L0: SSD (Qcur - X) + (Qref - X); M1: L0
//   with each product a bfloat16 hi + lo pair on the TPU (exact: L0's
//   function, and here L0's instance); M2: SAD over bfloat16 |c - e|
//   (exact); M3: L0 with each product rounded to bfloat16
//   (round to nearest even; the TPU's DEFAULT-precision matmul, as the port
//   defines it); "L1": X the raw product cur[y0 + R][c] * ref[y0 + R + oy]
//   [c + ox] at the stripe's row R (no block sum, no slide: an ablation).
// me_lab_p3 (L3) — replaces `make_p3_kernel` (:504, `pallas_call` :613):
//   L4's key by the cross term (Qcur + Qref) - 2X, or SAD; nochain ("P3A":
//   X the r = 0 term at offset row 0, 0 elsewhere, the rows the TPU kernel
//   leaves unwritten taken as 0) and nofold ("P3B": per block the least
//   over ox of int32 sum_r cur[8R + r][c] * ref[8R + r][c + ox]); what
//   each keeps and drops of "P3" is at lab_key_kernel (kNochain, kNofold).
// me_lab_p5 (L5, `make_p5_kernel` :773, `pallas_call` :854): L4's key by
//   the diff form or SAD, over float32 or bfloat16 planes (lab_key_kernel).
// me_lab_p6 (L6, `make_p6_kernel` :898, `pallas_call` :997): L4's key by
//   the cross term (Qcur - X) + (Qref - X), float32 or bfloat16 planes.
// me_lab_p7 (L7, `make_p7_kernel` :1044, `pallas_call` :1121): L4's key by
//   the diff form or SAD over bfloat16 planes (lab_key_kernel).
// L2-L7 run one kernel, lab_key_kernel, in seven instances (a cost form
// and an output form each; bfloat16 holds every pixel 0..255, so a
// bfloat16 variant computes its float32 variant's function): the diff
// form's key runs L4's "P4", "P5", "P5B", "P7"; SAD's key "P4S", "P5S",
// "P5SB", "P7S" and L3's "P3S"; the cross term's key L3's "P3" and L6's
// "P6", "P6B"; the cross term's and SAD's (cost, idx) L2's "P0" and "P1";
// and one instance each for L3's ablations "P3A" and "P3B".
//
// Lab contract (L1-L7): cur float32 [frame_h, frame_w] of integer pixels
// 0..255; ref float32 halo, at least [frame_h + 24, frame_w + 24], with
// reference pixel (y, x) at [y + 12, x + 12]. Blocks 8x8, span 12 (K = 25),
// flat = (dy + 12) * 25 + (dx + 12). A candidate is valid iff its window
// lies inside the frame (kern_lab.py:405-410; L1 and "P3B" mask nothing).
// Every partial sum is an integer below 2^24 (at most 64 * 255^2), so
// float32 is exact in any order (L1 sums L0's and M2's in 32-bit integers
// of bytes, exact too), and cost * 625 + flat < 2^32: the unsigned key
// orders as the TPU's wrapped int32 key does. Outputs are [frame_h / 8,
// frame_w / 8], block starts only (the TPU kernels write every lane and the
// tool reads [:, ::8]).
//
// Design. P1 fma and mix: one thread per element with the four streams in
// registers. Each iteration reads `a` through an XOR with (iteration & mask),
// where the launcher passes mask 0: the value is unchanged, but no compiler
// pass (ptxas optimises the PTX too, and sees through an empty asm statement)
// can prove the restarted streams loop-invariant and hoist their chains out
// of the loop; the TPU kernel recomputes them too. P1 roll: one CUDA block
// per row, a thread holding KC neighbouring columns of each stream and a halo
// of the next 8 (peak_roll_kernel below): a step updates them in ascending
// order, so each add reads its right neighbour's old value, and the halo,
// recomputed, stands in for the neighbours' columns: no shuffle and no
// barrier a step; the threads exchange x once per iteration, through shared
// memory, behind one barrier. P2: one thread per (g, x) holding its 8 C and
// 32 E values in registers; each repetition XORs the C values in place
// with (rep & mask) and feeds a minimum carried across repetitions, so the
// `reps` repetitions are neither folded into one nor dead. A team of warps
// sharing an element's repetitions (or its dy rows) was tried and ran no
// faster at the JAX tool's [8, 2048] and slower at [8, 65536]: at [8,
// 2048] 512 warps of 64 repetitions leave 256 warp-repetitions on the
// busiest of the 132 SMs, and a team of any size leaves that SM the same
// 256. L1-L7 share one layout: a CUDA block of 160 threads takes 4 x 8
// macroblocks (tile_h, the TPU stripe height, is checked and sets nothing
// but "L1"'s function), stages their window as bytes, four to a word, in
// shared memory (and, for the cross term, the Qref box-sum plane: row
// sums by __dp4a, then column sums
// sliding down, build_qref), and gives each macroblock five threads of 5
// offset columns each. A thread holds its macroblock's 64 pixels as 16
// words and keeps 8 offset rows x 5 offset columns of sums in registers,
// fed from each window row it loads once and shifts to the nine byte
// offsets its columns start at (pad_ring); no product scratch, no atomic,
// no shared load per pixel-candidate. The five threads of a macroblock meet
// once at the end, through shared memory. The TPU choreography (phase-plane
// permutation matmuls, lane rolls of E, the static min tree) is not carried
// over. L1 runs lab_padded_kernel (nothing masked); L2-L7 run
// lab_key_kernel, with each masked candidate's key all ones where an
// offset row's costs enter the key.
//
// What bounds it. P1 fma and mix and P2 are FP32-lane issue: one FMA (or sub)
// per lane per clock, 128 lanes per SM. P2's 16 FP32 instructions a dy
// row share the schedulers' issue with a minimum a dy row and the flip's 8
// XORs a repetition (433 issues a repetition against 400 on the FP32
// lanes: at best 92% of the floor). At the JAX tool's [8, 2048] one thread
// an element puts 4 warps on 128 of the 132 SMs; 25 independent dy chains
// a thread keep one warp a scheduler issuing, so the order ptxas gives the
// chain (the flip in place, one repetition a loop trip) sets P2's time,
// not its warps an SM. P1 roll:
// its adds (one a stream, column and step) at that rate, and the halo's,
// 28 a stream and iteration beside a thread's 8 * KC; a row is one CUDA
// block, so at 64 rows 64 SMs work, with 4 warps each. L1: its
// arithmetic, a __dp4a (L0, M1) or a vabsdiff4 (M2) a word of four
// pixel-candidates on the 64 int32 lanes of
// an SM, a bf16x2 FMA and an FADD a pixel-candidate (M3) on the 128 FP32
// lanes; four shared loads and nine funnel shifts a window row feed 320
// pixel-candidates. The key kernel likewise, over the valid candidates: a
// __dp4a a word (the cross term: "P0", "P3", "P6", "P6B"), a vabsdiff4 with
// accumulate (SAD: "P1" and the key's), or a vabsdiff4 and a __dp4a (the
// diff form; two instructions a word against the SM's issue, 128 lanes a
// clock); "P3B" its __dp4a over every candidate, which it keeps live; "P3A"
// no ring, a few integer instructions a candidate, so its bytes
// (bench/roofline.py LAB_OPS counts them all).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using me::kThreads;
using me::reserve_smem;

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

// P1, roll: s[c] += s[(c + 1) % cols] for steps = inner / 8 steps on each
// of the four streams; one CUDA block per row, cols / KC threads. Thread t
// owns the KC columns from c0 = t * KC and holds kRollHalo more, columns
// (c0 + j) mod cols for j < N = KC + kRollHalo, of every stream in
// registers. A step adds each held column's right neighbour in ascending
// order, so each add reads the old value; the last held column has no
// neighbour and drops out, so after h <= kRollHalo steps the first N - h
// columns, the owned ones among them, are exact: the halo is recomputed,
// the same adds in the same order as its owner's. No shuffle and no
// barrier a step. Streams 1-3 restart from a at every held column; stream
// 0's halo, the next thread's first kRollHalo columns (KC >= kRollHalo),
// comes from it once per iteration: at its end each thread writes those
// columns of x to xrow (two buffers, so one barrier an iteration suffices;
// laid out [column][thread], so a warp's stores and loads fall on 32
// banks) and the next iteration reads the halo after that barrier. Steps
// beyond kRollHalo (inner above 64; the MANY instances) exchange every
// stream's halo through `mid` between chunks of kRollHalo steps.
constexpr int kRollHalo = 8;

template <int N>
__device__ __forceinline__ void roll_chunk(float (&x)[N], float (&s1)[N],
                                           float (&s2)[N], float (&s3)[N],
                                           int n) {
#pragma unroll
  for (int k = 0; k < kRollHalo; ++k) {
    if (k < n) {
#pragma unroll
      for (int j = 0; j + 1 + k < N; ++j) {
        x[j] += x[j + 1];
        s1[j] += s1[j + 1];
        s2[j] += s2[j + 1];
        s3[j] += s3[j + 1];
      }
    }
  }
}

template <int KC, bool MANY>
__global__ void __launch_bounds__(1024 / KC)
peak_roll_kernel(const float* __restrict__ a_in, float* __restrict__ out,
                 int cols, int inner, int outer, int mask) {
  constexpr int N = KC + kRollHalo;
  static_assert(KC >= kRollHalo, "the halo is the next thread's columns");
  extern __shared__ float xrow[];  // [2][kRollHalo][nt], then mid [4][..]
  const int nt = blockDim.x, t = threadIdx.x, next = t + 1 < nt ? t + 1 : 0;
  float* mid = xrow + 2 * kRollHalo * nt;
  const int c0 = t * KC, steps = inner / 8;
  const size_t row = static_cast<size_t>(blockIdx.x) * cols;
  float av[N], x[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    av[j] = a_in[row + (c0 + j < cols ? c0 + j : c0 + j - cols)];
    x[j] = av[j];  // stream 0 starts from a
  }
  // The first kRollHalo columns of v to buffer b; the halo of v from it.
  auto put = [&](float* b, const float(&v)[N]) {
#pragma unroll
    for (int j = 0; j < kRollHalo; ++j) b[j * nt + t] = v[j];
  };
  auto get = [&](const float* b, float(&v)[N]) {
#pragma unroll
    for (int j = 0; j < kRollHalo; ++j) v[KC + j] = b[j * nt + next];
  };
  for (int it = 0; it < outer; ++it) {
    if (it > 0) {
      __syncthreads();  // every thread's x of the last iteration is in xrow
      get(xrow + ((it - 1) & 1) * kRollHalo * nt, x);
    }
    float s1[N], s2[N], s3[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float a = flipped(av[j], it & mask);
      s1[j] = a * 0.5f;
      s2[j] = a * 0.25f;
      s3[j] = a * 0.125f;
    }
    roll_chunk<N>(x, s1, s2, s3, min(steps, kRollHalo));
    for (int k0 = kRollHalo; MANY && k0 < steps; k0 += kRollHalo) {
      __syncthreads();  // mid is free
      const int q = kRollHalo * nt;  // floats a stream
      put(mid, x);
      put(mid + q, s1);
      put(mid + 2 * q, s2);
      put(mid + 3 * q, s3);
      __syncthreads();
      get(mid, x);
      get(mid + q, s1);
      get(mid + 2 * q, s2);
      get(mid + 3 * q, s3);
      roll_chunk<N>(x, s1, s2, s3, min(steps - k0, kRollHalo));
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) x[j] = (x[j] + s1[j]) + (s2[j] + s3[j]);
    put(xrow + (it & 1) * kRollHalo * nt, x);
  }
#pragma unroll
  for (int j = 0; j < KC; ++j) out[row + c0 + j] = x[j];
}

// The roll's columns a thread for a row of `cols` columns (0: no launch
// takes the shape): 8, or 16 from two rows an SM, where fewer halo adds
// outweigh fewer threads. Bytes of shared memory: xrow, and mid where
// inner / 8 exceeds the halo (kRollHalo floats a thread and buffer, at
// most cols / 8 threads).
bool roll_cols_ok(int cols) {
  return cols > 0 && cols % 32 == 0 && cols <= 1024;
}
int roll_columns(int rows, int cols) {
  if (!roll_cols_ok(cols)) return 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return rows >= 2 * sms ? 16 : 8;
}
size_t roll_smem(int cols, int inner) {
  return sizeof(float) * cols * (inner / 8 > kRollHalo ? 6 : 2);
}
// The instance for `kc` columns a thread at `inner`.
using RollKernel = void (*)(const float*, float*, int, int, int, int);
RollKernel roll_kernel(int kc, int inner) {
  const bool many = inner / 8 > kRollHalo;
  if (kc == 8)
    return many ? peak_roll_kernel<8, true> : peak_roll_kernel<8, false>;
  return many ? peak_roll_kernel<16, true> : peak_roll_kernel<16, false>;
}

// ---------------------------------------------------------------------------
// P2: one thread per (g, x) of the [g_rows, w] output, holding its 8 C and
// 32 E values in registers. Each repetition XORs the C values in place
// with (rep & mask) and feeds a minimum carried across repetitions, so no
// repetition is folded into another or dead. The launch bound asks for
// one CUDA block an SM at least, so ptxas is free to give the chain the
// registers its schedule wants (80 on sm_90a); forms of the chain that
// ptxas packed into 64 or fewer ran slower on the card.
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel(const float* __restrict__ c, const float* __restrict__ e,
             float* __restrict__ out, int g_rows, int w, int reps,
             int mask) {
  constexpr int kPhase = kChainBlk + kChainK - 1;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= g_rows * w) return;
  const int g = i / w, x = i - g * w;
  float cr[kChainBlk], er[kPhase];
#pragma unroll
  for (int r = 0; r < kChainBlk; ++r)
    cr[r] = c[static_cast<size_t>(r * g_rows + g) * w + x];
#pragma unroll
  for (int p = 0; p < kPhase; ++p)
    er[p] = e[static_cast<size_t>(p * g_rows + g) * w + x];
  float total = __int_as_float(0x7f800000);  // +inf
#pragma unroll 1
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int r = 0; r < kChainBlk; ++r) cr[r] = flipped(cr[r], rep & mask);
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

bool lab_shape_ok(int tile_h, int frame_h, int frame_w) {
  return tile_h > 0 && tile_h % kBlk == 0 && frame_h % tile_h == 0 &&
         frame_w % kBlk == 0 && frame_w > 0;
}

// ---------------------------------------------------------------------------
// L1: the unmasked search over the zero-padded reference. VAR (PadVariant)
// picks the variant: NOP the start pair after staging; L0 (and M1, its
// instance) X = sum c * e by one __dp4a a word of four pixel-candidates; M2
// the SAD by one vabsdiff4 with accumulate a word; M3 X as the sum of c * e
// each rounded to bfloat16 (bf16_term, on pixels back in float32); "L1" X one
// product a candidate, cur[py][gx] * ref_p[py + oy][gx + ox] at py the
// stripe's row R (tile_h / 8 block rows a stripe), read from global memory.
// Cost (Qcur - X) + (Qref - X), or the SAD; the first minimum of (cost, flat)
// from the start pair (3e8, 312).
//
// A CUDA block takes kPadBy x kPadBx macroblocks and kPadThreads threads, one
// per (macroblock, group of kPadG offset columns). It stages the window (its
// macroblocks plus the span on each side; zero where no valid macroblock
// reaches) as bytes, four to a word (the contract makes every pixel an
// integer 0..255), and for the cross term the Qref plane (row sums of ref^2
// by __dp4a, then column sums sliding down) in shared memory; each thread
// loads its macroblock's 64 pixels into registers as 16 words (M3: as
// float32) and sums Qcur from them. A thread then walks the 32 window rows
// its candidates reach (pad_ring): it loads the four words that hold a row's 12 columns
// once, shifts them in registers to the nine byte offsets its columns start
// at, and they feed its 5 offset columns at each of the 8 offset rows the row
// reaches (window row j adds cur row r = j - oy to offset row oy), kept as a
// ring of 8 x 5 sums in registers; which offset rows exist is known at
// compile time in each of the four 8-row chunks. Offset row oy is whole at r
// = 7 and its five costs go into the thread's best key: cost * 625 + flat in
// 32 bits for L0 and M2 (costs 0..64 * 255^2), pad_key for M3 and "L1", whose
// costs can be negative. The five threads of a macroblock meet once at the
// end, through shared memory. A __dp4a of bytes and a vabsdiff4 are exact in
// 32 bits, and every cost is an integer below 2^24 in magnitude, exact in
// float32 in any order. grid = (ceil(nbx / kPadBx), ceil(nby / kPadBy)).
// tile_h changes only "L1"'s function.
enum PadVariant { kNop = 0, kL0 = 1, kRaw = 2, kM1 = 3, kM2 = 4, kM3 = 5 };
constexpr int kPadBy = 4, kPadBx = 8;  // macroblocks a CUDA block
constexpr int kPadG = 5;               // offset columns a thread
constexpr int kPadThreads = kPadBy * kPadBx * (kK / kPadG);  // 160
constexpr int kPadRows = kBlk + 2 * kSpan;  // window rows a macroblock reaches
constexpr int kPadWinH = kPadBy * kBlk + 2 * kSpan;  // 56
constexpr int kPadWinW = kPadBx * kBlk + 2 * kSpan;  // 88 bytes
// Words a window row: 22, a zero word the last offset group's fourth load
// reads, odd so that block rows fall on other banks.
constexpr int kPadWs = kPadWinW / 4 + 1;
constexpr int kPadQh = kPadWinH - kBlk + 1, kPadQw = kPadWinW - kBlk + 1;
constexpr int kPadRq = 4 * ((kPadQw + 3) / 4);  // columns a row sum row holds
constexpr float kMagic = 8388608.0f;  // 2^23: v + 2^23 holds v in its low bits
static_assert(kK % kPadG == 0 && kPadWinW % 4 == 0, "the layout's shapes");

__host__ __device__ constexpr bool pad_qsums(int var) {
  return var == kL0 || var == kRaw || var == kM3;
}
// Bytes: a key slot per thread, the window, and for the cross term the
// Qref plane and the row sums it is built from.
__host__ __device__ constexpr size_t pad_smem_bytes(int var) {
  return sizeof(unsigned long long) * kPadThreads +
         sizeof(uint32_t) *
             (kPadWinH * kPadWs +
              (pad_qsums(var) ? kPadQh * kPadQw + kPadWinH * kPadRq : 0));
}

// A cost (an integer in float32, possibly negative for M3 and "L1") and a
// flat index as one key whose unsigned order is (cost, flat)'s.
__device__ __forceinline__ unsigned long long pad_key(float cost, int flat) {
  const uint32_t c = static_cast<uint32_t>(static_cast<int32_t>(cost)) ^
                     0x80000000u;
  return (static_cast<unsigned long long>(c) << 32) |
         static_cast<uint32_t>(flat);
}

// The byte of a pixel (an integer 0..255 in float32), and the float32 of
// byte k of w.
__device__ __forceinline__ uint32_t pixel_byte(float v) {
  return __float_as_uint(v + kMagic) & 0xffu;
}
__device__ __forceinline__ float byte_float(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7650u | k)) - kMagic;
}

// acc + the SAD of the four bytes: one VABSDIFF4.U8.ACC on sm_90a.
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(acc));
  return d;
}

// M3's term: acc plus c * e rounded to bfloat16. An integer pixel's
// float32 has its low 16 bits zero, so it is the bfloat16 pair (p, 0); the
// pair FMA with -0 gives c * e rounded to bfloat16 (to nearest even) in
// the high half and +0 in the low half, which as a float32 is that rounded
// product.
__device__ __forceinline__ float bf16_term(float c, float e, float acc) {
  uint32_t p;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(p)
      : "r"(__float_as_uint(c)), "r"(__float_as_uint(e)), "r"(0x80008000u));
  return acc + __uint_as_float(p);
}

// How a word of four pixel-candidates enters an offset row's sum in the
// ring (pad_ring): kDot X += c . e by one __dp4a (L0, M1); kAbs the SAD by
// one vabsdiff4 with accumulate (M2, the key's SAD); kSq the diff form,
// d = |c - e| by one vabsdiff4 and the sum of d^2 by one __dp4a (the key's
// SSD); kBf16 X += each c * e rounded to bfloat16 (M3, on float32 pixels).
enum RingTerm { kDot = 0, kAbs = 1, kSq = 2, kBf16 = 3 };

// The sums of an offset row: 32-bit integers of bytes, or float32 of
// rounded products (kBf16).
template <int TERM>
using RingSum = std::conditional_t<TERM == kBf16, float, uint32_t>;

// |a - b| of each byte: one VABSDIFF4.U8 on sm_90a.
__device__ __forceinline__ uint32_t absdiff4(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0u));
  return d;
}

// Stage the window of the CUDA block's macroblocks (from (by0, bx0), nvy x
// nvx of them in the frame) from ref_p as bytes, four to a word (the
// contract makes every frame pixel an integer 0..255; a halo value maps to
// some byte without trapping, and reaches only candidates the caller
// ignores); zero where no valid macroblock reaches. Returns the OR of the
// words this thread wrote.
__device__ __forceinline__ uint32_t stage_pad_window(
    const float* __restrict__ ref, int ref_ld, int by0, int bx0, int nvy,
    int nvx, uint32_t* win, int t) {
  const int used_h = nvy * kBlk + 2 * kSpan, used_w = nvx * kBlk + 2 * kSpan;
  const float* rp = ref + static_cast<size_t>(by0) * kBlk * ref_ld + bx0 * kBlk;
  uint32_t live = 0;
  for (int i = t; i < kPadWinH * kPadWs; i += kPadThreads) {
    const int r = i / kPadWs, c0 = 4 * (i - r * kPadWs);
    uint32_t word = 0;
    if (r < used_h) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + k < used_w)
          word |= pixel_byte(rp[static_cast<size_t>(r) * ref_ld + c0 + k])
                  << (8 * k);
    }
    win[i] = word;
    live |= word;
  }
  return live;
}

// The macroblock at (gy, gx): its 64 pixels four to a word (zero where
// !valid); each(i, v) also takes pixel i as float32.
template <typename Each>
__device__ __forceinline__ void load_block(const float* __restrict__ cur,
                                           int cur_ld, int gy, int gx,
                                           bool valid, uint32_t (&cw)[16],
                                           Each&& each) {
#pragma unroll
  for (int i = 0; i < kBlk * kBlk; ++i) {
    const float v =
        valid ? cur[static_cast<size_t>(gy + i / kBlk) * cur_ld + gx + i % kBlk]
              : 0.0f;
    each(i, v);
    cw[i / 4] = (i % 4 ? cw[i / 4] : 0u) | pixel_byte(v) << (8 * (i % 4));
  }
}

// A window row's 12 columns from byte shift / 8 of its first word (the
// row's four words loaded once): e[o] holds columns o..o+3, four to a word.
__device__ __forceinline__ void row_columns(const uint32_t* row, int shift,
                                            uint32_t (&e)[kPadG + 4]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = row[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) e[4 * i] = __funnelshift_r(w[i], w[i + 1], shift);
#pragma unroll
  for (int o = 1; o < kPadG + 4; ++o)
    if (o % 4) e[o] = __funnelshift_r(e[o & ~3], e[(o & ~3) + 4], 8 * (o % 4));
}

// The Qref plane of a staged window: qref[y][x] = sum over the 8x8 box at
// window (y, x) of ref^2, from row sums in rowsq (kPadWinH x kPadRq). Every
// thread of the CUDA block calls it after the window is staged; it ends
// behind a barrier.
__device__ __forceinline__ void build_qref(const uint32_t* win, uint32_t* qref,
                                           uint32_t* rowsq, int t) {
  // Row sums first, four columns an item: rowsq[y][x] = sum_{b<8}
  // ref(y, x + b)^2, a __dp4a of each byte word with itself.
  for (int i = t; i < kPadWinH * (kPadRq / 4); i += kPadThreads) {
    const int y = i / (kPadRq / 4), x4 = i - y * (kPadRq / 4);
    const uint32_t* wp = win + y * kPadWs + x4;
    const uint32_t w[3] = {wp[0], wp[1], wp[2]};
    uint32_t e[8];  // e[o]: bytes 4 * x4 + o .. + 3
#pragma unroll
    for (int o = 0; o < 8; ++o)
      e[o] = o % 4 ? __funnelshift_r(w[o / 4], w[o / 4 + 1], 8 * (o % 4))
                   : w[o / 4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      rowsq[y * kPadRq + 4 * x4 + q] =
          __dp4a(e[q], e[q], __dp4a(e[q + 4], e[q + 4], 0u));
  }
  __syncthreads();
  // Then the sums of 8 rows, sliding down half a column an item.
  constexpr int kHalf = (kPadQh + 1) / 2;
  for (int i = t; i < 2 * kPadQw; i += kPadThreads) {
    const int x = i % kPadQw, y0 = i / kPadQw * kHalf;
    const int y1 = min(kPadQh, y0 + kHalf);
    uint32_t s = 0;
#pragma unroll
    for (int a = 0; a < kBlk; ++a) s += rowsq[(y0 + a) * kPadRq + x];
    qref[y0 * kPadQw + x] = s;
    for (int y = y0 + 1; y < y1; ++y) {
      s += rowsq[(y + kBlk - 1) * kPadRq + x] - rowsq[(y - 1) * kPadRq + x];
      qref[y * kPadQw + x] = s;
    }
  }
  __syncthreads();
}

// One thread's ring: the sums of its kPadG offset columns (from ox0, the
// 12 columns that start at byte `shift` / 8 of wrow's first word) at all 25
// offset rows, over the 32 window rows from wrow (kPadWs words a row). Each
// window row's four words are loaded once and shifted to the nine byte
// offsets its columns start at; window row j adds cur row r = j - oy to
// offset row oy, slot oy % 8 of 8 x kPadG sums in registers. finish(oy, x)
// takes offset row oy's kPadG sums when it is whole (at r = 7). cf, the
// macroblock's 64 pixels as float32, is read by kBf16 only (else nullptr).
template <int TERM, typename Finish>
__device__ __forceinline__ void pad_ring(const uint32_t* wrow, int shift,
                                         const uint32_t (&cw)[16],
                                         const float* cf, Finish&& finish) {
  RingSum<TERM> acc[kBlk][kPadG] = {};  // offset row oy's in slot oy % 8
  // Window rows j0..j0 + 7: cur row r adds to offset row j - r, which
  // exists for r <= j in the first eight rows (phase 0) and for j - r <= 24
  // in the last eight (phase 2), so the tests fold away.
  auto rows8 = [&](auto phase, int j0) {
    constexpr int kPhase = decltype(phase)::value;
#pragma unroll
    for (int jj = 0; jj < kBlk; ++jj) {
      const int j = j0 + jj;  // window row, relative to the macroblock
      uint32_t e[kPadG + 4];
      row_columns(wrow + j * kPadWs, shift, e);
      float ef[kPadG + kBlk - 1];  // kBf16: the 12 columns as float32
      if constexpr (TERM == kBf16) {
#pragma unroll
        for (int i = 0; i < kPadG + kBlk - 1; ++i)
          ef[i] = byte_float(e[i & ~3], i % 4);
      }
#pragma unroll
      for (int r = 0; r < kBlk; ++r) {
        if ((kPhase == 0 && r > jj) || (kPhase == 2 && r < jj)) continue;
        RingSum<TERM>(&a)[kPadG] = acc[(jj - r) & (kBlk - 1)];
#pragma unroll
        for (int q = 0; q < kPadG; ++q) {
          RingSum<TERM> v = r == 0 ? RingSum<TERM>(0) : a[q];
          if constexpr (TERM == kBf16) {
#pragma unroll
            for (int k = 0; k < kBlk; ++k)
              v = bf16_term(cf[r * kBlk + k], ef[q + k], v);
          } else if constexpr (TERM == kAbs) {
            v = sad4(cw[2 * r], e[q], v);
            v = sad4(cw[2 * r + 1], e[q + 4], v);
          } else if constexpr (TERM == kSq) {
            const uint32_t d0 = absdiff4(cw[2 * r], e[q]);
            v = __dp4a(d0, d0, v);
            const uint32_t d1 = absdiff4(cw[2 * r + 1], e[q + 4]);
            v = __dp4a(d1, d1, v);
          } else {
            v = __dp4a(cw[2 * r], e[q], v);
            v = __dp4a(cw[2 * r + 1], e[q + 4], v);
          }
          a[q] = v;
        }
        if (r == kBlk - 1) finish(j - r, a);
      }
    }
  };
  static_assert(kPadRows == 4 * kBlk, "phases 0, 1, 1, 2");
  rows8(std::integral_constant<int, 0>(), 0);
#pragma unroll 1
  for (int j0 = kBlk; j0 < kPadRows - kBlk; j0 += kBlk)
    rows8(std::integral_constant<int, 1>(), j0);
  rows8(std::integral_constant<int, 2>(), kPadRows - kBlk);
}

template <int VAR>
__global__ void __launch_bounds__(kPadThreads, VAR == kM3 ? 3 : 4)
lab_padded_kernel(const float* __restrict__ cur, int cur_ld,
                  const float* __restrict__ ref, int ref_ld,
                  float* __restrict__ out_cost, int32_t* __restrict__ out_idx,
                  int out_ld, int frame_h, int frame_w, int tile_h, int flip) {
  constexpr bool kQ = pad_qsums(VAR);
  constexpr int kTerm = VAR == kM3 ? kBf16 : VAR == kM2 ? kAbs : kDot;
  extern __shared__ unsigned long long smem[];
  unsigned long long* red = smem;                              // [kPadThreads]
  uint32_t* win = reinterpret_cast<uint32_t*>(red + kPadThreads);  // [WinH][Ws]
  uint32_t* qref = win + kPadWinH * kPadWs;  // [Qh][Qw]
  uint32_t* rowsq = qref + kPadQh * kPadQw;  // [WinH][Rq]
  const int by0 = blockIdx.y * kPadBy, bx0 = blockIdx.x * kPadBx;
  const int nvy = min(kPadBy, frame_h / kBlk - by0);
  const int nvx = min(kPadBx, frame_w / kBlk - bx0);
  const int t = threadIdx.x, m = t / kPadG, g = t - m * kPadG;
  const int R = m / kPadBx, bm = m - R * kPadBx;
  const bool valid = R < nvy && bm < nvx;
  const int ox0 = g * kPadG;
  const int gy = (by0 + R) * kBlk, gx = (bx0 + bm) * kBlk;

  // Stage the window as bytes. Nothing is masked: the reference is
  // zero-padded, and what no valid macroblock reaches is zero and reaches
  // no output.
  if (VAR == kNop && t == 0) *reinterpret_cast<uint32_t*>(red) = 0;
  uint32_t live = stage_pad_window(ref, ref_ld, by0, bx0, nvy, nvx, win, t);
  // The macroblock's pixels, four to a word, and (M3) as float32; Qcur,
  // their sum of squares.
  uint32_t cw[kBlk * kBlk / 4];
  float cf[kBlk * kBlk];
  float qcur = 0.0f;
  load_block(cur, cur_ld, gy, gx, valid, cw, [&](int i, float v) {
    cf[i] = v;
    qcur = fmaf(v, v, qcur);
  });
  __syncthreads();

  if constexpr (VAR == kNop) {
    // The start pair only. Every staged value reaches the cost through
    // (live & flip), flip being 0, so the staging is not dead code.
#pragma unroll
    for (int i = 0; i < kBlk * kBlk / 4; ++i) live |= cw[i];
    live = __reduce_or_sync(0xffffffffu, live);
    if ((t & 31) == 0) atomicOr(reinterpret_cast<uint32_t*>(red), live);
    __syncthreads();
    const uint32_t all =
        *reinterpret_cast<uint32_t*>(red) & static_cast<uint32_t>(flip);
    if (valid && g == 0) {
      const size_t o = static_cast<size_t>(by0 + R) * out_ld + bx0 + bm;
      out_cost[o] =
          __uint_as_float(__float_as_uint(static_cast<float>(kBig)) ^ all);
      out_idx[o] = kSpan * kK + kSpan;
    }
  } else {
    if constexpr (kQ) build_qref(win, qref, rowsq, t);
    // The tool's start pair (3e8, centre): no cost reaches 3e8.
    unsigned long long best =
        pad_key(static_cast<float>(kBig), kSpan * kK + kSpan);
    if (valid) {
      const uint32_t* qrow = qref + R * kBlk * kPadQw + bm * kBlk + ox0;
      if constexpr (VAR == kRaw) {
        // X one product, costs possibly negative: keys as pad_key.
        const int rg = by0 + R, nbr = tile_h / kBlk;
        const int py = rg / nbr * tile_h + rg % nbr;
        const float c0 = cur[static_cast<size_t>(py) * cur_ld + gx];
        const float* e = ref + static_cast<size_t>(py) * ref_ld + gx + ox0;
        for (int oy = 0; oy < kK; ++oy) {
#pragma unroll
          for (int q = 0; q < kPadG; ++q) {
            const float x = c0 * e[static_cast<size_t>(oy) * ref_ld + q];
            const float cost =
                (qcur - x) + (static_cast<float>(qrow[oy * kPadQw + q]) - x);
            const unsigned long long key = pad_key(cost, oy * kK + ox0 + q);
            best = key < best ? key : best;
          }
        }
      } else {
        // L0 and M2 keep the least cost * 625 + flat in 32 bits (their
        // costs are integers 0 <= cost <= 64 * 255^2, the key below 2^32);
        // M3, whose costs can be negative, keeps pad_key's.
        uint32_t best32 = 0xffffffffu;
        const uint32_t qc = static_cast<uint32_t>(qcur);  // exact
        // The five costs of offset row oy from their sums into the key.
        auto finish = [&](int oy, const RingSum<kTerm>(&x)[kPadG]) {
#pragma unroll
          for (int q = 0; q < kPadG; ++q) {
            const int flat = oy * kK + ox0 + q;
            if constexpr (VAR == kM3) {
              const float cost =
                  (qcur - x[q]) +
                  (static_cast<float>(qrow[oy * kPadQw + q]) - x[q]);
              const unsigned long long key = pad_key(cost, flat);
              best = key < best ? key : best;
            } else {
              const uint32_t cost =
                  VAR == kM2 ? x[q] : qc + qrow[oy * kPadQw + q] - 2 * x[q];
              best32 = min(best32, cost * (kK * kK) + flat);
            }
          }
        };
        // The thread's 12 columns start at byte 8 * bm + ox0 of a window
        // row: word 2 * bm + ox0 / 4, byte ox0 % 4 of it.
        pad_ring<kTerm>(win + R * kBlk * kPadWs + 2 * bm + ox0 / 4,
                        8 * (ox0 & 3), cw, cf, finish);
        if constexpr (VAR != kM3) {
          const unsigned long long key = pad_key(
              static_cast<float>(best32 / (kK * kK)), best32 % (kK * kK));
          best = key < best ? key : best;
        }
      }
    }
    red[t] = best;
    __syncthreads();
    if (t < kPadBy * kPadBx) {
      const int R2 = t / kPadBx, b2 = t - R2 * kPadBx;
      if (R2 < nvy && b2 < nvx) {
        unsigned long long k = red[t * kPadG];
#pragma unroll
        for (int i = 1; i < kPadG; ++i) {
          const unsigned long long v = red[t * kPadG + i];
          k = v < k ? v : k;
        }
        const size_t o = static_cast<size_t>(by0 + R2) * out_ld + bx0 + b2;
        out_cost[o] = static_cast<float>(
            static_cast<int32_t>(static_cast<uint32_t>(k >> 32) ^ 0x80000000u));
        out_idx[o] = static_cast<int32_t>(k & 0xffffffffu);
      }
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
  const size_t smem = pad_smem_bytes(VAR);
  if (!reserve_smem(kernel, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((frame_w / kBlk + kPadBx - 1) / kPadBx,
                  (frame_h / kBlk + kPadBy - 1) / kPadBy);
  kernel<<<grid, kPadThreads, smem, stream>>>(
      static_cast<const float*>(cur), cur_ld, static_cast<const float*>(ref),
      ref_ld, static_cast<float*>(out_cost), static_cast<int32_t*>(out_idx),
      out_ld, frame_h, frame_w, tile_h, 0);
  return static_cast<int>(cudaGetLastError());
}

// The lab's masked searches, L2-L7: L1's layout and ring on the frame's
// reference, each candidate whose window leaves the frame masked. TERM:
// kSq (SSD by the diff form, sum |c - e|^2: one vabsdiff4 and one __dp4a
// a word; L4, L5, L7), kAbs (SAD, one vabsdiff4 with accumulate a word;
// their SAD, L3's "P3S", L2's "P1") or kDot (the cross term: X = sum c * e
// by one __dp4a a word, as L0, and the cost Qcur + Qref - 2X in 32 bits,
// which is sum (c - e)^2 >= 0, exact; Qcur from the macroblock's words,
// Qref from the plane build_qref stages; L3's "P3", L6, L2's "P0"). Every
// cost is at most 64 * 255^2. The ring runs every candidate with no branch
// a pixel: the valid offsets, kern_lab.py:405-410's ranges, apply only
// where an offset row's kPadG costs enter the thread's best key, cost *
// 625 + flat in 32 bits, which an invalid candidate enters as 0xffffffff,
// so halo bytes reach no result. The least key is the first minimum in
// raster order; the five threads of a macroblock meet once, through shared
// memory, and OUT says what they write there:
//   kKey: the key with its top bit flipped, L4's key - 2^31 in wrapping
//     int32 (INT32_MAX where no candidate is valid);
//   kPair: L2's float32 cost = key / 625 and int32 index key % 625 (the
//     centre candidate of a block inside the frame is always valid, and the
//     lexicographic (cost, flat) order is the key's unsigned order);
//   kNochain ("P3A", kDot): "P3" with the chain taken out, as the TPU
//     kernel takes it out (kern_lab.py:561-562). It keeps Qcur, the Qref
//     plane, the mask and the key; it drops the ring: X is the block's
//     first row against window row 0 at offset row 0 (one row's two __dp4a
//     a column) and 0 at every other offset row, where the cost is Qcur +
//     Qref. That reaches 8,323,200, so cost * 625 + flat is taken mod 2^32,
//     as the TPU's int32 key wraps;
//   kNofold ("P3B", kDot): "P3" with the fold taken out (kern_lab.py:
//     573-580). It keeps the ring, Qcur, the Qref plane and every cost,
//     which reach the output only through (bits & flip), flip being 0, so
//     they are computed and never win; it drops the mask and the key. Its
//     output, unmasked, is per block the least over the offset columns of
//     the first column's chain at offset row 0, sum_r cur[r][0] *
//     window[r][ox] (at most 8 * 255^2).
// The layout does not depend on tile_h. grid = (ceil(nbx / kPadBx),
// ceil(nby / kPadBy)).
enum KeyOut { kKey = 0, kPair = 1, kNochain = 2, kNofold = 3 };

// Bytes: a key slot per thread and the window, and for the cross term the
// Qref plane and the row sums it is built from.
__host__ __device__ constexpr size_t key_smem_bytes(int term) {
  return sizeof(uint32_t) *
         (kPadThreads + kPadWinH * kPadWs +
          (term == kDot ? kPadQh * kPadQw + kPadWinH * kPadRq : 0));
}

// out: the int32 key (kKey, kNochain), the float32 cost (kPair) or the
// int32 chain minimum (kNofold), [frame_h / 8][out_ld]; out_idx: kPair's
// int32 index, else unused. flip is 0 (kNofold reads it).
template <int TERM, int OUT>
__global__ void __launch_bounds__(kPadThreads, 4)
lab_key_kernel(const float* __restrict__ cur, int cur_ld,
               const float* __restrict__ ref, int ref_ld,
               void* __restrict__ out, int out_ld, int frame_h, int frame_w,
               int32_t* __restrict__ out_idx, int flip) {
  static_assert(TERM == kSq || TERM == kAbs || TERM == kDot,
                "the key's cost forms");
  static_assert(OUT == kKey || OUT == kPair || TERM == kDot,
                "the ablations are the cross term's");
  constexpr bool kCross = TERM == kDot;
  extern __shared__ unsigned long long smem[];
  uint32_t* red = reinterpret_cast<uint32_t*>(smem);  // [kPadThreads]
  uint32_t* win = red + kPadThreads;                  // [WinH][Ws]
  uint32_t* qref = win + kPadWinH * kPadWs;           // [Qh][Qw] (kDot)
  uint32_t* rowsq = qref + kPadQh * kPadQw;           // [WinH][Rq] (kDot)
  const int by0 = blockIdx.y * kPadBy, bx0 = blockIdx.x * kPadBx;
  const int nvy = min(kPadBy, frame_h / kBlk - by0);
  const int nvx = min(kPadBx, frame_w / kBlk - bx0);
  const int t = threadIdx.x, m = t / kPadG, g = t - m * kPadG;
  const int R = m / kPadBx, bm = m - R * kPadBx;
  const bool valid = R < nvy && bm < nvx;
  const int ox0 = g * kPadG;
  const int gy = (by0 + R) * kBlk, gx = (bx0 + bm) * kBlk;

  stage_pad_window(ref, ref_ld, by0, bx0, nvy, nvx, win, t);
  uint32_t cw[kBlk * kBlk / 4];
  load_block(cur, cur_ld, gy, gx, valid, cw, [](int, float) {});
  __syncthreads();
  if constexpr (kCross) build_qref(win, qref, rowsq, t);

  uint32_t best = 0xffffffffu;
  if (valid) {
    // Valid offsets o = d + span: 0 <= g + o - span <= frame - 8. A
    // candidate outside them gets all ones OR-ed into its key.
    const int oy_lo = max(0, kSpan - gy);
    const int oy_hi = min(2 * kSpan, frame_h - kBlk - gy + kSpan);
    const int ox_lo = max(0, kSpan - gx);
    const int ox_hi = min(2 * kSpan, frame_w - kBlk - gx + kSpan);
    uint32_t col_out[kPadG];
#pragma unroll
    for (int q = 0; q < kPadG; ++q)
      col_out[q] = ox0 + q < ox_lo || ox0 + q > ox_hi ? 0xffffffffu : 0u;
    // The thread's 12 columns start at byte 8 * bm + ox0 of a window row:
    // word 2 * bm + ox0 / 4, byte ox0 % 4 of it.
    const uint32_t* wrow = win + R * kBlk * kPadWs + 2 * bm + ox0 / 4;
    const int shift = 8 * (ox0 & 3);
    uint32_t qc = 0;  // Qcur, exact in 32 bits
    if constexpr (kCross) {
#pragma unroll
      for (int i = 0; i < kBlk * kBlk / 4; ++i) qc = __dp4a(cw[i], cw[i], qc);
    }
    const uint32_t* qrow = qref + R * kBlk * kPadQw + bm * kBlk + ox0;
    // The cost of candidate (oy, ox0 + q) from its sum x.
    auto cost = [&](int oy, int q, uint32_t x) -> uint32_t {
      if constexpr (kCross) return qc + qrow[oy * kPadQw + q] - 2 * x;
      return x;
    };
    // Offset row oy's kPadG costs into the thread's best key.
    auto enter = [&](int oy, const uint32_t(&x)[kPadG]) {
      const uint32_t row_out = oy < oy_lo || oy > oy_hi ? 0xffffffffu : 0u;
#pragma unroll
      for (int q = 0; q < kPadG; ++q)
        best = min(best, (cost(oy, q, x[q]) * (kK * kK) + oy * kK + ox0 + q) |
                             row_out | col_out[q]);
    };
    if constexpr (OUT == kNochain) {
      uint32_t e[kPadG + 4], x[kPadG];
      row_columns(wrow, shift, e);
#pragma unroll
      for (int q = 0; q < kPadG; ++q)
        x[q] = __dp4a(cw[0], e[q], __dp4a(cw[1], e[q + 4], 0u));
      enter(0, x);
#pragma unroll
      for (int q = 0; q < kPadG; ++q) x[q] = 0;
#pragma unroll 4
      for (int oy = 1; oy < kK; ++oy) enter(oy, x);
    } else if constexpr (OUT == kNofold) {
      uint32_t live = 0;  // every cost, XORed; reaches the output as 0
      pad_ring<kDot>(wrow, shift, cw, nullptr,
                     [&](int oy, const uint32_t(&x)[kPadG]) {
#pragma unroll
                       for (int q = 0; q < kPadG; ++q)
                         live ^= cost(oy, q, x[q]);
                     });
      // The first column's chain at offset row 0: pixel (r, 0), byte 0 of
      // cw[2r], against byte 0 of each column word of window row r.
      uint32_t chain[kPadG] = {};
#pragma unroll
      for (int r = 0; r < kBlk; ++r) {
        uint32_t e[kPadG + 4];
        row_columns(wrow + r * kPadWs, shift, e);
#pragma unroll
        for (int q = 0; q < kPadG; ++q)
          chain[q] = __dp4a(cw[2 * r] & 0xffu, e[q], chain[q]);
      }
#pragma unroll
      for (int q = 0; q < kPadG; ++q) best = min(best, chain[q]);
      best ^= live & static_cast<uint32_t>(flip);
    } else {
      pad_ring<TERM>(wrow, shift, cw, nullptr, enter);
    }
  }
  red[t] = best;
  __syncthreads();
  if (t < kPadBy * kPadBx) {
    const int R2 = t / kPadBx, b2 = t - R2 * kPadBx;
    if (R2 < nvy && b2 < nvx) {
      uint32_t k = red[t * kPadG];
#pragma unroll
      for (int i = 1; i < kPadG; ++i) k = min(k, red[t * kPadG + i]);
      const size_t o = static_cast<size_t>(by0 + R2) * out_ld + bx0 + b2;
      if constexpr (OUT == kPair) {
        static_cast<float*>(out)[o] = static_cast<float>(k / (kK * kK));
        out_idx[o] = static_cast<int32_t>(k % (kK * kK));
      } else {
        static_cast<int32_t*>(out)[o] =
            static_cast<int32_t>(OUT == kNofold ? k : k ^ 0x80000000u);
      }
    }
  }
}

// One launch of lab_key_kernel<TERM, OUT>, out and out_idx as it takes
// them.
template <int TERM, int OUT>
int launch_key(const void* cur, const void* ref, void* out, void* out_idx,
               int cur_ld, int ref_ld, int out_ld, int frame_h, int frame_w,
               int tile_h, void* stream) {
  if (!lab_shape_ok(tile_h, frame_h, frame_w))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lab_key_kernel<TERM, OUT>;
  constexpr size_t smem = key_smem_bytes(TERM);
  if (!reserve_smem(kernel, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((frame_w / kBlk + kPadBx - 1) / kPadBx,
                  (frame_h / kBlk + kPadBy - 1) / kPadBy);
  kernel<<<grid, kPadThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cur), cur_ld, static_cast<const float*>(ref),
      ref_ld, out, out_ld, frame_h, frame_w, static_cast<int32_t*>(out_idx),
      0);
  return static_cast<int>(cudaGetLastError());
}

// L4's key by the diff form (sad 0) or SAD (sad 1).
int launch_diff(const void* cur, const void* ref, void* out_key, int cur_ld,
                int ref_ld, int out_ld, int frame_h, int frame_w, int tile_h,
                int sad, void* stream) {
  return (sad ? launch_key<kAbs, kKey> : launch_key<kSq, kKey>)(
      cur, ref, out_key, nullptr, cur_ld, ref_ld, out_ld, frame_h, frame_w,
      tile_h, stream);
}

// A kernel's resources on the current card into out[0..4]: registers and
// local (spill) bytes per thread, threads a CUDA block, dynamic shared
// bytes, CUDA blocks resident per SM.
template <typename Kernel>
int occupancy(Kernel kernel, int threads, size_t smem, int* out) {
  if (!reserve_smem(kernel, smem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = threads;
  out[3] = static_cast<int>(smem);
  out[4] = blocks;
  return 0;
}

template <int TERM, int OUT>
int key_occupancy(int* out) {
  return occupancy(lab_key_kernel<TERM, OUT>, kPadThreads, key_smem_bytes(TERM),
                   out);
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
    const size_t smem = roll_smem(cols, inner);
    const int kc = roll_columns(rows, cols);
    if (kc == 0) return static_cast<int>(cudaErrorInvalidValue);
    roll_kernel(kc, inner)<<<rows, cols / kc, smem, s>>>(ap, op, cols, inner,
                                                         outer, 0);
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
  return (sad ? launch_key<kAbs, kPair> : launch_key<kDot, kPair>)(
      cur, ref, out_cost, out_idx, cur_ld, ref_ld, out_ld, frame_h, frame_w,
      tile_h, stream);
}

// sad: 0 = SSD (the diff form), 1 = SAD. out_key int32 [frame_h / 8][out_ld].
extern "C" int me_lab_diff(const void* cur, const void* ref, void* out_key,
                           int cur_ld, int ref_ld, int out_ld, int frame_h,
                           int frame_w, int tile_h, int sad, void* stream) {
  return launch_diff(cur, ref, out_key, cur_ld, ref_ld, out_ld, frame_h,
                     frame_w, tile_h, sad, stream);
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
    case kM1:  // the same function as L0: L0's instance
      return launch_padded<kL0>(cur, ref, out_cost, out_idx, cur_ld, ref_ld,
                                out_ld, frame_h, frame_w, tile_h, s);
    ME_PADDED(kM2)
    ME_PADDED(kM3)
  }
#undef ME_PADDED
  return static_cast<int>(cudaErrorInvalidValue);
}

// The key-form launchers below write out_key int32 [frame_h / 8][out_ld].

// sad: 0 = SSD by the cross term (Qcur + Qref) - 2X, 1 = SAD; ablate: 0,
// 1 = nochain, 2 = nofold (SSD only).
extern "C" int me_lab_p3(const void* cur, const void* ref, void* out_key,
                         int cur_ld, int ref_ld, int out_ld, int frame_h,
                         int frame_w, int tile_h, int sad, int ablate,
                         void* stream) {
  int (*launch)(const void*, const void*, void*, void*, int, int, int, int,
                int, int, void*) = nullptr;
  if (sad) {
    if (ablate == 0) launch = launch_key<kAbs, kKey>;
  } else if (ablate == 0)
    launch = launch_key<kDot, kKey>;
  else if (ablate == 1)
    launch = launch_key<kDot, kNochain>;
  else if (ablate == 2)
    launch = launch_key<kDot, kNofold>;
  if (!launch) return static_cast<int>(cudaErrorInvalidValue);
  return launch(cur, ref, out_key, nullptr, cur_ld, ref_ld, out_ld, frame_h,
                frame_w, tile_h, stream);
}

// sad: 0 = SSD by the diff form, 1 = SAD; bf16: bfloat16 planes. bfloat16
// holds every pixel 0..255 exactly, so "P5B" and "P5SB" compute the
// function of "P5" and "P5S" and run their byte instances (as M1 runs L0's).
extern "C" int me_lab_p5(const void* cur, const void* ref, void* out_key,
                         int cur_ld, int ref_ld, int out_ld, int frame_h,
                         int frame_w, int tile_h, int sad, int bf16,
                         void* stream) {
  return launch_diff(cur, ref, out_key, cur_ld, ref_ld, out_ld, frame_h,
                     frame_w, tile_h, sad, stream);
}

// SSD by the cross term (Qcur - X) + (Qref - X); bf16: bfloat16 planes. In
// 32-bit unsigned arithmetic (Qcur - X) + (Qref - X) and (Qcur + Qref) - 2X
// are the same bits, and bfloat16 holds every pixel 0..255, so "P6" and
// "P6B" compute "P3"'s function and run its instance.
extern "C" int me_lab_p6(const void* cur, const void* ref, void* out_key,
                         int cur_ld, int ref_ld, int out_ld, int frame_h,
                         int frame_w, int tile_h, int bf16, void* stream) {
  return launch_key<kDot, kKey>(cur, ref, out_key, nullptr, cur_ld, ref_ld,
                                out_ld, frame_h, frame_w, tile_h, stream);
}

// sad: 0 = SSD by the diff form, 1 = SAD, over bfloat16 planes: as P5B
// and P5SB, the byte instances of "P5" and "P5S" (bfloat16 is exact on
// pixels 0..255).
extern "C" int me_lab_p7(const void* cur, const void* ref, void* out_key,
                         int cur_ld, int ref_ld, int out_ld, int frame_h,
                         int frame_w, int tile_h, int sad, void* stream) {
  return launch_diff(cur, ref, out_key, cur_ld, ref_ld, out_ld, frame_h,
                     frame_w, tile_h, sad, stream);
}

// The resources of an instance into out[0..4]: registers and local (spill)
// bytes per thread, threads a CUDA block, dynamic shared bytes, CUDA
// blocks resident per SM. kind: 0-5 the me_lab_padded variant of that
// code; 6 and 7 the roll mix's instances of 8 and 16 columns a thread for a
// row of `cols` columns at `inner`; 8-14 the key kernel's instances: 8 the
// diff form's key, 9 SAD's key, 10 the cross term's key, 11 the cross
// term's pair, 12 SAD's pair, 13 nochain, 14 nofold; 15 P2's kernel.
// Returns a cudaError_t.
extern "C" int me_lab_occupancy(int kind, int cols, int inner, int* out) {
#define ME_PADDED_OCC(V) \
  occupancy(lab_padded_kernel<V>, kPadThreads, pad_smem_bytes(V), out)
  switch (kind) {
    case kNop: return ME_PADDED_OCC(kNop);
    case kL0:
    case kM1: return ME_PADDED_OCC(kL0);
    case kRaw: return ME_PADDED_OCC(kRaw);
    case kM2: return ME_PADDED_OCC(kM2);
    case kM3: return ME_PADDED_OCC(kM3);
    case 6:
    case 7: {
      const int kc = kind == 6 ? 8 : 16;
      if (roll_cols_ok(cols))
        return occupancy(roll_kernel(kc, inner), cols / kc,
                         roll_smem(cols, inner), out);
      break;
    }
    case 8: return key_occupancy<kSq, kKey>(out);
    case 9: return key_occupancy<kAbs, kKey>(out);
    case 10: return key_occupancy<kDot, kKey>(out);
    case 11: return key_occupancy<kDot, kPair>(out);
    case 12: return key_occupancy<kAbs, kPair>(out);
    case 13: return key_occupancy<kDot, kNochain>(out);
    case 14: return key_occupancy<kDot, kNofold>(out);
    case 15: return occupancy(chain_kernel, kThreads, 0, out);
  }
#undef ME_PADDED_OCC
  return static_cast<int>(cudaErrorInvalidValue);
}
