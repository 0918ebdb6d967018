// The SSIM score from exact int32 block sums, one IEEE float32 operation
// at a time, for the SSIM kernels (the warp-per-macroblock body of
// warp_search.cuh and the truncated-extent body of edge_search.cuh).
//
// `ssim_score` evaluates the formula in the order of the plain version
// (metrics/cost.py `ssim_from_sums`), using only the _rn intrinsics,
// __int2float_rn and __float2int_rz. nvcc never contracts those into FMAs
// (it does contract a*b + c written plainly), so the kernels' scores equal
// the plain version's bit for bit on the card and the argmax picks the same
// candidate. Σcur, Σcur² and the block's mean, truncated mean, standard
// deviation and their squares do not depend on the candidate and are taken
// once per block (`CurStats`).
//
// The argmax under any thread order: a valid candidate with score > 0 is
// the 64-bit key ((0x7fffffff - bits(score)) << 32) | flat. Positive floats
// order like their bit patterns, so the minimum key (common.cuh) is the
// highest score, first in raster order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace me {

// The reference's constants (ssim.c:47), rounded to float32.
constexpr float kC1 = 0.01f;
constexpr float kC2 = 0.09f;
constexpr float kC3 = 0.045f;
// -inf: the volume entry of an invalid candidate.
constexpr unsigned kNegInfBits = 0xff800000u;

// The integer parts are taken modulo 2^32, as int32 arithmetic wraps in
// the plain version; their true values fit in int32.
__device__ __forceinline__ int wrap(unsigned v) { return static_cast<int>(v); }

// x / n for the pixel count n. N is the count where it is known at compile
// time, else 0. Where N is a power of two the quotient is x * (1 / N): 1 / N
// is exact, so product and quotient are the same real number and round to
// the same float.
template <int N>
__device__ __forceinline__ float div_count(float x, float n) {
  if constexpr (N > 0 && (N & (N - 1)) == 0) {
    return __fmul_rn(x, 1.0f / N);
  } else {
    return __fdiv_rn(x, n);
  }
}

// Σ(x - M)² / N with M the float mean, centred on the truncated mean so
// that the int32 parts are exact and only the fractional correction rounds.
template <int N = 0>
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
  return div_count<N>(num, n);
}

__device__ __forceinline__ float std_dev(float var) {
  return __fsqrt_rn(fmaxf(var, 0.0f));
}

// What the score needs of the current block, taken once per block.
struct CurStats {
  int sum;
  int n_i;       // max(count, 1)
  float n;
  float mean;
  int imean;     // the mean truncated toward zero
  float std;
  float mean_sq;  // mean * mean
  float std_sq;   // std * std
};

// N as for div_count.
template <int N = 0>
__device__ __forceinline__ CurStats cur_stats(int sum_cur, int sum_sq_cur,
                                              int count) {
  CurStats c;
  c.sum = sum_cur;
  c.n_i = max(count, 1);
  c.n = __int2float_rn(c.n_i);
  c.mean = div_count<N>(__int2float_rn(sum_cur), c.n);
  c.imean = __float2int_rz(c.mean);
  c.std = std_dev(
      centred_var<N>(sum_cur, sum_sq_cur, c.imean, c.mean, c.n_i, c.n));
  c.mean_sq = __fmul_rn(c.mean, c.mean);
  c.std_sq = __fmul_rn(c.std, c.std);
  return c;
}

// N as for div_count.
template <int N = 0>
__device__ __forceinline__ float ssim_score(const CurStats& c, int sum_ref,
                                            int sum_sq_ref, int sum_cross,
                                            int count) {
  const float mean_ref = div_count<N>(__int2float_rn(sum_ref), c.n);
  const int imean_ref = __float2int_rz(mean_ref);
  const float std_ref = std_dev(
      centred_var<N>(sum_ref, sum_sq_ref, imean_ref, mean_ref, c.n_i, c.n));
  const unsigned ic = c.imean, ir = imean_ref;
  const int cross_sum =
      wrap(unsigned(sum_cross) - ic * unsigned(sum_ref) - ir * unsigned(c.sum) +
           unsigned(count) * ir * ic);
  const float cross_var = div_count<N>(__int2float_rn(cross_sum), c.n);
  const float luminance = __fdiv_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(2.0f, mean_ref), c.mean), kC1),
      __fadd_rn(__fadd_rn(__fmul_rn(mean_ref, mean_ref), c.mean_sq), kC1));
  const float contrast = __fdiv_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(2.0f, std_ref), c.std), kC2),
      __fadd_rn(__fadd_rn(__fmul_rn(std_ref, std_ref), c.std_sq), kC2));
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

// The score a key stands for (a key other than kNoKey).
__device__ __forceinline__ float key_score(unsigned long long key) {
  return __uint_as_float(0x7fffffffu - static_cast<unsigned>(key >> 32));
}

}  // namespace me
