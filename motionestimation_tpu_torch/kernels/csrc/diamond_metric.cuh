// The comparison, sentinel and early check of a diamond walk, shared by
// the replay over a cost volume (diamond.cu) and the walk over the frames'
// pixels (diamond_walk.cu): int32 SSD/SAD costs, smaller wins, INT32_MAX
// outside the window; float32 SSIM scores, larger wins, -inf outside it.
//
// The early check is the plain version's float32 arithmetic: for SSD/SAD
// cost / max(count, 1) <= threshold, both converted with round-to-nearest
// and divided with __fdiv_rn; for SSIM score >= threshold.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace me {
namespace diamond {

template <typename T>
struct Metric;

// SSD / SAD: smaller wins, INT32_MAX outside the window.
template <>
struct Metric<int32_t> {
  static __device__ __forceinline__ int32_t sentinel() { return INT32_MAX; }
  static __device__ __forceinline__ bool better(int32_t c, int32_t best) {
    return c < best;
  }
  static __device__ __forceinline__ bool early(int32_t c, int count,
                                               float threshold) {
    const float per_px =
        __fdiv_rn(__int2float_rn(c), __int2float_rn(count > 1 ? count : 1));
    return per_px <= threshold;
  }
};

// SSIM: larger wins, -inf outside the window.
template <>
struct Metric<float> {
  static __device__ __forceinline__ float sentinel() {
    return __int_as_float(static_cast<int>(0xff800000u));  // -inf
  }
  static __device__ __forceinline__ bool better(float c, float best) {
    return c > best;
  }
  static __device__ __forceinline__ bool early(float c, int, float threshold) {
    return c >= threshold;
  }
};

}  // namespace diamond
}  // namespace me
