// Pieces shared by the search kernels of full_search.cu and ssim.cu.
//
// Every search kernel keeps its best candidate per thread as one 64-bit
// key (score in the high word, flat raster index in the low word) and takes
// the minimum over the CUDA block: warp shuffles, then one shared-memory
// slot per warp. The minimum key is the best score, first in raster order,
// whatever order the threads ran in.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace me {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// Min of every thread's key into red[slot * kWarps + warp]. All threads of
// the CUDA block must call it.
__device__ __forceinline__ void warp_store_min(unsigned long long key,
                                               unsigned long long* red,
                                               int slot) {
  key = warp_min(key);
  if ((threadIdx.x & 31) == 0) red[slot * kWarps + (threadIdx.x >> 5)] = key;
}

// The minimum over the kWarps entries of one slot (after __syncthreads).
__device__ __forceinline__ unsigned long long slot_min(
    const unsigned long long* red, int slot) {
  unsigned long long best = red[slot * kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    unsigned long long v = red[slot * kWarps + w];
    best = v < best ? v : best;
  }
  return best;
}

// Allow `bytes` of dynamic shared memory for `kernel`; false if the card
// cannot give that much to one block.
template <typename Kernel>
bool reserve_smem(Kernel kernel, size_t bytes) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  if (bytes > static_cast<size_t>(optin)) return false;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes)) != cudaSuccess)
    return false;
  return true;
}

}  // namespace me
