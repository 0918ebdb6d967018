// Diamond search's trajectory replay over a cost volume for NVIDIA Hopper
// (sm_90a).
//
// me_diamond_replay — replaces the jitted XLA program `_diamond_replay`
//   (motionestimation_tpu/search/diamond.py:259), which is not a Pallas
//   kernel: the JAX package unrolls its LDSP rounds, each under
//   `lax.cond(jnp.any(active))`, inside one program. Its plain version is
//   `replay_plain` (kernels/diamond_cuda.py), the torch ops that replay all
//   blocks in lockstep.
//
// Contract (the plain version's): the volume is [K*K][nby][nbx], K = 2 *
// span + 1, int32 SSD/SAD with INT32_MAX at invalid candidates, or float32
// SSIM scores with -inf. Every block starts at the centre plane and runs up
// to max_steps LDSP rounds, each: the early check (stops the block), escape
// tracking (max(|cy|, |cx|) > span - 2 while active), then the LDSP step,
// its candidates after the centre in the order
//   (-2,0) (-1,-1) (-1,1) (0,-2) (0,2) (1,-1) (1,1) (2,0),
// compared strictly (the first in order wins ties), targets beyond the
// window (|c + o| > span) reading the sentinel; the block stops when the
// centre wins. After the loop: the early check on every block, then on the
// blocks that did not terminate the SDSP step (-1,0) (0,-1) (0,1) (1,0),
// with escape tracking beyond span - 1.
//
// Why a thread can walk its block alone: the lockstep loop gated by
// any(active) changes no state of an inactive block (hit, escape and move
// are all ANDed with active), so each block stopping on its own gives the
// same result; its later trajectory rows hold its last LDSP centre.
//
// The early check is the plain version's float32 arithmetic: for SSD/SAD
// cost / max(count, 1) <= threshold, both converted with round-to-nearest
// and divided with __fdiv_rn; for SSIM score >= threshold. count is the
// block's in-frame pixels, blk_h * blk_w with blk_h = clip(frame_h - tl_y,
// 0, blk) at the global top-left (y_origin + by * blk, x_origin + bx *
// blk), as `geometry.block_extents` computes it.
//
// Design: one thread per block, 128 threads a CUDA block. What bounds it:
// the volume planes its trajectory reads (8 scattered 4-byte loads an LDSP
// round, 4 at SDSP) and the trajectory rows it writes; a warp's 32
// neighbouring blocks read the same plane where their centres agree, so
// those loads coalesce. The volume is indexed with size_t: a 4K 8x8 +-31
// volume holds 5.1e8 entries.

#include <cuda_runtime.h>
#include <stdint.h>

#include "diamond_metric.cuh"

namespace me {
namespace diamond {

constexpr int kThreads = 128;

// One candidate of a pattern step: the cost at (cy + oy, cx + ox), the
// sentinel beyond the window, taken where it beats *best strictly.
template <typename T>
__device__ __forceinline__ void consider(const T* __restrict__ vol,
                                         size_t plane, size_t b, int span,
                                         int k, int cy, int cx, int oy, int ox,
                                         T* best, int* wy, int* wx) {
  const int ty = cy + oy, tx = cx + ox;
  T c = Metric<T>::sentinel();
  if (abs(ty) <= span && abs(tx) <= span)
    c = __ldg(vol + (size_t)((ty + span) * k + (tx + span)) * plane + b);
  if (Metric<T>::better(c, *best)) {
    *best = c;
    *wy = oy;
    *wx = ox;
  }
}

// The LDSP step around (cy, cx), candidates in pattern order after the
// centre (*cost on entry): the winning offset, (0, 0) where the centre
// holds, and its cost in *cost.
template <typename T>
__device__ __forceinline__ void ldsp_step(const T* __restrict__ vol,
                                          size_t plane, size_t b, int span,
                                          int k, int cy, int cx, T* cost,
                                          int* wy, int* wx) {
  *wy = *wx = 0;
  consider(vol, plane, b, span, k, cy, cx, -2, 0, cost, wy, wx);
  consider(vol, plane, b, span, k, cy, cx, -1, -1, cost, wy, wx);
  consider(vol, plane, b, span, k, cy, cx, -1, 1, cost, wy, wx);
  consider(vol, plane, b, span, k, cy, cx, 0, -2, cost, wy, wx);
  consider(vol, plane, b, span, k, cy, cx, 0, 2, cost, wy, wx);
  consider(vol, plane, b, span, k, cy, cx, 1, -1, cost, wy, wx);
  consider(vol, plane, b, span, k, cy, cx, 1, 1, cost, wy, wx);
  consider(vol, plane, b, span, k, cy, cx, 2, 0, cost, wy, wx);
}

// The SDSP step, as ldsp_step.
template <typename T>
__device__ __forceinline__ void sdsp_step(const T* __restrict__ vol,
                                          size_t plane, size_t b, int span,
                                          int k, int cy, int cx, T* cost,
                                          int* wy, int* wx) {
  *wy = *wx = 0;
  consider(vol, plane, b, span, k, cy, cx, -1, 0, cost, wy, wx);
  consider(vol, plane, b, span, k, cy, cx, 0, -1, cost, wy, wx);
  consider(vol, plane, b, span, k, cy, cx, 0, 1, cost, wy, wx);
  consider(vol, plane, b, span, k, cy, cx, 1, 0, cost, wy, wx);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    replay_kernel(const T* __restrict__ vol, int32_t* __restrict__ mv_y,
                  int32_t* __restrict__ mv_x, T* __restrict__ cost_out,
                  uint8_t* __restrict__ escaped_out, int2* __restrict__ traj,
                  int nby, int nbx, int span, int max_steps, int track_escape,
                  int has_threshold, float threshold, int blk, int frame_h,
                  int frame_w, int y_origin, int x_origin) {
  const size_t plane = (size_t)nby * nbx;
  const size_t b = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= plane) return;
  const int by = (int)(b / nbx), bx = (int)(b % nbx);
  const int k = 2 * span + 1;
  const int tl_y = y_origin + by * blk, tl_x = x_origin + bx * blk;
  const int bh = min(max(frame_h - tl_y, 0), blk);
  const int bw = min(max(frame_w - tl_x, 0), blk);
  const int count = bh * bw;

  int cy = 0, cx = 0;
  T c = __ldg(vol + (size_t)(span * k + span) * plane + b);
  bool active = true, terminated = false, escaped = false;
  if (traj != nullptr) traj[b] = make_int2(0, 0);
  for (int t = 0; t < max_steps; ++t) {
    if (active) {
      if (has_threshold && Metric<T>::early(c, count, threshold)) {
        terminated = true;
        active = false;
      } else {
        if (track_escape && max(abs(cy), abs(cx)) > span - 2) escaped = true;
        int wy, wx;
        ldsp_step(vol, plane, b, span, k, cy, cx, &c, &wy, &wx);
        if (wy != 0 || wx != 0) {
          cy += wy;
          cx += wx;
        } else {
          active = false;  // the centre held: converged
        }
      }
    }
    if (traj != nullptr) traj[(size_t)(t + 1) * plane + b] = make_int2(cy, cx);
  }
  if (has_threshold && Metric<T>::early(c, count, threshold))
    terminated = true;
  if (!terminated) {
    if (track_escape && max(abs(cy), abs(cx)) > span - 1) escaped = true;
    int wy, wx;
    sdsp_step(vol, plane, b, span, k, cy, cx, &c, &wy, &wx);
    cy += wy;
    cx += wx;
  }
  mv_y[b] = cy;
  mv_x[b] = cx;
  cost_out[b] = c;
  escaped_out[b] = escaped;
}

}  // namespace diamond
}  // namespace me

// is_float: 0 = int32 SSD/SAD volume, 1 = float32 SSIM volume. vol:
// [(2*span+1)^2][nby][nbx], contiguous. mv_y, mv_x: int32 [nby][nbx];
// cost: the volume's type, [nby][nbx]; escaped: uint8 (bool) [nby][nbx];
// traj: null, or int32 [max_steps + 1][nby][nbx][2]. has_threshold = 0
// disables the early check. Returns the cudaError_t of the launch (0 on
// success). nby, nbx >= 1, span >= 0, max_steps >= 0, blk >= 1.
extern "C" int me_diamond_replay(const void* vol, void* mv_y, void* mv_x,
                                 void* cost, void* escaped, void* traj,
                                 int is_float, int nby, int nbx, int span,
                                 int max_steps, int track_escape,
                                 int has_threshold, float threshold, int blk,
                                 int frame_h, int frame_w, int y_origin,
                                 int x_origin, void* stream) {
  if (nby < 1 || nbx < 1 || span < 0 || max_steps < 0 || blk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t blocks = (size_t)nby * nbx;
  const unsigned grid =
      (unsigned)((blocks + me::diamond::kThreads - 1) / me::diamond::kThreads);
  int32_t* my = static_cast<int32_t*>(mv_y);
  int32_t* mx = static_cast<int32_t*>(mv_x);
  uint8_t* esc = static_cast<uint8_t*>(escaped);
  int2* tr = static_cast<int2*>(traj);
  if (is_float) {
    me::diamond::replay_kernel<float><<<grid, me::diamond::kThreads, 0, s>>>(
        static_cast<const float*>(vol), my, mx, static_cast<float*>(cost),
        esc, tr, nby, nbx, span, max_steps, track_escape, has_threshold,
        threshold, blk, frame_h, frame_w, y_origin, x_origin);
  } else {
    me::diamond::replay_kernel<int32_t>
        <<<grid, me::diamond::kThreads, 0, s>>>(
            static_cast<const int32_t*>(vol), my, mx,
            static_cast<int32_t*>(cost), esc, tr, nby, nbx, span, max_steps,
            track_escape, has_threshold, threshold, blk, frame_h, frame_w,
            y_origin, x_origin);
  }
  return static_cast<int>(cudaGetLastError());
}
