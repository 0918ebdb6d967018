// Diamond search's lazy mode for NVIDIA Hopper (sm_90a): each block's
// canonical LDSP/SDSP walk, every candidate it visits computed from the
// frames' pixels.
//
// me_diamond_walk — replaces the jitted XLA program `_diamond_lazy`
//   (motionestimation_tpu/search/diamond.py:463), which is not a Pallas
//   kernel: the JAX package fills the cost planes near the active centres
//   before each round (a `lax.scan` with a `lax.cond` per plane) and skips
//   a round under `lax.cond(jnp.any(active))`. Its plain version is
//   `search.diamond.lazy_plain`: golden planes from
//   `make_displacement_cost`, picked on the host, replayed by
//   `replay_plain` pass by pass. Here one launch walks every block and
//   writes no volume.
//
// Contract (the plain version's). The frames are uint8 [frame_h][frame_w],
// contiguous. Block (by, bx) has top-left (tl_y, tl_x) = (by * blk, bx *
// blk) and extents bh = clip(frame_h - tl_y, 0, blk), bw likewise, as
// `geometry.block_extents`. Displacement (dy, dx) is valid iff 0 <= tl_y +
// dy <= frame_h - bh and 0 <= tl_x + dx <= frame_w - bw
// (`geometry.displacement_valid`). Its cost is the exact SSD or SAD over
// the block's bh x bw in-frame pixels (taken modulo 2^32, as int32 sums
// wrap), or for SSIM `ssim_score` (ssim_score.cuh) of the five integer
// sums over those pixels; an invalid displacement or a target with |c + o|
// > span reads the sentinel (diamond_metric.cuh). The walk is
// me_diamond_replay's (diamond.cu) without escape tracking: from (0, 0), up
// to max_steps LDSP rounds, each the early check and then the candidates
// (-2,0) (-1,-1) (-1,1) (0,-2) (0,2) (1,-1) (1,1) (2,0) compared strictly
// against the centre (the first in that order wins a tie), stopping when
// the centre holds; after the rounds the early check and, where it did not
// stop the block, the SDSP step (-1,0) (0,-1) (0,1) (1,0). With max_steps
// 0 the SDSP step still runs, as in `diamond_search_np`. Trajectory row 0
// is (0, 0) and row t + 1 the centre after round t; the rows after a block
// stops hold its last LDSP centre.
//
// Design: one CUDA block of eight warps per macroblock. A round's
// candidates are evaluated together, one per warp, the lanes striding over
// the block's pixels (read with __ldg from the frames where they lie: no
// padded copy, no halo) and a warp-shuffle sum; the centre's comparison
// runs in every thread on the candidates in shared memory. Each
// macroblock keeps a memo of the candidates it evaluated (up to kMemo, in
// shared memory; a warp looks its candidate up with ballots), since after
// an LDSP move 3 of the 8 candidates were evaluated the round before;
// beyond kMemo a candidate is computed again. What bounds it: not the
// bytes (each frame is read once for the bound, ~1.2 us at 1080p) but its
// latency: up to max_steps + 1 dependent rounds, each a pass over the
// block's pixels, a reduction and two barriers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "diamond_metric.cuh"
#include "ssim_score.cuh"

namespace me {
namespace diamond {
namespace walk {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMemo = 256;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kSsd = 0, kSad = 1, kSsim = 2 };

// The LDSP offsets (0-7) and the SDSP offsets (8-11), (dy, dx), in pattern
// order.
__constant__ int kPattern[12][2] = {
    {-2, 0}, {-1, -1}, {-1, 1}, {0, -2}, {0, 2}, {1, -1}, {1, 1}, {2, 0},
    {-1, 0}, {0, -1}, {0, 1}, {1, 0}};

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// What every warp of a macroblock needs to evaluate a candidate.
struct Block {
  const uint8_t* cur;  // the block's top-left pixel in the current frame
  const uint8_t* ref;  // the reference frame's pixel (tl_y, tl_x)
  int frame_w;
  int bw;
  int count;  // bh * bw
  int step_r, step_c;  // 32 pixels = step_r rows and step_c columns
};

// The cost or score of displacement (dy, dx), valid for the block: the
// warp's lanes stride over the block's pixels in row-major order, 32
// apart, and every lane returns the sum.
template <typename T, int kKind>
__device__ __forceinline__ T evaluate(const Block& blk, const CurStats& stats,
                                      int dy, int dx, int lane) {
  const uint8_t* ref = blk.ref + (ptrdiff_t)dy * blk.frame_w + dx;
  unsigned a0 = 0, a1 = 0, a2 = 0;
  int r = lane / blk.bw, c = lane - r * blk.bw;
  for (int p = lane; p < blk.count; p += 32) {
    const int off = r * blk.frame_w + c;
    const int cv = __ldg(blk.cur + off);
    const int rv = __ldg(ref + off);
    if constexpr (kKind == kSsim) {
      a0 += rv;
      a1 += rv * rv;
      a2 += rv * cv;
    } else if constexpr (kKind == kSsd) {
      a0 += (cv - rv) * (cv - rv);
    } else {
      a0 += abs(cv - rv);
    }
    r += blk.step_r;
    c += blk.step_c;
    if (c >= blk.bw) {
      c -= blk.bw;
      ++r;
    }
  }
  if constexpr (kKind == kSsim) {
    return ssim_score(stats, static_cast<int>(warp_sum(a0)),
                      static_cast<int>(warp_sum(a1)),
                      static_cast<int>(warp_sum(a2)), blk.count);
  } else {
    return static_cast<int32_t>(warp_sum(a0));
  }
}

template <typename T, int kKind>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const uint8_t* __restrict__ cur,
                const uint8_t* __restrict__ ref, int32_t* __restrict__ mv_y,
                int32_t* __restrict__ mv_x, T* __restrict__ cost_out,
                int2* __restrict__ traj, int nbx, int frame_h, int frame_w,
                int blk, int span, int max_steps, int has_threshold,
                float threshold) {
  __shared__ T cand[kWarps];      // this round's candidates, pattern order
  __shared__ int fresh[kWarps];   // 1 where the warp read its pixels
  __shared__ int memo_key[kMemo];  // (ty + span) * K + (tx + span)
  __shared__ T memo_val[kMemo];
  __shared__ T centre;             // the cost at (0, 0)
  __shared__ unsigned cur_sums[2];  // SSIM: the current block's Σc, Σc²

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t plane = gridDim.x;
  const size_t b = blockIdx.x;
  const int by = static_cast<int>(b / nbx), bx = static_cast<int>(b % nbx);
  const int tl_y = by * blk, tl_x = bx * blk;
  const int bh = min(frame_h - tl_y, blk), bw = min(frame_w - tl_x, blk);
  const int k = 2 * span + 1;
  const size_t tl = (size_t)tl_y * frame_w + tl_x;
  Block blkv{cur + tl, ref + tl, frame_w, bw, bh * bw, 32 / bw, 32 % bw};

  CurStats stats{};
  if constexpr (kKind == kSsim) {
    if (warp == 0) {
      unsigned s = 0, sq = 0;
      int r = lane / bw, c = lane - r * bw;
      for (int p = lane; p < blkv.count; p += 32) {
        const int cv = __ldg(blkv.cur + r * frame_w + c);
        s += cv;
        sq += cv * cv;
        r += blkv.step_r;
        c += blkv.step_c;
        if (c >= bw) {
          c -= bw;
          ++r;
        }
      }
      s = warp_sum(s);
      sq = warp_sum(sq);
      if (lane == 0) {
        cur_sums[0] = s;
        cur_sums[1] = sq;
      }
    }
    __syncthreads();
    stats = cur_stats(static_cast<int>(cur_sums[0]),
                      static_cast<int>(cur_sums[1]), blkv.count);
  }

  // The centre (0, 0) is valid for every block of the frame's grid.
  if (warp == 0) {
    const T c0 = evaluate<T, kKind>(blkv, stats, 0, 0, lane);
    if (lane == 0) {
      centre = c0;
      memo_key[0] = span * k + span;
      memo_val[0] = c0;
    }
  }
  int memo_n = 1;  // the same in every thread
  __syncthreads();
  T c = centre;  // not cand[0]: the first step overwrites it unsynchronised
  int cy = 0, cx = 0;

  // One pattern step around (cy, cx) over kPattern[first .. first + n):
  // the winning offset in (wy, wx), (0, 0) where the centre holds, and its
  // cost in c. Every thread of the CUDA block calls it and gets the same.
  auto step = [&](int first, int n, int* wy, int* wx) {
    if (warp < n) {
      const int ty = cy + kPattern[first + warp][0];
      const int tx = cx + kPattern[first + warp][1];
      T v = Metric<T>::sentinel();
      int read = 0;
      if (abs(ty) <= span && abs(tx) <= span && tl_y + ty >= 0 &&
          tl_y + ty <= frame_h - bh && tl_x + tx >= 0 &&
          tl_x + tx <= frame_w - bw) {
        const int key = (ty + span) * k + (tx + span);
        int hit = -1;
        for (int base = 0; base < memo_n; base += 32) {
          const int i = base + lane;
          const unsigned m =
              __ballot_sync(kFull, i < memo_n && memo_key[i] == key);
          if (m) {
            hit = base + __ffs(m) - 1;
            break;
          }
        }
        if (hit >= 0) {
          v = memo_val[hit];
        } else {
          v = evaluate<T, kKind>(blkv, stats, ty, tx, lane);
          read = 1;
        }
      }
      if (lane == 0) {
        cand[warp] = v;
        fresh[warp] = read;
      }
    }
    __syncthreads();
    *wy = *wx = 0;
    for (int i = 0; i < n; ++i) {
      const int oy = kPattern[first + i][0], ox = kPattern[first + i][1];
      if (Metric<T>::better(cand[i], c)) {
        c = cand[i];
        *wy = oy;
        *wx = ox;
      }
      if (fresh[i] && memo_n < kMemo) {
        if (threadIdx.x == 0) {
          memo_key[memo_n] = (cy + oy + span) * k + (cx + ox + span);
          memo_val[memo_n] = cand[i];
        }
        ++memo_n;
      }
    }
    __syncthreads();
  };

  const int count = blkv.count;
  if (traj != nullptr && threadIdx.x == 0) traj[b] = make_int2(0, 0);
  int t = 0;
  for (; t < max_steps; ++t) {
    if (has_threshold && Metric<T>::early(c, count, threshold)) break;
    int wy, wx;
    step(0, 8, &wy, &wx);
    if (wy == 0 && wx == 0) break;  // the centre held: converged
    cy += wy;
    cx += wx;
    if (traj != nullptr && threadIdx.x == 0)
      traj[(size_t)(t + 1) * plane + b] = make_int2(cy, cx);
  }
  // Rows t + 1 .. max_steps: the last LDSP centre.
  if (traj != nullptr) {
    for (int row = t + 1 + threadIdx.x; row <= max_steps; row += kThreads)
      traj[(size_t)row * plane + b] = make_int2(cy, cx);
  }
  if (!(has_threshold && Metric<T>::early(c, count, threshold))) {
    int wy, wx;
    step(8, 4, &wy, &wx);
    cy += wy;
    cx += wx;
  }
  if (threadIdx.x == 0) {
    mv_y[b] = cy;
    mv_x[b] = cx;
    cost_out[b] = c;
  }
}

template <typename T, int kKind>
void launch(unsigned grid, cudaStream_t s, const void* cur, const void* ref,
            void* mv_y, void* mv_x, void* cost, void* traj, int nbx,
            int frame_h, int frame_w, int blk, int span, int max_steps,
            int has_threshold, float threshold) {
  walk_kernel<T, kKind><<<grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(ref),
      static_cast<int32_t*>(mv_y), static_cast<int32_t*>(mv_x),
      static_cast<T*>(cost), static_cast<int2*>(traj), nbx, frame_h, frame_w,
      blk, span, max_steps, has_threshold, threshold);
}

}  // namespace walk
}  // namespace diamond
}  // namespace me

// metric: 0 = SSD, 1 = SAD (int32 costs), 2 = SSIM (float32 scores). cur,
// ref: uint8 [frame_h][frame_w], contiguous. mv_y, mv_x: int32 [nby][nbx];
// cost: int32 or float32 [nby][nbx]; traj: null, or int32 [max_steps +
// 1][nby][nbx][2]; nby = ceil(frame_h / blk), nbx = ceil(frame_w / blk).
// has_threshold = 0 disables the early check. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int me_diamond_walk(const void* cur, const void* ref, void* mv_y,
                               void* mv_x, void* cost, void* traj, int metric,
                               int frame_h, int frame_w, int blk, int span,
                               int max_steps, int has_threshold,
                               float threshold, void* stream) {
  using namespace me::diamond::walk;
  if (frame_h < 1 || frame_w < 1 || blk < 1 || span < 0 || max_steps < 0 ||
      metric < kSsd || metric > kSsim)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nby = (frame_h + (long long)blk - 1) / blk;
  const long long nbx = (frame_w + (long long)blk - 1) / blk;
  if (nby * nbx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(nby * nbx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nx = static_cast<int>(nbx);
  if (metric == kSsd) {
    launch<int32_t, kSsd>(grid, s, cur, ref, mv_y, mv_x, cost, traj, nx,
                          frame_h, frame_w, blk, span, max_steps,
                          has_threshold, threshold);
  } else if (metric == kSad) {
    launch<int32_t, kSad>(grid, s, cur, ref, mv_y, mv_x, cost, traj, nx,
                          frame_h, frame_w, blk, span, max_steps,
                          has_threshold, threshold);
  } else {
    launch<float, kSsim>(grid, s, cur, ref, mv_y, mv_x, cost, traj, nx,
                         frame_h, frame_w, blk, span, max_steps,
                         has_threshold, threshold);
  }
  return static_cast<int>(cudaGetLastError());
}
