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
// What bounds it: not the bytes (each frame is read once for the bound,
// ~1.2 us at 1080p) but latency: a walk is a chain of up to max_steps + 2
// dependent rounds, each a pass over the block's pixels and a reduction.
// The design keeps many walks in flight and each round short:
//
// - A walk is a team of kTeam threads, kTeam / 8 lanes ("a group") to each
//   of a round's candidates: one warp at blk <= 16 (four lanes a
//   candidate, four walks a CUDA block, no barrier: shuffles only), 128
//   threads at blk 17..64 (two walks a CUDA block, each with its named
//   barrier; at 33..64 its registers capped for five CUDA blocks an SM),
//   256 above (one walk a CUDA block). The launcher picks the instance
//   from blk and the metric. A group's lane j takes the block's rows j, j +
//   G, ... whole.
// - The current block is read once per walk, four pixels to a 32-bit word
//   (zero past bw): into the lanes' registers for SSD and SAD at blk <= 16,
//   into shared memory for SSIM there and for every metric at blk 17..64
//   (rows an odd number of words apart, so a group's rows fall on distinct
//   banks), where registers would cost more walks in flight than the
//   shared loads cost; above 64 the lanes read it from the frame each time.
//   Rows of the reference are read as aligned 32-bit words, each word that
//   holds a byte of the row loaded once, and `__funnelshift_r` for the
//   displacement's byte offset; the row's last word is masked to bw. SSD:
//   `__vabsdiffu4` and an unsigned `__dp4a`; SAD: one `vabsdiff4.add`;
//   SSIM: Σr·c, Σr and Σr² by three `__dp4a` a word. All exact; a group's
//   sums meet by shuffles.
// - The winner of a round, the first in pattern order among the best
//   values and kept only if strictly better than the centre, is a
//   reduction on (value, pattern index): shuffles across a one-warp team,
//   one barrier and double-buffered slots in shared memory across warps.
// - No memo, and no value kept from an earlier round. The centre's value
//   falls strictly with every move, and every candidate a round compared
//   is no better than the centre that round moved to, so no target the
//   walk has evaluated can beat the current centre: it cannot win a later
//   round, whatever its value. After an LDSP move of m, candidate p of the
//   new centre is the previous round's candidate m + p where |m + p|_1 = 2
//   (2 of them after an axial move, 4 after a diagonal one) or the
//   previous centre where m + p = 0; those groups hold the sentinel and
//   read no pixel. Targets an older round saw are computed again.

#include <cuda_runtime.h>
#include <stdint.h>

#include "diamond_metric.cuh"
#include "ssim_score.cuh"

namespace me {
namespace diamond {
namespace walk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroups = 8;  // a round's candidate groups: the LDSP's eight

enum Kind { kSsd = 0, kSad = 1, kSsim = 2 };

// A team of kTeam threads walks one block, kLanes lanes to a candidate; a
// CUDA block of kThreads threads holds kTeams teams.
template <int kTeam>
struct Shape {
  static constexpr int kThreads = kTeam == 32 ? 128 : 256;
  static constexpr int kTeams = kThreads / kTeam;
  static constexpr int kLanes = kTeam / kGroups;
};

// A pattern's offsets in order, six bits each: (dy + 2) << 3 | (dx + 2).
constexpr unsigned long long pack(const int (*o)[2], int n) {
  unsigned long long v = 0;
  for (int i = 0; i < n; ++i)
    v |= static_cast<unsigned long long>(((o[i][0] + 2) << 3) |
                                         (o[i][1] + 2))
         << (6 * i);
  return v;
}
constexpr int kLdspOffsets[8][2] = {{-2, 0}, {-1, -1}, {-1, 1}, {0, -2},
                                    {0, 2},  {1, -1},  {1, 1},  {2, 0}};
constexpr int kSdspOffsets[4][2] = {{-1, 0}, {0, -1}, {0, 1}, {1, 0}};
constexpr int kCentreOffset[1][2] = {{0, 0}};
constexpr unsigned long long kLdsp = pack(kLdspOffsets, 8);
constexpr unsigned long long kSdsp = pack(kSdspOffsets, 4);
constexpr unsigned long long kCentre = pack(kCentreOffset, 1);

__device__ __forceinline__ void offset(unsigned long long code, int i,
                                       int* dy, int* dx) {
  const int v = static_cast<int>(code >> (6 * i)) & 63;
  *dy = (v >> 3) - 2;
  *dx = (v & 7) - 2;
}

// Whether an LDSP round evaluated offset (qy, qx) of its centre: the
// centre itself or one of its candidates (|qy| + |qx| = 2).
__device__ __forceinline__ bool in_ldsp_round(int qy, int qx) {
  const int n = abs(qy) + abs(qx);
  return n == 0 || n == 2;
}

// The low n bytes of a word (n in 1..4).
__device__ __forceinline__ uint32_t byte_mask(int n) {
  return n >= 4 ? kFull : (1u << (8 * n)) - 1u;
}

// acc + Σ |a_i - b_i| over the four bytes: one VABSDIFF4.U8.ACC.
__device__ __forceinline__ uint32_t absdiff_add(uint32_t a, uint32_t b,
                                                uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(acc));
  return d;
}

// The sum of v over the G lanes of a group (consecutive lanes of one warp).
// Every lane of the warp calls it.
template <int G>
__device__ __forceinline__ uint32_t group_sum(uint32_t v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The words of a block row of bw bytes at p: word w packs the row's bytes
// 4w..4w+3 (bytes past bw undefined). Each aligned 32-bit word that holds
// a byte of the row is loaded once, in order, so no load leaves the frame.
struct RowWords {
  const uint32_t* a;  // the aligned word holding the row's first byte
  unsigned shift;     // 8 * that byte's place in it
  int last;           // the aligned word (from a) holding the row's last byte
  uint32_t lo;

  __device__ __forceinline__ RowWords(const uint8_t* p, int bw) {
    const uintptr_t u = reinterpret_cast<uintptr_t>(p);
    a = reinterpret_cast<const uint32_t*>(u & ~uintptr_t(3));
    shift = 8u * static_cast<unsigned>(u & 3);
    last = static_cast<int>((u & 3) + bw - 1) >> 2;
    lo = __ldg(a);
  }
  // Word w; called for w = 0, 1, ... in turn.
  __device__ __forceinline__ uint32_t next(int w) {
    const uint32_t hi = w + 1 <= last ? __ldg(a + w + 1) : 0u;
    const uint32_t v = __funnelshift_r(lo, hi, shift);
    lo = hi;
    return v;
  }
};

// A lane's sums of one candidate: SSD, SAD: the cost in `a`; SSIM: Σcur·ref
// in `a`, Σref in s1, Σref² in s2.
struct Sums {
  uint32_t a = 0, s1 = 0, s2 = 0;
};

// One word: c the block's word (zero past bw), r the reference's, m the
// mask of the row's bytes in it.
template <int kKind>
__device__ __forceinline__ void word(Sums& s, uint32_t c, uint32_t r,
                                     uint32_t m) {
  const uint32_t rm = r & m;
  if constexpr (kKind == kSad) {
    s.a = absdiff_add(c, rm, s.a);
  } else if constexpr (kKind == kSsd) {
    const uint32_t d = __vabsdiffu4(c, rm);
    s.a = __dp4a(d, d, s.a);
  } else {
    s.a = __dp4a(c, r, s.a);
    s.s1 = __dp4a(rm, 0x01010101u, s.s1);
    s.s2 = __dp4a(rm, rm, s.s2);
  }
}

// Where a lane finds the block's words: kept in its registers, staged in
// shared memory once per walk, or read from the frame for each candidate.
enum Cur { kCurRegs = 0, kCurShared = 1, kCurFrame = 2 };

// The walks of one CUDA block (the kernels below). A lane of a group takes
// the block's rows j, j + G, ... (at most kRows) whole (at most kWords
// words a row; both 0 for kCurFrame, whose loops run to bh and cw).
template <typename T, int kKind, int kTeam, int kCur, int kRows, int kWords>
__device__ __forceinline__ void walk_teams(
    const uint8_t* __restrict__ cur, const uint8_t* __restrict__ ref,
    int32_t* __restrict__ mv_y, int32_t* __restrict__ mv_x,
    T* __restrict__ cost_out, int2* __restrict__ traj, int nwalks, int nbx,
    int frame_h, int frame_w, int blk, int span, int max_steps,
    int has_threshold, float threshold) {
  using S = Shape<kTeam>;
  constexpr int G = S::kLanes;
  // Across warps: each group's value of a round, the rounds alternating
  // between the two halves, so one barrier a round keeps a round's writes
  // from overtaking the previous round's reads.
  __shared__ T slots[kTeam > 32 ? S::kTeams : 1][2][kGroups];
  // kCurShared: the block's words, rows kWords + 1 apart (odd), so the
  // rows j of a group's lanes fall on distinct banks.
  constexpr int kStride = kWords + 1;
  __shared__ uint32_t cur_s[kCur == kCurShared ? S::kTeams : 1]
                           [kCur == kCurShared ? kRows * G * kStride : 1];

  const int team = threadIdx.x / kTeam;
  const int t_lane = threadIdx.x % kTeam;
  const int group = t_lane / G;
  const int j = t_lane % G;
  const int b = blockIdx.x * S::kTeams + team;
  if (b >= nwalks) return;  // the whole team: the last CUDA block's surplus
  const size_t plane = static_cast<size_t>(nwalks);
  const int by = b / nbx, bx = b - by * nbx;
  const int tl_y = by * blk, tl_x = bx * blk;
  const int bh = min(frame_h - tl_y, blk), bw = min(frame_w - tl_x, blk);
  const int count = bh * bw;
  const int cw = (bw + 3) >> 2;  // words a row
  const uint32_t mlast = byte_mask(bw - 4 * (cw - 1));
  const size_t tl = static_cast<size_t>(tl_y) * frame_w + tl_x;
  const uint8_t* cur_tl = cur + tl;
  const uint8_t* ref_tl = ref + tl;

  auto team_sync = [&]() {
    if constexpr (kTeam == 256) {
      __syncthreads();
    } else if constexpr (kTeam == 128) {
      asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(kTeam)
                   : "memory");
    } else {
      __syncwarp();
    }
  };

  // The lane's rows of the block, masked to bw: in registers, or staged by
  // group 0 (every group's lane j has the same rows).
  uint32_t creg[kCur == kCurRegs ? kRows : 1][kCur == kCurRegs ? kWords : 1];
  uint32_t* cs = cur_s[kCur == kCurShared ? team : 0];
  if constexpr (kCur != kCurFrame) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = j + G * k;
      if constexpr (kCur == kCurRegs) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) creg[k][w] = 0;
      }
      if (r < bh && (kCur == kCurRegs || group == 0)) {
        RowWords row(cur_tl + static_cast<size_t>(r) * frame_w, bw);
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          if (w < cw) {
            const uint32_t c = row.next(w) & (w == cw - 1 ? mlast : kFull);
            if constexpr (kCur == kCurRegs) {
              creg[k][w] = c;
            } else {
              cs[r * kStride + w] = c;
            }
          }
        }
      }
    }
    if constexpr (kCur == kCurShared) team_sync();
  }
  // The block's word w of the lane's row k (row r), where it is kept.
  auto cur_word = [&](int k, int r, int w) {
    if constexpr (kCur == kCurRegs) {
      return creg[k][w];
    } else {
      return cs[r * kStride + w];
    }
  };

  CurStats stats{};
  if constexpr (kKind == kSsim) {
    uint32_t s = 0, q = 0;
    auto add = [&](uint32_t c) {
      s = __dp4a(c, 0x01010101u, s);
      q = __dp4a(c, c, q);
    };
    if constexpr (kCur == kCurFrame) {
      for (int r = j; r < bh; r += G) {
        RowWords row(cur_tl + static_cast<size_t>(r) * frame_w, bw);
        for (int w = 0; w < cw; ++w)
          add(row.next(w) & (w == cw - 1 ? mlast : kFull));
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = j + G * k;
        if (r < bh) {
#pragma unroll
          for (int w = 0; w < kWords; ++w)
            if (w < cw) add(cur_word(k, r, w));
        }
      }
    }
    stats = cur_stats(static_cast<int>(group_sum<G>(s)),
                      static_cast<int>(group_sum<G>(q)), count);
  }

  // The lane's sums of displacement (ty, tx), valid for the block.
  auto lane_sums = [&](int ty, int tx) {
    Sums s;
    const uint8_t* base = ref_tl + static_cast<ptrdiff_t>(ty) * frame_w + tx;
    if constexpr (kCur == kCurFrame) {
      for (int r = j; r < bh; r += G) {
        RowWords rr(base + static_cast<size_t>(r) * frame_w, bw);
        RowWords rc(cur_tl + static_cast<size_t>(r) * frame_w, bw);
        for (int w = 0; w < cw; ++w) {
          const uint32_t m = w == cw - 1 ? mlast : kFull;
          word<kKind>(s, rc.next(w) & m, rr.next(w), m);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = j + G * k;
        if (r < bh) {
          RowWords row(base + static_cast<size_t>(r) * frame_w, bw);
#pragma unroll
          for (int w = 0; w < kWords; ++w)
            if (w < cw)
              word<kKind>(s, cur_word(k, r, w), row.next(w),
                          w == cw - 1 ? mlast : kFull);
        }
      }
    }
    return s;
  };

  int cy = 0, cx = 0;
  int my = 0, mx = 0;  // the last LDSP move
  int buf = 0;         // across warps: this round's slots

  // One round over groups 0..n-1 of pattern `code` around (cy, cx), after
  // the LDSP move (my, mx) where `moved`: the best value, and in *wi its
  // pattern index (the first on ties), in every thread of the team. Groups
  // >= n, invalid targets and targets the previous round evaluated hold
  // the sentinel, which wins no comparison.
  auto round = [&](unsigned long long code, int n, bool moved, int* wi) {
    int dy = 0, dx = 0;
    if (group < n) offset(code, group, &dy, &dx);
    const int ty = cy + dy, tx = cx + dx;
    const bool compute =
        group < n && !(moved && in_ldsp_round(my + dy, mx + dx)) &&
        abs(ty) <= span && abs(tx) <= span && tl_y + ty >= 0 &&
        tl_y + ty <= frame_h - bh && tl_x + tx >= 0 &&
        tl_x + tx <= frame_w - bw;
    T v = Metric<T>::sentinel();
    Sums s;
    if (compute) s = lane_sums(ty, tx);
    s.a = group_sum<G>(s.a);
    if constexpr (kKind == kSsim) {
      s.s1 = group_sum<G>(s.s1);
      s.s2 = group_sum<G>(s.s2);
      if (compute)
        v = ssim_score(stats, static_cast<int>(s.s1),
                       static_cast<int>(s.s2), static_cast<int>(s.a), count);
    } else {
      if (compute) v = static_cast<int32_t>(s.a);
    }

    T best = v;
    int bi = group;
    if constexpr (kTeam == 32) {
#pragma unroll
      for (int off = G; off < 32; off <<= 1) {
        const T ov = __shfl_xor_sync(kFull, best, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (Metric<T>::better(ov, best) || (ov == best && oi < bi)) {
          best = ov;
          bi = oi;
        }
      }
    } else {
      if (j == 0) slots[team][buf][group] = v;
      team_sync();
      best = slots[team][buf][0];
      bi = 0;
      for (int i = 1; i < n; ++i) {
        const T x = slots[team][buf][i];
        if (Metric<T>::better(x, best)) {
          best = x;
          bi = i;
        }
      }
      buf ^= 1;
    }
    *wi = bi;
    return best;
  };

  int wi;
  T c = round(kCentre, 1, false, &wi);  // (0, 0) is valid for every block
  const bool lead = t_lane == 0;
  if (traj != nullptr && lead) traj[b] = make_int2(0, 0);
  bool moved = false;
  int t = 0;
  for (; t < max_steps; ++t) {
    if (has_threshold && Metric<T>::early(c, count, threshold)) break;
    const T best = round(kLdsp, 8, moved, &wi);
    if (!Metric<T>::better(best, c)) break;  // the centre held: converged
    offset(kLdsp, wi, &my, &mx);
    c = best;
    cy += my;
    cx += mx;
    moved = true;
    if (traj != nullptr && lead)
      traj[static_cast<size_t>(t + 1) * plane + b] = make_int2(cy, cx);
  }
  // Rows t + 1 .. max_steps: the last LDSP centre.
  if (traj != nullptr) {
    for (int row = t + 1 + t_lane; row <= max_steps; row += kTeam)
      traj[static_cast<size_t>(row) * plane + b] = make_int2(cy, cx);
  }
  if (!(has_threshold && Metric<T>::early(c, count, threshold))) {
    const T best = round(kSdsp, 4, false, &wi);
    if (Metric<T>::better(best, c)) {
      int dy, dx;
      offset(kSdsp, wi, &dy, &dx);
      cy += dy;
      cx += dx;
      c = best;
    }
  }
  if (lead) {
    mv_y[b] = cy;
    mv_x[b] = cx;
    cost_out[b] = c;
  }
}

#define ME_WALK_PARAMS                                                      \
  const uint8_t *__restrict__ cur, const uint8_t *__restrict__ ref,         \
      int32_t *__restrict__ mv_y, int32_t *__restrict__ mv_x,               \
      T *__restrict__ cost_out, int2 *__restrict__ traj, int nwalks, int nbx, \
      int frame_h, int frame_w, int blk, int span, int max_steps,           \
      int has_threshold, float threshold
#define ME_WALK_ARGS                                                         \
  cur, ref, mv_y, mv_x, cost_out, traj, nwalks, nbx, frame_h, frame_w, blk, \
      span, max_steps, has_threshold, threshold

template <typename T, int kKind, int kTeam, int kCur, int kRows, int kWords>
__global__ void __launch_bounds__(Shape<kTeam>::kThreads)
    walk_kernel(ME_WALK_PARAMS) {
  walk_teams<T, kKind, kTeam, kCur, kRows, kWords>(ME_WALK_ARGS);
}

// The same with its registers capped so that kCappedBlocks CUDA blocks fit
// on an SM: for the 128-thread walks at blk 33..64, more walks in flight
// pay for the spills (measured on the card).
constexpr int kCappedBlocks = 5;
template <typename T, int kKind, int kTeam, int kCur, int kRows, int kWords>
__global__ void __launch_bounds__(Shape<kTeam>::kThreads, kCappedBlocks)
    walk_kernel_capped(ME_WALK_PARAMS) {
  walk_teams<T, kKind, kTeam, kCur, kRows, kWords>(ME_WALK_ARGS);
}

#undef ME_WALK_PARAMS
#undef ME_WALK_ARGS

template <typename T, int kKind, int kTeam, int kCur, int kRows, int kWords,
          bool kCapped>
auto kernel() {
  if constexpr (kCapped) {
    return walk_kernel_capped<T, kKind, kTeam, kCur, kRows, kWords>;
  } else {
    return walk_kernel<T, kKind, kTeam, kCur, kRows, kWords>;
  }
}

template <typename T, int kKind, int kTeam, int kCur, int kRows, int kWords,
          bool kCapped>
int launch(cudaStream_t s, const void* cur, const void* ref, void* mv_y,
           void* mv_x, void* cost, void* traj, int nwalks, int nbx,
           int frame_h, int frame_w, int blk, int span, int max_steps,
           int has_threshold, float threshold) {
  using S = Shape<kTeam>;
  const unsigned grid =
      static_cast<unsigned>((nwalks + S::kTeams - 1) / S::kTeams);
  kernel<T, kKind, kTeam, kCur, kRows, kWords, kCapped>()<<<grid, S::kThreads,
                                                            0, s>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(ref),
      static_cast<int32_t*>(mv_y), static_cast<int32_t*>(mv_x),
      static_cast<T*>(cost), static_cast<int2*>(traj), nwalks, nbx, frame_h,
      frame_w, blk, span, max_steps, has_threshold, threshold);
  return static_cast<int>(cudaGetLastError());
}

// An instance's resources on the current card: registers and local (spill)
// bytes per thread, threads a walk, walks a CUDA block, CUDA blocks resident
// per SM.
template <typename T, int kKind, int kTeam, int kCur, int kRows, int kWords,
          bool kCapped>
int occupancy(int* out) {
  using S = Shape<kTeam>;
  auto kernel =
      walk::kernel<T, kKind, kTeam, kCur, kRows, kWords, kCapped>();
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        S::kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = kTeam;
  out[3] = S::kTeams;
  out[4] = blocks;
  return 0;
}

}  // namespace walk
}  // namespace diamond
}  // namespace me

// The instance of a blk (measured on the card): threads a walk, where a
// lane finds the block's words, at most how many rows a lane and words a
// row, and whether its registers are capped. ME_WALK_METRIC returns
// CALL(T, kind, team, cur, rows, words, capped) for `metric` and `blk`.
#define ME_WALK_SHAPE(CALL, T, K)                                       \
  constexpr int kCur16 = K == kSsim ? kCurShared : kCurRegs;             \
  if (blk <= 4) return CALL(T, K, 32, kCur16, 1, 1, false);              \
  if (blk <= 8) return CALL(T, K, 32, kCur16, 2, 2, false);              \
  if (blk <= 12) return CALL(T, K, 32, kCur16, 3, 3, false);             \
  if (blk <= 16) return CALL(T, K, 32, kCur16, 4, 4, false);             \
  if (blk <= 32) return CALL(T, K, 128, kCurShared, 2, 8, false);        \
  if (blk <= 64) return CALL(T, K, 128, kCurShared, 4, 16, true);        \
  return CALL(T, K, 256, kCurFrame, 0, 0, false);
#define ME_WALK_METRIC(CALL)                                 \
  using namespace me::diamond::walk;                         \
  if (metric == kSsd) {                                      \
    ME_WALK_SHAPE(CALL, int32_t, kSsd)                       \
  }                                                          \
  if (metric == kSad) {                                      \
    ME_WALK_SHAPE(CALL, int32_t, kSad)                       \
  }                                                          \
  ME_WALK_SHAPE(CALL, float, kSsim)

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
  if (frame_h < 1 || frame_w < 1 || blk < 1 || span < 0 || max_steps < 0 ||
      metric < 0 || metric > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nby = (frame_h + (long long)blk - 1) / blk;
  const long long nbx = (frame_w + (long long)blk - 1) / blk;
  if (nby * nbx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int nwalks = static_cast<int>(nby * nbx);
  const int nx = static_cast<int>(nbx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ME_WALK_LAUNCH(T, K, TEAM, CUR, ROWS, WORDS, CAPPED)              \
  launch<T, K, TEAM, CUR, ROWS, WORDS, CAPPED>(                           \
      s, cur, ref, mv_y, mv_x, cost, traj, nwalks, nx, frame_h, frame_w, \
      blk, span, max_steps, has_threshold, threshold)
  ME_WALK_METRIC(ME_WALK_LAUNCH);
#undef ME_WALK_LAUNCH
}

// The resources of the instance me_diamond_walk launches for (metric,
// blk): out[0..4] = registers, local bytes per thread, threads a walk,
// walks a CUDA block, CUDA blocks resident per SM. Returns a cudaError_t.
extern "C" int me_diamond_walk_occupancy(int metric, int blk, int* out) {
  if (blk < 1 || metric < 0 || metric > 2)
    return static_cast<int>(cudaErrorInvalidValue);
#define ME_WALK_OCCUPANCY(T, K, TEAM, CUR, ROWS, WORDS, CAPPED) \
  occupancy<T, K, TEAM, CUR, ROWS, WORDS, CAPPED>(out)
  ME_WALK_METRIC(ME_WALK_OCCUPANCY);
#undef ME_WALK_OCCUPANCY
}
