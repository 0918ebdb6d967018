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
// with escape tracking beyond span - 1. The kernel writes the whole
// MotionField: the MV, the cost (SSD/SAD) or the flat index (cy + span) *
// K + (cx + span) (SSIM), the mean cost / max(count, 1) in float32
// (__int2float_rn both, __fdiv_rn: `mse_from_ssd`, `mad_from_sad`) or the
// SSIM score, and the escape mask.
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
// blk), as `geometry.block_extents` computes it. The kernel tests it
// without a division a round (`EarlyCut`).
//
// Design: one thread per block, a warp a CUDA block. What bounds it
// is a chain of dependent loads: a round's candidates depend on the round
// before, and a 1080p or 4K plane fills ~2 warps an SM, so nothing hides
// a round trip. So a thread walks its block in trips: at the trip's
// centre it loads every volume entry within L1 distance 2 * D into
// registers (41 at D = 2; the sentinel, and no load, beyond the window;
// no window test where the whole neighbourhood lies inside it), then
// resolves up to D LDSP rounds, and the SDSP step of a walk that ends
// inside the trip, from those registers: the candidates of a round at
// most D - 1 moves from the centre lie within 2 * D of it. A walk of n
// moves costs floor(n / D) + 1 trips instead of n + 2 single loads. The
// registers are indexed only with compile-time offsets: round j's centre
// lies on the ring of L1 radius 2 j around the trip's centre, and each of
// its candidates is a select over the ring's positions (no branch: a tree
// of branches over the winners serialised the warps whose walks diverge,
// and ran slower than one load a round). A warp's 32 neighbouring blocks
// read the same plane where their centres agree, so the loads coalesce.
// The volume is indexed with size_t: a 4K 8x8 +-31 volume holds 5.1e8
// entries.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "diamond_metric.cuh"

namespace me {
namespace diamond {

// Threads a CUDA block: a warp for the trips, so that a small plane's few
// warps spread over every SM (against 64 and 128: equal at config3,
// 0.0003-0.0005 ms faster at the 4K worst case); 128 for the rounds,
// whose large planes need many warps resident (an SM holds at most 32
// CUDA blocks).
template <int D>
constexpr int kThreads = D == 0 ? 128 : 32;
// LDSP rounds a trip (D). Measured on the H100 for both types against
// D = 3 (85 registers of neighbourhood, ~120 in all): D = 3 gained at most
// 0.0003 ms at config3 and lost up to 0.0014 where walks are long.
constexpr int kDepth = 2;
// From this many blocks a plane, a walk loads one LDSP round at a time
// (D = 0, the design of PR 16): enough warps are resident to hide the
// chain's latency, and a trip's 41 loads for two rounds' 16 cost more than
// they save. Measured: at 4K 8x8 (129,600 blocks) trips took 0.032 /
// 0.063 ms a level against 0.024 / 0.034 a round a load; at 32,400 blocks
// trips won at short walks and lost at long ones, and won in sum.
constexpr size_t kRoundPlane = 1u << 16;

template <typename T>
constexpr bool kSsim = std::is_same<T, float>::value;

__host__ __device__ constexpr int cabs(int v) { return v < 0 ? -v : v; }

// The offsets (oy, ox) with |oy| + |ox| <= R in raster order: slot(oy, ox)
// is an offset's register (row y holds 2 (R - |y|) + 1 of them), and
// entry I of the (2R + 1)^2 square around the centre is (oy(I), ox(I)).
template <int R>
struct Hood {
  static constexpr int kSize = 2 * R * (R + 1) + 1;
  static constexpr int kSquare = (2 * R + 1) * (2 * R + 1);
  static __host__ __device__ constexpr int slot(int oy, int ox) {
    const int rows = oy <= 0 ? (oy + R) * (oy + R)
                             : R * R + oy * (2 * R + 1) - oy * oy + oy;
    return rows + ox + R - cabs(oy);
  }
  static __host__ __device__ constexpr int oy(int i) {
    return i / (2 * R + 1) - R;
  }
  static __host__ __device__ constexpr int ox(int i) {
    return i % (2 * R + 1) - R;
  }
};

// The SSD/SAD early check without a division: q = x / m (x the cost and m
// the count as float32) rounds to at most t iff q < u, u the midpoint
// between t and the next float32 above it (q == u cannot occur: u * m has
// an odd significand of 25 or more bits, x at most 24). u has at most 25
// significant bits and m 24, so u * m is exact in double, and so is x:
// the test is one comparison. t = +inf, -inf and NaN fall out of the same
// formula (always, never, never).
struct EarlyCut {
  double um;
  __device__ __forceinline__ EarlyCut(float t, int count) {
    const double m = (double)__int2float_rn(count > 1 ? count : 1);
    const float next = nextafterf(t, __int_as_float(0x7f800000));
    um = ((double)t + (double)next) * 0.5 * m;
  }
  __device__ __forceinline__ bool early(int32_t c) const {
    return (double)__int2float_rn(c) < um;
  }
};

// A block's walk: the centre (cy, cx) after each LDSP round and its cost
// c, the rounds taken, the SDSP step's offset, and the flags.
template <typename T>
struct Walk {
  int cy = 0, cx = 0, t = 0, sy = 0, sx = 0;
  T c;
  bool escaped = false, terminated = false;
};

// What a walk reads besides the volume: the early check and the rounds.
template <typename T>
struct Ctx {
  int span, max_steps;
  bool track_escape, has_threshold;
  float threshold;
  EarlyCut cut;
  int2* traj;
  size_t plane, b;
  __device__ __forceinline__ bool early(T c) const;
  __device__ __forceinline__ void record(const Walk<T>& w) const {
    if (traj != nullptr)
      traj[(size_t)w.t * plane + b] = make_int2(w.cy, w.cx);
  }
};

template <>
__device__ __forceinline__ bool Ctx<int32_t>::early(int32_t c) const {
  return has_threshold && cut.early(c);
}
template <>
__device__ __forceinline__ bool Ctx<float>::early(float c) const {
  return has_threshold && Metric<float>::early(c, 0, threshold);
}

// Bit o + R of the result is set where |c + o| <= span, o in [-R, R].
template <int R>
__device__ __forceinline__ unsigned window_bits(int c, int span) {
  const int lo = max(-R, -span - c), hi = min(R, span - c);
  return lo > hi ? 0u : ((2u << (hi - lo)) - 1u) << (lo + R);
}

// Entry I of the square around the centre into n where it lies within L1
// distance R: the volume's (plane4 bytes a plane, k planes a row of the
// window), or with Edge the sentinel where bit oy + R of rows or ox + R of
// cols is clear (beyond the window).
template <typename T, int R, int I, bool Edge>
__device__ __forceinline__ void load_entry(T (&n)[Hood<R>::kSize],
                                           const char* centre, int k,
                                           int plane4, unsigned rows,
                                           unsigned cols) {
  constexpr int oy = Hood<R>::oy(I), ox = Hood<R>::ox(I);
  if constexpr (cabs(oy) + cabs(ox) <= R) {
    constexpr int s = Hood<R>::slot(oy, ox);
    const T* p = reinterpret_cast<const T*>(
        centre + (long long)(oy * k + ox) * plane4);
    if constexpr (Edge) {
      T v = Metric<T>::sentinel();
      if ((rows >> (oy + R)) & (cols >> (ox + R)) & 1u) v = __ldg(p);
      n[s] = v;
    } else {
      n[s] = __ldg(p);
    }
  }
}

// Every entry within L1 distance R of (cy, cx) into n, each register
// named at compile time; no window test where the whole neighbourhood
// lies inside the window.
template <typename T, int R, int... I>
__device__ __forceinline__ void load_hood(T (&n)[Hood<R>::kSize],
                                          const T* __restrict__ vol,
                                          size_t plane, size_t b, int span,
                                          int k, int cy, int cx,
                                          std::integer_sequence<int, I...>) {
  const char* centre = reinterpret_cast<const char*>(
      vol + (size_t)((cy + span) * k + (cx + span)) * plane + b);
  const int plane4 = (int)(plane * sizeof(T));
  if (max(abs(cy), abs(cx)) <= span - R) {
    (load_entry<T, R, I, false>(n, centre, k, plane4, 0u, 0u), ...);
  } else {
    const unsigned rows = window_bits<R>(cy, span);
    const unsigned cols = window_bits<R>(cx, span);
    (load_entry<T, R, I, true>(n, centre, k, plane4, rows, cols), ...);
  }
}

// The LDSP offsets in pattern order as 1..8 and the SDSP offsets as 1..4
// (0: the centre); the ring of radius r, its 4 r positions at L1 distance
// r in raster order (the centre alone at r = 0).
__host__ __device__ constexpr int pattern_y(bool ldsp, int i) {
  return ldsp ? (i == 0 ? 0 : i == 1 ? -2 : i <= 3 ? -1 : i <= 5 ? 0
                 : i <= 7 ? 1 : 2)
              : (i == 1 ? -1 : i == 4 ? 1 : 0);
}
__host__ __device__ constexpr int pattern_x(bool ldsp, int i) {
  return ldsp ? (i == 2 || i == 6 ? -1 : i == 3 || i == 7 ? 1 : i == 4 ? -2
                 : i == 5 ? 2 : 0)
              : (i == 2 ? -1 : i == 3 ? 1 : 0);
}
// The offsets of pattern index i + 2 in 3 bits a field, for a winner's
// move decoded at run time without a table.
__host__ __device__ constexpr unsigned packed(bool ldsp, bool x) {
  unsigned p = 0;
  for (int i = 0; i < 9; ++i)
    p |= unsigned((x ? pattern_x(ldsp, i) : pattern_y(ldsp, i)) + 2)
         << (3 * i);
  return p;
}
__host__ __device__ constexpr int ring_size(int r) {
  return r == 0 ? 1 : 4 * r;
}
__host__ __device__ constexpr int ring_y(int r, int i) {
  for (int y = -r; y <= r; ++y) {
    const int n = cabs(y) == r ? 1 : 2;
    if (i < n) return y;
    i -= n;
  }
  return 0;
}
__host__ __device__ constexpr int ring_x(int r, int i) {
  for (int y = -r; y <= r; ++y) {
    const int w = r - cabs(y), n = w == 0 ? 1 : 2;
    if (i < n) return i == 0 ? -w : w;
    i -= n;
  }
  return 0;
}

// The register of offset (Y, X) from the trip's centre.
template <typename T, int R, int Y, int X>
__device__ __forceinline__ T at(const T (&n)[Hood<R>::kSize]) {
  static_assert(cabs(Y) + cabs(X) <= R, "outside the trip");
  constexpr int s = Hood<R>::slot(Y, X);
  return n[s];
}

// v = the candidates of a pattern around (Y, X) where hit.
template <typename T, int R, bool Ldsp, int Y, int X, int... K>
__device__ __forceinline__ void pick(const T (&n)[Hood<R>::kSize],
                                     T (&v)[sizeof...(K)], bool hit,
                                     std::integer_sequence<int, K...>) {
  ((v[K] = hit ? at<T, R, Y + pattern_y(Ldsp, K + 1),
                    X + pattern_x(Ldsp, K + 1)>(n)
               : v[K]),
   ...);
}

// v = the candidates of a pattern around the position key (y * 16 + x)
// where it is the I-th on the ring of radius Ring; with First, the ring's
// first position needs no test (it is the default).
template <typename T, int R, bool Ldsp, int Ring, bool First, int... I>
__device__ __forceinline__ void pick_ring(const T (&n)[Hood<R>::kSize],
                                          T (&v)[Ldsp ? 8 : 4], int key,
                                          std::integer_sequence<int, I...>) {
  (pick<T, R, Ldsp, ring_y(Ring, I), ring_x(Ring, I)>(
       n, v,
       (First && I == 0) || key == ring_y(Ring, I) * 16 + ring_x(Ring, I),
       std::make_integer_sequence<int, Ldsp ? 8 : 4>()),
   ...);
}

// v = the candidates of a pattern around the position key, which lies on
// a ring of radius Ring, or (Below) of radius Ring or less, even: selects
// over the positions, no branch (the rounds of a warp's walks diverge
// where the costs are flat).
template <typename T, int R, bool Ldsp, int Ring, bool Below>
__device__ __forceinline__ void gather(const T (&n)[Hood<R>::kSize],
                                       T (&v)[Ldsp ? 8 : 4], int key) {
  constexpr bool kFirst = !Below || Ring == 0;
  if constexpr (Below && Ring > 0)
    gather<T, R, Ldsp, Ring - 2, true>(n, v, key);
  pick_ring<T, R, Ldsp, Ring, kFirst>(
      n, v, key, std::make_integer_sequence<int, ring_size(Ring)>());
}

// The first of v (pattern order) that beats *best strictly: its index
// 1..M in *win, 0 where none does.
template <typename T, int M>
__device__ __forceinline__ void compare(const T (&v)[M], T* best, int* win) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (Metric<T>::better(v[i], *best)) {
      *best = v[i];
      *win = i + 1;
    }
  }
}

// The move of pattern index win (0: none).
__device__ __forceinline__ int move_of(unsigned packed_offsets, int win) {
  return (int)((packed_offsets >> (3 * win)) & 7u) - 2;
}

// Round J of a trip, where the walk has not ended: the early check, escape
// tracking and the LDSP step from the registers, the centre at key from
// the trip's, on the ring of radius 2 J (each move beats every target the
// round compared, so no later round returns inside the rings before).
// done: the walk ended; sdsp: it ended without the early check's stop,
// and takes its SDSP step.
template <typename T, int D, int J>
__device__ __forceinline__ void trip_rounds(
    const T (&n)[Hood<2 * D>::kSize], Walk<T>& w, const Ctx<T>& x,
    int& key, bool& done, bool& sdsp) {
  if constexpr (J < D) {
    if (!done) {
      if (w.t == x.max_steps) {
        done = sdsp = true;
      } else if (x.early(w.c)) {
        done = w.terminated = true;
      } else {
        if (x.track_escape && max(abs(w.cy), abs(w.cx)) > x.span - 2)
          w.escaped = true;
        T v[8];
        gather<T, 2 * D, true, 2 * J, false>(n, v, key);
        T best = w.c;
        int win = 0;
        compare(v, &best, &win);
        ++w.t;
        if (win == 0) {  // the centre held: converged
          done = sdsp = true;
        } else {
          constexpr unsigned kY = packed(true, false);
          constexpr unsigned kX = packed(true, true);
          const int oy = move_of(kY, win), ox = move_of(kX, win);
          w.cy += oy;
          w.cx += ox;
          key += oy * 16 + ox;
          w.c = best;
        }
        x.record(w);
      }
    }
    trip_rounds<T, D, J + 1>(n, w, x, key, done, sdsp);
  }
}

// After the LDSP rounds, at key from the trip's centre: the early check,
// then the SDSP step from the registers.
template <typename T, int D>
__device__ __forceinline__ void finish(const T (&n)[Hood<2 * D>::kSize],
                                       Walk<T>& w, const Ctx<T>& x, int key) {
  if (x.early(w.c)) {
    w.terminated = true;
    return;
  }
  if (x.track_escape && max(abs(w.cy), abs(w.cx)) > x.span - 1)
    w.escaped = true;
  T v[4];
  gather<T, 2 * D, false, 2 * (D - 1), true>(n, v, key);
  T best = w.c;
  int win = 0;
  compare(v, &best, &win);
  w.c = best;
  constexpr unsigned kY = packed(false, false), kX = packed(false, true);
  w.sy = move_of(kY, win);
  w.sx = move_of(kX, win);
}

// The walk in trips of D rounds, from the registers of each trip's
// neighbourhood.
template <typename T, int D>
__device__ __forceinline__ void walk_trips(const T* __restrict__ vol,
                                           size_t plane, size_t b, int span,
                                           int k, Walk<T>& w,
                                           const Ctx<T>& x) {
  using H = Hood<2 * D>;
  for (;;) {
    T n[H::kSize];
    load_hood<T, 2 * D>(n, vol, plane, b, span, k, w.cy, w.cx,
                        std::make_integer_sequence<int, H::kSquare>());
    constexpr int kCentre = H::slot(0, 0);
    w.c = n[kCentre];  // the centre's cost, as it was
    int key = 0;
    bool done = false, sdsp = false;
    trip_rounds<T, D, 0>(n, w, x, key, done, sdsp);
    if (!done) continue;  // D rounds moved: the next trip
    if (sdsp) finish<T, D>(n, w, x, key);
    return;
  }
}

// One candidate of a pattern step read from the volume: the entry at
// (cy + OY, cx + OX), the sentinel beyond the window, taken where it beats
// *best strictly: *win = I.
template <typename T, int OY, int OX, int I>
__device__ __forceinline__ void consider(const T* __restrict__ vol,
                                         size_t plane, size_t b, int span,
                                         int k, int cy, int cx, T* best,
                                         int* win) {
  const int ty = cy + OY, tx = cx + OX;
  T c = Metric<T>::sentinel();
  if (abs(ty) <= span && abs(tx) <= span)
    c = __ldg(vol + (size_t)((ty + span) * k + (tx + span)) * plane + b);
  if (Metric<T>::better(c, *best)) {
    *best = c;
    *win = I;
  }
}

// A pattern step read from the volume around (cy, cx): the winner's index
// (0: the centre held) and its cost in *best.
template <typename T, bool Ldsp, int... K>
__device__ __forceinline__ int step(const T* __restrict__ vol, size_t plane,
                                    size_t b, int span, int k, int cy, int cx,
                                    T* best,
                                    std::integer_sequence<int, K...>) {
  int win = 0;
  (consider<T, pattern_y(Ldsp, K + 1), pattern_x(Ldsp, K + 1), K + 1>(
       vol, plane, b, span, k, cy, cx, best, &win),
   ...);
  return win;
}

// The walk one LDSP round a load, and the SDSP step a load of its own.
template <typename T>
__device__ __forceinline__ void walk_rounds(const T* __restrict__ vol,
                                            size_t plane, size_t b, int span,
                                            int k, Walk<T>& w,
                                            const Ctx<T>& x) {
  w.c = __ldg(vol + (size_t)(span * k + span) * plane + b);
  while (w.t < x.max_steps) {
    if (x.early(w.c)) {
      w.terminated = true;
      return;
    }
    if (x.track_escape && max(abs(w.cy), abs(w.cx)) > x.span - 2)
      w.escaped = true;
    const int win = step<T, true>(vol, plane, b, span, k, w.cy, w.cx, &w.c,
                                  std::make_integer_sequence<int, 8>());
    ++w.t;
    constexpr unsigned kY = packed(true, false), kX = packed(true, true);
    w.cy += move_of(kY, win);
    w.cx += move_of(kX, win);
    x.record(w);
    if (win == 0) break;  // the centre held: converged
  }
  if (x.early(w.c)) {
    w.terminated = true;
    return;
  }
  if (x.track_escape && max(abs(w.cy), abs(w.cx)) > x.span - 1)
    w.escaped = true;
  const int win = step<T, false>(vol, plane, b, span, k, w.cy, w.cx, &w.c,
                                 std::make_integer_sequence<int, 4>());
  constexpr unsigned kY = packed(false, false), kX = packed(false, true);
  w.sy = move_of(kY, win);
  w.sx = move_of(kX, win);
}

// D >= 1: in trips of D rounds (small planes); D = 0: a round a load.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads<D>)
    replay_kernel(const T* __restrict__ vol, int32_t* __restrict__ mv_y,
                  int32_t* __restrict__ mv_x, int32_t* __restrict__ best_i32,
                  float* __restrict__ score,
                  uint8_t* __restrict__ escaped_out, int2* __restrict__ traj,
                  int nby, int nbx, int span, int max_steps, int track_escape,
                  int has_threshold, float threshold, int blk, int frame_h,
                  int frame_w, int y_origin, int x_origin) {
  const size_t plane = (size_t)nby * nbx;
  const size_t b = (size_t)blockIdx.x * kThreads<D> + threadIdx.x;
  if (b >= plane) return;
  const int by = (int)(b / nbx), bx = (int)(b % nbx);
  const int k = 2 * span + 1;
  const int tl_y = y_origin + by * blk, tl_x = x_origin + bx * blk;
  const int bh = min(max(frame_h - tl_y, 0), blk);
  const int bw = min(max(frame_w - tl_x, 0), blk);
  const int count = bh * bw;

  const Ctx<T> x{span, max_steps, track_escape != 0, has_threshold != 0,
                 threshold, EarlyCut(threshold, count), traj, plane, b};
  Walk<T> w;
  x.record(w);
  if constexpr (D == 0)
    walk_rounds(vol, plane, b, span, k, w, x);
  else
    walk_trips<T, D>(vol, plane, b, span, k, w, x);
  if (traj != nullptr)  // the rounds after the walk ended hold its centre
    for (int t = w.t + 1; t <= max_steps; ++t)
      traj[(size_t)t * plane + b] = make_int2(w.cy, w.cx);
  const int fy = w.cy + w.sy, fx = w.cx + w.sx;
  mv_y[b] = fy;
  mv_x[b] = fx;
  if constexpr (kSsim<T>) {
    best_i32[b] = (fy + span) * k + (fx + span);
    score[b] = w.c;
  } else {
    best_i32[b] = w.c;
    score[b] = __fdiv_rn(__int2float_rn(w.c),
                         __int2float_rn(count > 1 ? count : 1));
  }
  escaped_out[b] = w.escaped;
}

// An empty kernel on a replay's grid: the floor of a launch (a template,
// so that a profiler names it as it names the replay).
template <int D>
__global__ void __launch_bounds__(kThreads<D>) empty_kernel() {}

// The instance for a plane of `blocks` blocks: D = kDepth below
// kRoundPlane, D = 0 from it. f<D>() is called with it.
template <typename F>
auto by_plane(size_t blocks, F f) {
  return blocks >= kRoundPlane ? f(std::integral_constant<int, 0>())
                               : f(std::integral_constant<int, kDepth>());
}

template <int D>
unsigned grid_of(size_t blocks) {
  return (unsigned)((blocks + kThreads<D> - 1) / kThreads<D>);
}

template <typename T>
int attributes(size_t blocks, int* out) {
  return by_plane(blocks, [&](auto d) {
    constexpr int D = decltype(d)::value;
    auto kernel = replay_kernel<T, D>;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    int resident = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, kernel, kThreads<D>, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    out[2] = D;
    out[3] = kThreads<D>;
    out[4] = resident;
    return 0;
  });
}

template <typename T>
void launch(const void* vol, int32_t* my, int32_t* mx, int32_t* bi,
            float* sc, uint8_t* esc, int2* tr, int nby, int nbx, int span,
            int max_steps, int track_escape, int has_threshold,
            float threshold, int blk, int frame_h, int frame_w, int y_origin,
            int x_origin, cudaStream_t s) {
  const size_t blocks = (size_t)nby * nbx;
  by_plane(blocks, [&](auto d) {
    constexpr int D = decltype(d)::value;
    replay_kernel<T, D><<<grid_of<D>(blocks), kThreads<D>, 0, s>>>(
        static_cast<const T*>(vol), my, mx, bi, sc, esc, tr, nby, nbx, span,
        max_steps, track_escape, has_threshold, threshold, blk, frame_h,
        frame_w, y_origin, x_origin);
    return 0;
  });
}

}  // namespace diamond
}  // namespace me

// is_float: 0 = int32 SSD/SAD volume, 1 = float32 SSIM volume. vol:
// [(2*span+1)^2][nby][nbx], contiguous. mv_y, mv_x, best_i32: int32
// [nby][nbx]; score: float32 [nby][nbx]; escaped: uint8 (bool) [nby][nbx];
// traj: null, or int32 [max_steps + 1][nby][nbx][2]. has_threshold = 0
// disables the early check. Returns the cudaError_t of the launch (0 on
// success). nby, nbx >= 1, span >= 0, max_steps >= 0, blk >= 1.
extern "C" int me_diamond_replay(const void* vol, void* mv_y, void* mv_x,
                                 void* best_i32, void* score, void* escaped,
                                 void* traj, int is_float, int nby, int nbx,
                                 int span, int max_steps, int track_escape,
                                 int has_threshold, float threshold, int blk,
                                 int frame_h, int frame_w, int y_origin,
                                 int x_origin, void* stream) {
  using namespace me::diamond;
  const size_t blocks = (size_t)nby * nbx;
  // A plane's bytes are a 32-bit stride in the neighbourhood's addresses.
  if (nby < 1 || nbx < 1 || span < 0 || max_steps < 0 || blk < 1 ||
      blocks * 4 > (size_t)INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = is_float ? launch<float> : launch<int32_t>;
  go(vol, static_cast<int32_t*>(mv_y), static_cast<int32_t*>(mv_x),
     static_cast<int32_t*>(best_i32), static_cast<float*>(score),
     static_cast<uint8_t*>(escaped), static_cast<int2*>(traj), nby, nbx, span,
     max_steps, track_escape, has_threshold, threshold, blk, frame_h, frame_w,
     y_origin, x_origin, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on the grid of a replay over nby x nbx blocks.
extern "C" int me_diamond_replay_empty(int nby, int nbx, void* stream) {
  using namespace me::diamond;
  if (nby < 1 || nbx < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t blocks = (size_t)nby * nbx;
  by_plane(blocks, [&](auto d) {
    constexpr int D = decltype(d)::value;
    empty_kernel<D><<<grid_of<D>(blocks), kThreads<D>, 0,
                      static_cast<cudaStream_t>(stream)>>>();
    return 0;
  });
  return static_cast<int>(cudaGetLastError());
}

// The resources of the instance a replay of is_float's volume over nby x
// nbx blocks launches: out[0] registers and out[1] local bytes (stack and
// spills) per thread, out[2] LDSP rounds a trip (D; 0: a round a load),
// out[3] threads a CUDA block, out[4] CUDA blocks resident per SM. Returns
// the cudaError_t (0 on success).
extern "C" int me_diamond_replay_attributes(int is_float, int nby, int nbx,
                                            int* out) {
  using namespace me::diamond;
  if (nby < 1 || nbx < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t blocks = (size_t)nby * nbx;
  return is_float ? attributes<float>(blocks, out)
                  : attributes<int32_t>(blocks, out);
}
