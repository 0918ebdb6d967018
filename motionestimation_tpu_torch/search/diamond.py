"""Diamond search (LDSP/SDSP) block matching.

The port of `motionestimation_tpu.search.diamond`. Its semantics are the
JAX package's canonical ones, pinned there by the numpy model
`diamond_search_np`: geometry, costs and validity as in full search (exact
int32 SSD/SAD compared with strict `<`, the float32 SSIM score with strict
`>`); per block, from the centre (0, 0), LDSP rounds over

    (-2,0) (-1,-1) (-1,1) (0,-2) (0,0) (0,2) (1,-1) (1,1) (2,0)

(out-of-window candidates skipped, first in order wins ties) until the
centre wins or `max_steps` rounds (default span + 2) have run; an early
check before each round and once after the loop (per-pixel cost <=
`early_term` for MSE/SAD, score >= `early_term` for SSIM, in float32)
stops the block, SDSP included; otherwise one SDSP step over

    (-1,0) (0,-1) (0,0) (0,1) (1,0)

gives the MV.

The "staged" and "full" modes replay the trajectories over a [K², nby,
nbx] volume of candidate costs (`_replay`) at the flat index (cy + oy +
span) * K + (cx + ox + span), with every target outside the window masked
to the sentinel (a horizontal step past the window edge would alias into
the next dy row). On the card one launch of `me_diamond_replay` walks every
block's trajectory (`kernels/diamond_cuda.replay_cuda`); on the CPU
`replay_plain` replays all blocks in lockstep, one `torch.gather` per
pattern step. The volume comes from:

* "staged": the kernels' emit modes at radius 6, then the full span only
  if some block's trajectory could leave the first level
  (`_staged_levels`, `_diamond_staged`);
* "full": the whole volume up front.

"lazy" (`_diamond_lazy`) builds no volume on the card: one launch of
`me_diamond_walk` (`kernels/diamond_cuda.walk_cuda`) walks every block and
computes each candidate it visits from the frames' pixels. Its plain
version, which the CPU runs, is `lazy_plain`: the golden
`make_displacement_cost` for the planes near the trajectories only, pass
by pass, each pass replayed by `replay_plain`.

All three give the same MVs, costs and trajectories. The JAX package's
`lax.cond` around a round becomes each block's own stop in the kernel (a
host branch on whether any block is still active in the plain replay); its
`lax.cond` around an escalation, a host branch on whether any block
escaped a level. `diamond_search_tile` runs the staged path on one mesh
shard's tile, its level volumes from the kernels' tile entries.

On the card a staged level runs eagerly the first time its frame shape
and configuration come, and from a CUDA graph, captured the second time,
every time after that (`_graph_level`): after each host wait on the
escape mask the card has the next level in one launch.

Spans (`core.trace`): `me.search` around a `diamond_search_frame` call,
`me.level` around each staged level (its volume and replay), and
`me.escape_wait` around each host wait on a level's escape mask. Counters:
`diamond_search_frame.calls`, and `_diamond_staged.levels`, the staged
levels run.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from motionestimation_tpu_torch.core import trace
from motionestimation_tpu_torch.core.device import resolve_device, to_tensor
from motionestimation_tpu_torch.kernels import diamond_cuda as dc
from motionestimation_tpu_torch.kernels import full_search_cuda as fsc
from motionestimation_tpu_torch.kernels import ssim_cuda as sc
from motionestimation_tpu_torch.metrics import cost as cost_lib
from motionestimation_tpu_torch.search import full_search as fs
from motionestimation_tpu_torch.search.full_search import MotionField
from motionestimation_tpu_torch.search.patterns import LDSP, SDSP


def default_max_steps(span: int) -> int:
    return span + 2


@functools.lru_cache(maxsize=64)
def _round_plan(span: int, max_steps: int):
    """Static fill/lookup schedule shared by every block (the JAX package's
    `_round_plan`, with the same tuples).

    The possible centres after t LDSP rounds are data-independent:
    R_0 = {(0,0)}, R_{t+1} = clamp(R_t ⊕ LDSP). Round t can only look up
    displacements in R_{t+1} (LDSP around centres in R_t) and, for blocks
    that converge this round, SDSP around centres in R_{t+1}.

    Returns (need_lists, radii, sdsp_radius):
      need_lists[t]: sorted flat displacement indices any round-t lookup
        (LDSP now, SDSP later) could touch, cumulative since
        R_t ⊆ R_{t+1};
      radii[t]: Chebyshev radius bounding every round-t lookup;
      sdsp_radius: radius bounding the post-loop SDSP lookups.
    """
    k = 2 * span + 1

    def clamped(ps):
        return {
            (y, x) for (y, x) in ps if abs(y) <= span and abs(x) <= span
        }

    def flat(p):
        return (p[0] + span) * k + (p[1] + span)

    reach = {(0, 0)}
    need_lists, radii = [], []
    for _ in range(max_steps):
        r_c = max((max(abs(y), abs(x)) for y, x in reach), default=0)
        radii.append(min(r_c + 2, span))
        nxt = clamped(
            {(y + oy, x + ox) for (y, x) in reach for oy, ox in LDSP}
        )
        need = nxt | clamped(
            {(y + oy, x + ox) for (y, x) in nxt for oy, ox in SDSP}
        )
        need_lists.append(tuple(sorted(flat(p) for p in need)))
        reach = nxt
    sdsp_radius = min(
        max((max(abs(y), abs(x)) for y, x in reach), default=0) + 1, span
    )
    return tuple(need_lists), tuple(radii), sdsp_radius


def _staged_levels(span: int) -> tuple[int, ...]:
    """Volume radii to try in order (the JAX package's `_staged_levels`): a
    candidate level r in 6, 12, 24, ... below the span is kept iff
    (2r+1)² <= 0.3 (2·span+1)², so the worst case (every level computed)
    stays <= 1.4x the full volume; the full span comes last. Span 15 gives
    (6, 15); span <= 10 the span alone."""
    full = (2 * span + 1) ** 2
    levels = []
    r = 6
    while r < span:
        if (2 * r + 1) ** 2 <= 0.3 * full:
            levels.append(r)
        r *= 2
    levels.append(span)
    return tuple(levels)


def staged_supported(blk_dim: int, span: int, metric: str) -> bool:
    """Whether the staged path covers this config: span >= 2 and the level
    volumes come from the kernels' emit modes (`volume_supported` for
    MSE/SAD, `ssim_supported` for SSIM)."""
    if span < 2:
        return False
    if metric == "ssim":
        return sc.ssim_supported(blk_dim, span)
    return fsc.volume_supported(blk_dim, span, metric)


def _replay(volume, **kw):
    """Replay the canonical trajectories over a [K², nby, nbx] volume (the
    port of `_diamond_replay`, diamond.py:259; arguments and results as
    `diamond_cuda.replay_plain`'s): `me_diamond_replay` on a CUDA volume,
    the plain lockstep replay on a CPU volume."""
    if volume.device.type == "cuda":
        return dc.replay_cuda(volume, **kw)
    return dc.replay_plain(volume, **kw)


def _near(mask, radius: int):
    """The [k, k] bool mask of the displacements within Chebyshev `radius`
    of a True entry of `mask` (numpy)."""
    k = mask.shape[0]
    padded = np.pad(mask, radius)
    out = np.zeros_like(mask)
    for dy in range(2 * radius + 1):
        for dx in range(2 * radius + 1):
            out |= padded[dy : dy + k, dx : dx + k]
    return out


def _diamond_lazy(cur, ref, **kw):
    """Lazy mode (the counterpart of `_diamond_lazy`, diamond.py:463): on
    CUDA frames one launch of `me_diamond_walk` (`diamond_cuda.walk_cuda`),
    which evaluates each block's candidates along its trajectory from the
    frames' pixels, with no volume, no replay and no host sync; on CPU
    frames its plain version `lazy_plain`. CUDA frames arrive as
    contiguous uint8 (`diamond_search_frame` makes them so). Returns
    (field, trajectory or None)."""
    if cur.device.type == "cuda":
        return dc.walk_cuda(cur, ref, **kw)
    return lazy_plain(cur, ref, **kw)


def lazy_plain(cur, ref, *, blk_dim: int, span: int, metric: str,
               early_term, max_steps: int, record_trajectory: bool):
    """`me_diamond_walk`'s plain version, on frames on any device: only the
    planes near the trajectories are evaluated, by the golden
    `make_displacement_cost` (every metric and block size), into a [K²,
    nby, nbx] volume whose other planes hold the sentinel, which never
    wins a comparison. Each pass replays that volume (`replay_plain`, on
    the card too), then fills the planes within Chebyshev distance 3 (the
    LDSP reach plus the SDSP step) of any centre its trajectories visited
    and within `max_steps` rounds' reach (`_round_plan`). A pass after which
    none was missing read only filled planes: it is the replay over the
    whole golden volume. Each pass takes every unfinished trajectory at
    least one round further. JAX's lazy mode makes the same pick before
    every round under `lax.cond`; here it costs one host sync a pass.
    Returns (field, trajectory or None)."""
    frame_height, frame_width = cur.shape
    cur_p = fs.pad_cur_frame(cur, frame_height, frame_width, blk_dim)
    ref_halo = fs.make_ref_halo(ref, frame_height, frame_width, blk_dim, span)
    nby, nbx = cur_p.shape[0] // blk_dim, cur_p.shape[1] // blk_dim
    dev = cur_p.device
    k = 2 * span + 1
    disp_cost = fs.make_displacement_cost(
        cur_p, ref_halo, 0, 0, frame_height=frame_height,
        frame_width=frame_width, blk_dim=blk_dim, span=span, metric=metric,
    )
    if metric == "ssim":
        volume = torch.full((k * k, nby, nbx), float("-inf"),
                            dtype=torch.float32, device=dev)
    else:
        volume = torch.full((k * k, nby, nbx), cost_lib.INT32_MAX,
                            dtype=torch.int32, device=dev)
    _, radii, sdsp_radius = _round_plan(span, max_steps)
    d = np.abs(np.arange(-span, span + 1))
    in_reach = np.maximum.outer(d, d) <= max(radii + (sdsp_radius,))
    filled = np.zeros((k, k), dtype=bool)
    visited = np.zeros((k, k), dtype=bool)
    visited[span, span] = True
    while True:
        need = _near(visited, 3) & in_reach & ~filled
        if not need.any():
            break
        for idx in np.flatnonzero(need):
            volume[idx] = disp_cost(int(idx))
        filled |= need
        field, traj, _ = dc.replay_plain(
            volume, blk_dim=blk_dim, span=span, metric=metric,
            early_term=early_term, max_steps=max_steps,
            record_trajectory=True, frame_height=frame_height,
            frame_width=frame_width,
        )
        hit = torch.zeros(k * k, dtype=torch.bool, device=dev)
        hit[((traj[..., 0] + span) * k + traj[..., 1] + span).flatten()
            .long()] = True
        visited = hit.view(k, k).cpu().numpy()
    return field, traj if record_trajectory else None


def _merge(esc, new: MotionField, old: MotionField) -> MotionField:
    """`new` where `esc`, else `old`, field by field."""
    return MotionField(*(torch.where(esc, a, b) for a, b in zip(new, old)))


def _any_escaped(esc) -> bool:
    """Whether any block escaped a level: the host waits on the card for
    the escape mask here."""
    with trace.span("me.escape_wait"):
        return bool(esc.any())


def _level(cur, ref, r: int, *, blk_dim: int, span: int, metric: str,
           early_term, max_steps: int, record_trajectory: bool):
    """One staged level: the radius-r volume and its replay, (field,
    trajectory or None, escaped)."""
    frame_height, frame_width = cur.shape
    if metric == "ssim":
        volume = sc.ssim_volume_cuda(cur, ref, blk_dim=blk_dim, span=r,
                                     device=cur.device)
    else:
        volume = fsc.full_search_volume_cuda(cur, ref, blk_dim=blk_dim,
                                             span=r, metric=metric,
                                             device=cur.device)
    return _replay(volume, blk_dim=blk_dim, span=r, metric=metric,
                   early_term=early_term, max_steps=max_steps,
                   record_trajectory=record_trajectory,
                   frame_height=frame_height, frame_width=frame_width,
                   track_escape=r < span)


# Staged levels on the card, replayed from CUDA graphs. Between levels the
# host waits on the escape mask, and the card idles until the host has
# issued the next level: ~15 operations and three launches through Python
# as eager calls, one graph launch as a replay. Per frame shape, stream and
# host thread (two threads on one stream must not share input buffers):
# the uint8 input buffers every graph of that shape reads, a memory pool
# its graphs share and the capture stream. The pool is safe to share: the
# graphs' outputs stay allocated, so no later capture takes their memory,
# and a call reads its graphs' outputs before it returns. Per level and
# configuration: the graph, its outputs and the kernel launches its
# capture counted.
_graph_inputs: dict = {}
_level_graphs: dict = {}


def _launch_counters():
    """(wrapper, attribute) of every kernel launch counter a level can
    move."""
    return [(fn, name) for module in (fsc, sc, dc)
            for fn in vars(module).values() if callable(fn)
            for name in ("launches", "volume_launches", "ring_launches")
            if isinstance(getattr(fn, name, None), int)]


def _graph_frames(cur, ref):
    """The input buffers of this frame shape on the current stream and
    thread, holding (cur, ref) as uint8 once the copies issued here have
    run."""
    stream = torch.cuda.current_stream(cur.device)
    key = (cur.device, stream.cuda_stream, threading.get_ident(),
           tuple(cur.shape))
    if key not in _graph_inputs:
        _graph_inputs[key] = (
            torch.empty(cur.shape, dtype=torch.uint8, device=cur.device),
            torch.empty(cur.shape, dtype=torch.uint8, device=cur.device),
            torch.cuda.graph_pool_handle(), torch.cuda.Stream(cur.device))
    cur_in, ref_in, _, _ = _graph_inputs[key]
    cur_in.copy_(fsc.as_u8(cur))
    ref_in.copy_(fsc.as_u8(ref))
    return key


def _graph_level(key, r: int, kw: dict):
    """Level r on the input buffers of `key`: eager the first time, so that
    a search made once captures nothing; captured the second time and
    replayed from then on. A replay adds to the launch counters what the
    capture counted, so they read as eager calls'. Returns the level's
    outputs; a replay's are the graph's own tensors, which its next replay
    overwrites."""
    cur_in, ref_in, pool, stream = _graph_inputs[key]
    lkey = (key, r, tuple(sorted(kw.items())))
    if lkey not in _level_graphs:
        _level_graphs[lkey] = None
        return _level(cur_in, ref_in, r, **kw)
    if _level_graphs[lkey] is None:
        counters = _launch_counters()
        before = [getattr(fn, name) for fn, name in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(cur_in.device), torch.cuda.graph(
                graph, pool=pool, stream=stream,
                capture_error_mode="thread_local"):
            outputs = _level(cur_in, ref_in, r, **kw)
        counts = []
        for (fn, name), n in zip(counters, before):
            if getattr(fn, name) != n:
                counts.append((fn, name, getattr(fn, name) - n))
                setattr(fn, name, n)
        _level_graphs[lkey] = (graph, outputs, counts)
    graph, outputs, counts = _level_graphs[lkey]
    with trace.span("me.launch"):
        graph.replay()
    for fn, name, n in counts:
        setattr(fn, name, getattr(fn, name) + n)
    return outputs


def _staged_search(cur, ref, *, blk_dim: int, span: int, metric: str,
                   early_term, max_steps: int, record_trajectory: bool,
                   escape_policy: str = "canonical"):
    """`_diamond_staged` up to the crossover's full search: (field,
    trajectory or None, escaped), where `escaped` is the mask of the blocks
    that are still to take the full-search optimum under "crossover", else
    None. Each level (its volume and replay) is a `me.level` span, counted
    in `_diamond_staged.levels`; on CUDA frames a level from its second
    call on is a CUDA graph's replay (`_graph_level`)."""
    if escape_policy not in ("canonical", "crossover"):
        raise ValueError(f"unknown escape_policy {escape_policy!r}")
    if escape_policy == "crossover" and (
        record_trajectory or metric == "ssim"
    ):
        raise ValueError(
            "escape_policy='crossover' supports MSE/SAD without "
            "trajectory recording (escaped blocks take the full-search "
            "argmin, which has no diamond trajectory)"
        )
    levels = _staged_levels(span)
    kw = dict(blk_dim=blk_dim, span=span, metric=metric,
              early_term=early_term, max_steps=max_steps,
              record_trajectory=record_trajectory)
    graphs = (cur.device.type == "cuda"
              and not torch.cuda.is_current_stream_capturing())
    if graphs:
        key = _graph_frames(cur, ref)

    def run_level(r):
        with trace.span("me.level"):
            _diamond_staged.levels += 1
            if graphs:
                return _graph_level(key, r, kw)
            return _level(cur, ref, r, **kw)

    field, traj, esc = run_level(levels[0])
    if graphs:
        # A later level's outputs are merged into new tensors; the first
        # level's may be a graph's own, which the next call overwrites.
        field = MotionField(*(t.clone() for t in field))
        traj = None if traj is None else traj.clone()
    if escape_policy == "crossover":
        if len(levels) > 1 and _any_escaped(esc):
            return field, traj, esc
        return field, traj, None
    for r in levels[1:]:
        if not _any_escaped(esc):
            break
        f2, t2, e2 = run_level(r)
        field = _merge(esc, f2, field)
        if record_trajectory:
            traj = torch.where(esc[None, :, :, None], t2, traj)
        esc = esc & e2
    if metric == "ssim":
        # Level volumes index flat displacements by their own radius; the
        # other paths index by the search span.
        k = 2 * span + 1
        field = field._replace(
            best_cost_i32=(field.mv_y + span) * k + (field.mv_x + span))
    return field, traj, None


def _crossover(cur, ref, esc, field, *, blk_dim: int, span: int,
               metric: str) -> MotionField:
    """`field` with the blocks of `esc` taking the full-search optimum
    (`full_search_frame_cuda` on CUDA frames, a search call of its own)."""
    if cur.device.type == "cuda":
        best = fsc.full_search_frame_cuda(
            cur, ref, blk_dim=blk_dim, span=span, metric=metric,
            device=cur.device,
        )
    else:
        best = fs.full_search_frame(cur, ref, blk_dim=blk_dim, span=span,
                                    metric=metric)
    return _merge(esc, best, field)


def _diamond_staged(cur, ref, *, blk_dim: int, span: int, metric: str,
                    early_term, max_steps: int, record_trajectory: bool,
                    escape_policy: str = "canonical"):
    """Staged level volumes (the port of `_diamond_staged`, diamond.py:893).

    Level r is the radius-r volume from the kernels' emit modes
    (`full_search_volume_cuda`, `ssim_volume_cuda`; their plain versions
    for CPU tensors), replayed with escape tracking. A block's costs do not
    depend on the window's radius, so blocks that never approach the cap
    are exact. escape_policy "canonical" recomputes escaped blocks at the
    next level (skipped when none escaped; the last level is the full
    span, where none can escape); "crossover" (MSE/SAD, no trajectory)
    gives every block that escaped the first level the full-search optimum
    instead. Returns (field, trajectory or None). The levels run are
    counted in `_diamond_staged.levels`.
    """
    field, traj, esc = _staged_search(
        cur, ref, blk_dim=blk_dim, span=span, metric=metric,
        early_term=early_term, max_steps=max_steps,
        record_trajectory=record_trajectory, escape_policy=escape_policy)
    if esc is not None:
        field = _crossover(cur, ref, esc, field, blk_dim=blk_dim, span=span,
                           metric=metric)
    return field, traj


_diamond_staged.levels = 0


def _counted(fn):
    """`fn`, its calls counted in the attribute `calls` of what it returns
    (a closure, so a caller that replaces the module's name still counts)."""
    @functools.wraps(fn)
    def counted(*args, **kwargs):
        counted.calls += 1
        return fn(*args, **kwargs)

    counted.calls = 0
    return counted


@_counted
def diamond_search_frame(
    cur,
    ref,
    *,
    blk_dim: int,
    span: int,
    metric: str = "mse",
    early_term: float | None = None,
    max_steps: int | None = None,
    record_trajectory: bool = False,
    volume_mode: str = "auto",
    escape_policy: str = "canonical",
    device=None,
):
    """Whole-frame diamond search (the port of `diamond_search_frame`,
    diamond.py:688). cur/ref: [H, W] integer frames (numpy or torch), moved
    to `device` (default "cuda"; "cpu" runs the plain versions of the
    kernels). The lazy mode on the card reads the frames as bytes: pixels
    outside [0, 255] and floating frames raise there, and an integer frame
    other than uint8 costs a host sync for its range check before the
    lazy mode starts.

    volume_mode:
      "auto" / "staged": the staged level volumes where `staged_supported`,
        else "lazy". "auto" takes "lazy" for SSIM on the CPU, where the
        volume is the golden full-plane scan (more planes than lazy's), as
        the JAX package does off the TPU.
      "lazy": no volume: on the card one `me_diamond_walk` launch
        computes each candidate along the trajectories from the pixels
        (on the CPU `lazy_plain`: the golden planes near the
        trajectories, pass by pass); every metric, block size and span.
      "full": the whole [K², nby, nbx] volume up front (the kernels' emit
        modes where they cover the config, else the golden volume).
    All modes give the same MVs, costs and trajectories.

    escape_policy: "canonical" (default; exact in every mode) or
    "crossover" (staged MSE/SAD only: blocks escaping the first level take
    the full-search optimum, a deviation from the canonical endpoint).

    Returns a MotionField (tensors on `device`), or (MotionField,
    trajectory) with `record_trajectory`: int32 [max_steps + 1, nby, nbx,
    2], equal to `diamond_search_np`'s.

    A call is one `me.search` span (`core.trace`), counted in
    `diamond_search_frame.calls`; under "crossover" the full search of
    the escaped blocks follows it as a search call of its own.
    """
    if tuple(cur.shape) != tuple(ref.shape):
        raise ValueError(
            f"current and reference frames must have identical shapes, "
            f"got {tuple(cur.shape)} vs {tuple(ref.shape)}"
        )
    if metric not in ("mse", "sad", "ssim"):
        raise ValueError(f"unknown metric {metric!r}")
    if volume_mode not in ("auto", "staged", "lazy", "full"):
        raise ValueError(f"unknown volume_mode {volume_mode!r}")
    if max_steps is None:
        max_steps = default_max_steps(span)
    if escape_policy == "crossover" and (
        volume_mode not in ("auto", "staged")
        or not staged_supported(blk_dim, span, metric)
        or metric == "ssim"
    ):
        raise ValueError(
            "escape_policy='crossover' requires the staged MSE/SAD fast "
            f"path (volume_mode auto/staged; blk_dim={blk_dim}, "
            f"span={span}, metric={metric!r} not covered)"
        )
    with trace.span("me.search"):
        dev = resolve_device(device)
        cur_t, ref_t = to_tensor(cur, dev), to_tensor(ref, dev)
        kw = dict(blk_dim=blk_dim, span=span, metric=metric,
                  early_term=early_term, max_steps=max_steps,
                  record_trajectory=record_trajectory)
        esc = None
        if volume_mode in ("auto", "staged"):
            use_staged = staged_supported(blk_dim, span, metric)
            if metric == "ssim" and volume_mode == "auto":
                use_staged = use_staged and dev.type == "cuda"
            if use_staged:
                field, traj, esc = _staged_search(
                    cur_t, ref_t, escape_policy=escape_policy, **kw)
            else:
                volume_mode = "lazy"
        if volume_mode == "lazy":
            if dev.type == "cuda":
                cur_t, ref_t = (fsc.as_u8(t).contiguous()
                                for t in (cur_t, ref_t))
            field, traj = _diamond_lazy(cur_t, ref_t, **kw)
        elif volume_mode == "full":
            if metric == "ssim" and sc.ssim_supported(blk_dim, span):
                volume = sc.ssim_volume_cuda(cur_t, ref_t, blk_dim=blk_dim,
                                             span=span, device=dev)
            elif fsc.volume_supported(blk_dim, span, metric):
                volume = fsc.full_search_volume_cuda(
                    cur_t, ref_t, blk_dim=blk_dim, span=span, metric=metric,
                    device=dev,
                )
            else:
                _, volume = fs.full_search_frame(
                    cur_t, ref_t, blk_dim=blk_dim, span=span, metric=metric,
                    return_cost_volume=True,
                )
            frame_height, frame_width = cur_t.shape
            field, traj, _ = _replay(volume, frame_height=frame_height,
                                     frame_width=frame_width, **kw)
    if esc is not None:
        # The crossover's full search is a whole-frame search call with its
        # own `me.search`, so it runs after this call's span has closed.
        field = _crossover(cur_t, ref_t, esc, field, blk_dim=blk_dim,
                           span=span, metric=metric)
    if record_trajectory:
        return field, traj
    return field


def diamond_search_tile(cur_tile, ref_halo, y_origin: int, x_origin: int, *,
                        frame_height: int, frame_width: int, blk_dim: int,
                        span: int, metric: str = "mse",
                        early_term: float | None = None,
                        max_steps: int | None = None,
                        record_trajectory: bool = False,
                        use_kernels: bool = True):
    """Staged diamond search over one mesh shard's tile (the port of
    `diamond_search_tile`, diamond.py:1037).

    cur_tile: [th, tw], whole blocks, global pixel (y_origin, x_origin) at
    [0, 0]; ref_halo: [th + 2*span, tw + 2*span] from
    `parallel.halo.halo_exchange_2d` (diamond candidates reach at most
    +-span, so the full-search halo serves). Level r of `_staged_levels`
    is the radius-r volume of the halo sliced to radius r: the tile volume
    entries `full_search_volume_tile_cuda` / `ssim_volume_tile_cuda` with
    `use_kernels` (the kernels' emit modes; their plain versions for CPU
    tensors), else the golden `full_search_tile` volume. Each level is
    replayed at the tile's origin with the global frame size; blocks that
    could escape it are recomputed at the next level, decided per tile. A
    block's costs do not depend on the level, so a tile's choice never
    changes a result: sharded == unsharded == `diamond_search_np`.

    Returns (mv_y, mv_x, cost[, trajectory]): int32 SSD/SAD or the float32
    SSIM score, [th // blk, tw // blk]; the trajectory as
    `diamond_search_frame`'s.
    """
    tile_h, tile_w = cur_tile.shape
    if tile_h % blk_dim or tile_w % blk_dim:
        raise ValueError(
            f"tile dims must be multiples of blk_dim, got {tile_h}x{tile_w}")
    if metric not in ("mse", "sad", "ssim"):
        raise ValueError(f"unknown metric {metric!r}")
    if max_steps is None:
        max_steps = default_max_steps(span)
    where = dict(frame_height=frame_height, frame_width=frame_width)

    def level_volume(r):
        s0 = span - r
        rh = ref_halo[s0 : s0 + tile_h + 2 * r, s0 : s0 + tile_w + 2 * r]
        if not use_kernels:
            _, vol = fs.full_search_tile(
                cur_tile, rh, y_origin, x_origin, blk_dim=blk_dim, span=r,
                metric=metric, return_cost_volume=True, **where)
            return vol
        if metric == "ssim":
            return sc.ssim_volume_tile_cuda(
                cur_tile, rh, y_origin, x_origin, blk_dim=blk_dim, span=r,
                **where)
        return fsc.full_search_volume_tile_cuda(
            cur_tile, rh, y_origin, x_origin, blk_dim=blk_dim, span=r,
            metric=metric, **where)

    def run_level(r):
        return _replay(
            level_volume(r), blk_dim=blk_dim, span=r, metric=metric,
            early_term=early_term, max_steps=max_steps,
            record_trajectory=record_trajectory, track_escape=r < span,
            y_origin=y_origin, x_origin=x_origin, **where)

    levels = _staged_levels(span)
    field, traj, esc = run_level(levels[0])
    for r in levels[1:]:
        if not bool(esc.any()):
            break
        f2, t2, e2 = run_level(r)
        field = _merge(esc, f2, field)
        if record_trajectory:
            traj = torch.where(esc[None, :, :, None], t2, traj)
        esc = esc & e2
    out = (field.mv_y, field.mv_x,
           field.score if metric == "ssim" else field.best_cost_i32)
    return (*out, traj) if record_trajectory else out
