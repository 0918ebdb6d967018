"""Diamond search on the CUDA kernels of csrc/diamond.cu and
csrc/diamond_walk.cu.

`replay_cuda` launches `me_diamond_replay`, the counterpart of the jitted
XLA program `_diamond_replay` (motionestimation_tpu/search/diamond.py:259;
not a Pallas kernel): one CUDA thread walks one block's LDSP/SDSP
trajectory over a [K², nby, nbx] cost volume, several rounds from each
neighbourhood it loads, stops on its own and writes the whole MotionField,
so the replay issues its outputs' allocations and one launch and no host
sync, where the lockstep loop asks the card after every round whether any
block is still active. Beside it stands its plain PyTorch version,
`replay_plain`: the lockstep replay of every block in torch ops, which the
CPU runs. `search.diamond._replay` picks between them by the volume's
device.

`walk_cuda` launches `me_diamond_walk`, the counterpart of the jitted XLA
program `_diamond_lazy` (motionestimation_tpu/search/diamond.py:463): a
team of threads (one warp at blk <= 16, 128 threads at blk 17..64, 256
above; `walk_occupancy`) walks one block's trajectory and computes each
candidate it visits from the frames' pixels, so the lazy mode is one launch
with no volume, no replay and no host sync. Its plain version is
`search.diamond.lazy_plain` (golden planes and `replay_plain`, pass by
pass); `search.diamond._diamond_lazy` picks between them by the frames'
device.

Both wrappers raise on CPU tensors and count their launches in
`launches`; every launch here runs inside a `me.launch` span
(`core.trace`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from motionestimation_tpu_torch.core import geometry, trace
from motionestimation_tpu_torch.kernels import _build
from motionestimation_tpu_torch.metrics import cost as cost_lib
from motionestimation_tpu_torch.search.full_search import MotionField
from motionestimation_tpu_torch.search.patterns import LDSP, SDSP

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# vol, mv_y, mv_x, best_i32, score, escaped, traj; is_float, nby, nbx,
# span, max_steps, track_escape, has_threshold; threshold; blk, frame_h,
# frame_w, y_origin, x_origin; the stream.
_ARGTYPES = ([_PTR] * 7 + [_INT] * 7 + [ctypes.c_float] + [_INT] * 5
             + [_PTR])


# cur, ref, mv_y, mv_x, cost, traj; metric, frame_h, frame_w, blk, span,
# max_steps, has_threshold; threshold; the stream.
_WALK_ARGTYPES = [_PTR] * 6 + [_INT] * 7 + [ctypes.c_float, _PTR]
_WALK_METRIC = {"mse": 0, "sad": 1, "ssim": 2}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("diamond")
    lib.me_diamond_replay.argtypes = _ARGTYPES
    lib.me_diamond_replay.restype = ctypes.c_int
    lib.me_diamond_replay_empty.argtypes = [_INT, _INT, _PTR]
    lib.me_diamond_replay_empty.restype = ctypes.c_int
    lib.me_diamond_replay_attributes.argtypes = [_INT, _INT, _INT, _PTR]
    lib.me_diamond_replay_attributes.restype = ctypes.c_int
    return lib


@functools.cache
def _walk_lib() -> ctypes.CDLL:
    lib = _build.load("diamond_walk")
    lib.me_diamond_walk.argtypes = _WALK_ARGTYPES
    lib.me_diamond_walk.restype = ctypes.c_int
    lib.me_diamond_walk_occupancy.argtypes = [_INT, _INT, _PTR]
    lib.me_diamond_walk_occupancy.restype = ctypes.c_int
    return lib


def _field(cy, cx, ccost, *, metric, span, count):
    """The MotionField of final centres and costs: the mean per pixel for
    MSE/SAD (over `count` pixels a block), the flat displacement index and
    the score for SSIM (`count` unused)."""
    if metric in ("mse", "sad"):
        mean = (cost_lib.mse_from_ssd if metric == "mse"
                else cost_lib.mad_from_sad)(ccost, count)
        return MotionField(cy, cx, ccost, mean)
    k = 2 * span + 1
    return MotionField(cy, cx, (cy + span) * k + (cx + span), ccost)


def replay_cuda(volume, *, blk_dim: int, span: int, metric: str, early_term,
                max_steps: int, record_trajectory: bool, frame_height: int,
                frame_width: int, track_escape: bool = False,
                y_origin: int = 0, x_origin: int = 0):
    """`me_diamond_replay` over a contiguous CUDA volume: int32 [K², nby,
    nbx] with INT32_MAX at invalid candidates for MSE/SAD, float32 with
    -inf for SSIM, K = 2 * span + 1. Arguments and results as
    `replay_plain`'s: (field, trajectory or None, escaped); the kernel
    writes every field. The outputs' allocations and one launch, no host
    sync."""
    if volume.device.type != "cuda":
        raise ValueError(
            f"replay_cuda runs on CUDA tensors, got {volume.device} (the "
            f"plain version is replay_plain)")
    minimise = metric in ("mse", "sad")
    if metric not in ("mse", "sad", "ssim"):
        raise ValueError(f"unknown metric {metric!r}")
    want = torch.int32 if minimise else torch.float32
    k = 2 * span + 1
    if (volume.dim() != 3 or volume.shape[0] != k * k
            or volume.dtype != want or not volume.is_contiguous()):
        raise ValueError(
            f"replay_cuda takes a contiguous {want} [{k * k}, nby, nbx] "
            f"volume for {metric} at span {span}, got {volume.dtype} "
            f"{tuple(volume.shape)} strides {volume.stride()}")
    _, nby, nbx = volume.shape
    dev = volume.device
    cy = torch.empty((nby, nbx), dtype=torch.int32, device=dev)
    cx = torch.empty((nby, nbx), dtype=torch.int32, device=dev)
    best = torch.empty((nby, nbx), dtype=torch.int32, device=dev)
    score = torch.empty((nby, nbx), dtype=torch.float32, device=dev)
    escaped = torch.empty((nby, nbx), dtype=torch.bool, device=dev)
    traj = (torch.empty((max_steps + 1, nby, nbx, 2), dtype=torch.int32,
                        device=dev) if record_trajectory else None)
    if nby and nbx:
        launcher = _lib().me_diamond_replay
        with trace.span("me.launch"), torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = launcher(
                volume.data_ptr(), cy.data_ptr(), cx.data_ptr(),
                best.data_ptr(), score.data_ptr(), escaped.data_ptr(),
                traj.data_ptr() if traj is not None else None,
                int(not minimise), nby, nbx, span, max_steps,
                int(track_escape), int(early_term is not None),
                0.0 if early_term is None else float(early_term), blk_dim,
                frame_height, frame_width, y_origin, x_origin, stream)
        if err:
            raise RuntimeError(f"me_diamond_replay launch failed: CUDA error "
                               f"{err}")
        replay_cuda.launches += 1
    return MotionField(cy, cx, best, score), traj, escaped


replay_cuda.launches = 0


def replay_empty(nby: int, nbx: int, device=None) -> None:
    """Launch an empty kernel on the grid of a replay over nby x nbx blocks
    (the floor of a launch, for timing beside `replay_cuda`; not counted).
    Needs a card."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    launcher = _lib().me_diamond_replay_empty
    with trace.span("me.launch"), torch.cuda.device(dev):
        err = launcher(
            nby, nbx, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"me_diamond_replay_empty failed: CUDA error "
                           f"{err}")


def replay_attributes(metric: str, nby: int, nbx: int) -> dict:
    """The resources of the `me_diamond_replay` instance that `replay_cuda`
    launches for `metric` over nby x nbx blocks on the current card:
    registers and local bytes (stack and spills) per thread, the LDSP
    rounds a trip (`depth`: the neighbourhood's L1 radius is twice it; 0
    for a round a load, the instance of large planes), threads a CUDA
    block and CUDA blocks resident per SM. Needs a card."""
    if metric not in ("mse", "sad", "ssim"):
        raise ValueError(f"unknown metric {metric!r}")
    out = (ctypes.c_int * 5)()
    err = _lib().me_diamond_replay_attributes(int(metric == "ssim"), nby,
                                              nbx, out)
    if err:
        raise RuntimeError(f"me_diamond_replay_attributes failed: CUDA "
                           f"error {err}")
    regs, local, depth, threads, blocks = out
    return dict(registers=regs, local_bytes=local, depth=depth,
                threads=threads, blocks_per_sm=blocks,
                warps_per_sm=blocks * threads // 32)


def walk_cuda(cur, ref, *, blk_dim: int, span: int, metric: str, early_term,
              max_steps: int, record_trajectory: bool):
    """`me_diamond_walk` on contiguous uint8 CUDA frames [H, W]: the lazy
    mode's result, (field, trajectory or None) as
    `search.diamond.lazy_plain` gives it, the trajectory int32 [max_steps +
    1, nby, nbx, 2]. One launch, no volume, no host sync."""
    if cur.device.type != "cuda" or ref.device != cur.device:
        raise ValueError(
            f"walk_cuda runs on CUDA tensors of one card, got {cur.device} "
            f"and {ref.device} (the plain version is "
            f"search.diamond.lazy_plain)")
    if metric not in _WALK_METRIC:
        raise ValueError(f"unknown metric {metric!r}")
    for name, t in (("cur", cur), ("ref", ref)):
        if (t.dtype != torch.uint8 or t.dim() != 2
                or not t.is_contiguous()):
            raise ValueError(
                f"walk_cuda takes contiguous uint8 [H, W] frames, got {name} "
                f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
    if cur.shape != ref.shape:
        raise ValueError(f"frames differ in shape: {tuple(cur.shape)} vs "
                         f"{tuple(ref.shape)}")
    if blk_dim < 1 or span < 0 or max_steps < 0:
        raise ValueError(f"walk_cuda takes blk_dim >= 1, span >= 0 and "
                         f"max_steps >= 0, got {blk_dim}, {span}, "
                         f"{max_steps}")
    frame_height, frame_width = cur.shape
    nby, nbx = -(-frame_height // blk_dim), -(-frame_width // blk_dim)
    dev = cur.device
    minimise = metric in ("mse", "sad")
    cy = torch.empty((nby, nbx), dtype=torch.int32, device=dev)
    cx = torch.empty_like(cy)
    ccost = torch.empty((nby, nbx), dtype=torch.int32 if minimise
                        else torch.float32, device=dev)
    traj = (torch.empty((max_steps + 1, nby, nbx, 2), dtype=torch.int32,
                        device=dev) if record_trajectory else None)
    if nby and nbx:
        launcher = _walk_lib().me_diamond_walk
        with trace.span("me.launch"), torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = launcher(
                cur.data_ptr(), ref.data_ptr(), cy.data_ptr(), cx.data_ptr(),
                ccost.data_ptr(),
                traj.data_ptr() if traj is not None else None,
                _WALK_METRIC[metric], frame_height, frame_width, blk_dim,
                span, max_steps, int(early_term is not None),
                0.0 if early_term is None else float(early_term), stream)
        if err:
            raise RuntimeError(f"me_diamond_walk launch failed: CUDA error "
                               f"{err}")
        walk_cuda.launches += 1
    count = None
    if minimise:
        _, _, blk_h, blk_w = geometry.block_extents(
            0, 0, nby, nbx, blk_dim, frame_height, frame_width, dev)
        count = blk_h * blk_w
    return _field(cy, cx, ccost, metric=metric, span=span, count=count), traj


walk_cuda.launches = 0


def walk_occupancy(blk_dim: int, metric: str) -> dict:
    """The resources of the `me_diamond_walk` instance that `walk_cuda`
    launches at `blk_dim` and `metric` on the current card: registers and
    local (spill) bytes per thread, threads a walk (the team), walks a CUDA
    block, and the CUDA blocks, warps and walks resident per SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`). Needs a card."""
    if metric not in _WALK_METRIC or blk_dim < 1:
        raise ValueError(f"no walk kernel for blk_dim={blk_dim} "
                         f"metric={metric!r}")
    out = (ctypes.c_int * 5)()
    err = _walk_lib().me_diamond_walk_occupancy(_WALK_METRIC[metric],
                                                blk_dim, out)
    if err:
        raise RuntimeError(f"me_diamond_walk_occupancy failed: CUDA error "
                           f"{err}")
    regs, local, team, walks, blocks = out
    return dict(registers=regs, local_bytes=local, team_threads=team,
                walks_per_block=walks, blocks_per_sm=blocks,
                warps_per_sm=blocks * team * walks // 32,
                walks_per_sm=blocks * walks)


def replay_plain(volume, *, blk_dim: int, span: int, metric: str,
                 early_term, max_steps: int, record_trajectory: bool,
                 frame_height: int, frame_width: int,
                 track_escape: bool = False, y_origin: int = 0,
                 x_origin: int = 0):
    """Replay the canonical trajectories over a [K², nby, nbx] volume (int32
    with INT32_MAX, or float32 SSIM scores with -inf, at invalid
    candidates), every block in lockstep: the port of `_diamond_replay`
    (diamond.py:259) in torch ops, and `me_diamond_replay`'s plain
    version. The volume's blocks are those of a tile at global (y_origin,
    x_origin), the whole frame by default; the origin sets their pixel
    counts.

    With `track_escape`, `span` is the radius of a volume cropped below the
    search window (a staged level): the third result marks the blocks whose
    trajectory could reach past it, a centre beyond span - 2 while active
    or beyond span - 1 at SDSP. Up to that event the trajectory is exact.

    Returns (field, trajectory or None, escaped); the trajectory is int32
    [max_steps + 1, nby, nbx, 2], the centre after each LDSP round, frozen
    once no block is active.
    """
    kk, nby, nbx = volume.shape
    dev = volume.device
    minimise = metric in ("mse", "sad")
    k = 2 * span + 1
    _, _, blk_h, blk_w = geometry.block_extents(
        y_origin, x_origin, nby, nbx, blk_dim, frame_height, frame_width, dev
    )
    count = blk_h * blk_w
    sentinel = cost_lib.INT32_MAX if minimise else float("-inf")
    planes = volume.view(kk, nby * nbx)
    threshold = (None if early_term is None else
                 torch.tensor(early_term, dtype=torch.float32, device=dev))

    def offsets(pattern):
        """(oy, ox) of the pattern's non-centre offsets, [n, 1, 1] each, and
        the [n + 1] tables that decode a winner (0: the centre)."""
        offs = [o for o in pattern if o != (0, 0)]
        t = torch.tensor([(0, 0)] + offs, dtype=torch.int32, device=dev)
        return t[1:, 0, None, None], t[1:, 1, None, None], t[:, 0], t[:, 1]

    ldsp, sdsp = offsets(LDSP), offsets(SDSP)

    def pattern_step(cy, cx, ccost, pattern):
        """The winning offset and cost per block; (0, 0) and ccost when no
        candidate beats the centre. The centre comes first and the
        candidates in pattern order, and argmin/argmax return the first
        extremum: strict comparisons, first in order winning ties."""
        oy, ox, table_y, table_x = pattern
        ty, tx = cy + oy, cx + ox
        ok = (ty.abs() <= span) & (tx.abs() <= span)
        flat = torch.where(ok, (ty + span) * k + (tx + span), 0)
        cand = planes.gather(0, flat.view(len(oy), -1).long())
        cand = cand.view(len(oy), nby, nbx).masked_fill(~ok, sentinel)
        costs = torch.cat([ccost[None], cand])
        win = costs.argmin(0) if minimise else costs.argmax(0)
        return (table_y[win], table_x[win],
                costs.gather(0, win[None])[0])

    def early_mask(ccost):
        if threshold is None:
            return torch.zeros(ccost.shape, dtype=torch.bool, device=dev)
        if minimise:
            per_px = ccost.to(torch.float32) / count.clamp(min=1).to(
                torch.float32)
            return per_px <= threshold
        return ccost >= threshold

    def chebyshev(cy, cx):
        return torch.maximum(cy.abs(), cx.abs())

    cy = torch.zeros((nby, nbx), dtype=torch.int32, device=dev)
    cx = torch.zeros_like(cy)
    ccost = volume[span * k + span].clone()
    active = torch.ones((nby, nbx), dtype=torch.bool, device=dev)
    terminated = torch.zeros_like(active)
    escaped = torch.zeros_like(active)
    trajs = [torch.stack([cy, cx], -1)] if record_trajectory else None
    for t in range(max_steps):
        if not bool(active.any()):  # every block converged or terminated
            break
        hit = early_mask(ccost) & active
        terminated |= hit
        active &= ~hit
        if track_escape:
            escaped |= active & (chebyshev(cy, cx) > span - 2)
        wy, wx, wc = pattern_step(cy, cx, ccost, ldsp)
        moved = active & ((wy != 0) | (wx != 0))
        active = moved
        cy = torch.where(moved, cy + wy, cy)
        cx = torch.where(moved, cx + wx, cx)
        ccost = torch.where(moved, wc, ccost)
        if record_trajectory:
            trajs.append(torch.stack([cy, cx], -1))
    traj = None
    if record_trajectory:
        trajs += [trajs[-1]] * (max_steps + 1 - len(trajs))
        traj = torch.stack(trajs)

    # The post-loop early check mirrors the golden model's final state.
    terminated |= early_mask(ccost)
    wy, wx, wc = pattern_step(cy, cx, ccost, sdsp)
    apply_sdsp = ~terminated
    if track_escape:
        escaped |= apply_sdsp & (chebyshev(cy, cx) > span - 1)
    cy = torch.where(apply_sdsp, cy + wy, cy)
    cx = torch.where(apply_sdsp, cx + wx, cx)
    ccost = torch.where(apply_sdsp, wc, ccost)
    field = _field(cy, cx, ccost, metric=metric, span=span, count=count)
    return field, traj, escaped
