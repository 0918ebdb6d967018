"""Diamond search's trajectory replay on the CUDA kernel of csrc/diamond.cu.

`replay_cuda` launches `me_diamond_replay`, the counterpart of the jitted
XLA program `_diamond_replay` (motionestimation_tpu/search/diamond.py:259;
not a Pallas kernel): one CUDA thread walks one block's LDSP/SDSP
trajectory over a [K², nby, nbx] cost volume and stops on its own, so the
replay issues one launch and no host sync, where the lockstep loop asks the
card after every round whether any block is still active.

Beside it stands its plain PyTorch version, `replay_plain`: the lockstep
replay of every block in torch ops, which the CPU runs.
`search.diamond._replay` picks between them by the volume's device;
`replay_cuda` raises on a CPU tensor. The wrapper counts its launches in
`launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from motionestimation_tpu_torch.core import geometry
from motionestimation_tpu_torch.kernels import _build
from motionestimation_tpu_torch.metrics import cost as cost_lib
from motionestimation_tpu_torch.search.full_search import MotionField
from motionestimation_tpu_torch.search.patterns import LDSP, SDSP

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# vol, mv_y, mv_x, cost, escaped, traj; is_float, nby, nbx, span,
# max_steps, track_escape, has_threshold; threshold; blk, frame_h,
# frame_w, y_origin, x_origin; the stream.
_ARGTYPES = ([_PTR] * 6 + [_INT] * 7 + [ctypes.c_float] + [_INT] * 5
             + [_PTR])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("diamond")
    lib.me_diamond_replay.argtypes = _ARGTYPES
    lib.me_diamond_replay.restype = ctypes.c_int
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
    `replay_plain`'s: (field, trajectory or None, escaped). One launch, no
    host sync."""
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
    cx = torch.empty_like(cy)
    ccost = torch.empty((nby, nbx), dtype=want, device=dev)
    escaped = torch.empty((nby, nbx), dtype=torch.bool, device=dev)
    traj = (torch.empty((max_steps + 1, nby, nbx, 2), dtype=torch.int32,
                        device=dev) if record_trajectory else None)
    if nby and nbx:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib().me_diamond_replay(
                volume.data_ptr(), cy.data_ptr(), cx.data_ptr(),
                ccost.data_ptr(), escaped.data_ptr(),
                traj.data_ptr() if traj is not None else None,
                int(not minimise), nby, nbx, span, max_steps,
                int(track_escape), int(early_term is not None),
                0.0 if early_term is None else float(early_term), blk_dim,
                frame_height, frame_width, y_origin, x_origin, stream)
        if err:
            raise RuntimeError(f"me_diamond_replay launch failed: CUDA error "
                               f"{err}")
        replay_cuda.launches += 1
    count = None
    if minimise:  # the kernel counts its pixels itself; the mean needs them
        _, _, blk_h, blk_w = geometry.block_extents(
            y_origin, x_origin, nby, nbx, blk_dim, frame_height, frame_width,
            dev)
        count = blk_h * blk_w
    field = _field(cy, cx, ccost, metric=metric, span=span, count=count)
    return field, traj, escaped


replay_cuda.launches = 0


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
