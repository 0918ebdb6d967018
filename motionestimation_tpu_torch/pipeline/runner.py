"""End-to-end frame-pair pipeline: upload -> search -> MV readback -> score.

Mirrors the reference GPU driver: both frames are copied to the card, the
fused search runs there, and only the MV field comes back; compensation,
PSNR and residual scores run on the host. The timing split is the
reference's machine-parsable `total h2d kernel d2h psnr` row, each phase
bracketed by CUDA events on the card (host clock on the CPU).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from motionestimation_tpu_torch.core import frames as frames_lib
from motionestimation_tpu_torch.core.config import SearchConfig
from motionestimation_tpu_torch.core.device import resolve_device, to_tensor
from motionestimation_tpu_torch.kernels.full_search_cuda import (
    full_search_frame_cuda,
)
from motionestimation_tpu_torch.kernels.ssim_cuda import ssim_search_frame_cuda
from motionestimation_tpu_torch.search.diamond import diamond_search_frame
from motionestimation_tpu_torch.search.full_search import MotionField


@dataclasses.dataclass
class PairResult:
    """Everything one frame pair produces."""

    field: MotionField  # numpy arrays, [nby, nbx]
    comp: np.ndarray  # [H, W] int32 motion-compensated frame
    psnr: float  # compensated vs current (observed-max rules)
    original_score: float  # residual MSE cur-vs-ref, C float32 accumulation
    compensated_score: float  # residual MSE cur-vs-comp
    total_ms: float
    h2d_ms: float
    kernel_ms: float
    d2h_ms: float

    @property
    def timing_row(self) -> str:
        """`total h2d kernel d2h psnr`."""
        return (
            f"{self.total_ms:.6f} {self.h2d_ms:.6f} {self.kernel_ms:.6f} "
            f"{self.d2h_ms:.6f} {self.psnr:.4f}"
        )


def _mark(device: torch.device):
    """A timing mark: a recorded CUDA event on the card, the host clock
    on the CPU."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def run_pair(
    cur: np.ndarray,
    ref: np.ndarray,
    config: SearchConfig,
    *,
    device=None,
) -> PairResult:
    """Run one frame pair end to end with a 4-phase timing split.

    h2d = both frames to the card; kernel = the search (and the int8 MV
    packing); d2h = the MV field back to the host. Compensation, PSNR and
    scores are untimed host post-processing. `device` defaults to "cuda".
    Full search runs `full_search_frame_cuda` (MSE, SAD) or
    `ssim_search_frame_cuda` (SSIM); diamond search runs
    `diamond_search_frame` with the config's `early_term` and
    `escape_policy`.
    """
    dev = resolve_device(device)
    on_card = torch.cuda.device(dev) if dev.type == "cuda" else None
    with on_card or contextlib.nullcontext():
        t0 = _mark(dev)
        cur_d = to_tensor(cur, dev)
        ref_d = to_tensor(ref, dev)
        t1 = _mark(dev)
        if config.algorithm == "diamond":
            field = diamond_search_frame(
                cur_d, ref_d, blk_dim=config.blk_dim, span=config.span,
                metric=config.metric, early_term=config.early_term,
                escape_policy=config.escape_policy, device=dev,
            )
        elif config.metric == "ssim":
            field = ssim_search_frame_cuda(
                cur_d, ref_d, blk_dim=config.blk_dim, span=config.span,
                device=dev,
            )
        else:
            field = full_search_frame_cuda(
                cur_d, ref_d, blk_dim=config.blk_dim, span=config.span,
                metric=config.metric, device=dev,
            )
        mv_dtype = torch.int8 if config.span <= 127 else torch.int32
        mv_d = torch.stack([field.mv_y, field.mv_x]).to(mv_dtype)
        t2 = _mark(dev)
        mv = mv_d.cpu().numpy()
        t3 = _mark(dev)
        if dev.type == "cuda":
            t3.synchronize()

    # Host post-processing (untimed, reference parity).
    mv_y = mv[0].astype(np.int32)
    mv_x = mv[1].astype(np.int32)
    host_field = MotionField(
        mv_y, mv_x, field.best_cost_i32.cpu().numpy(),
        field.score.cpu().numpy(),
    )
    comp = frames_lib.compensate_frame_np(ref, mv_y, mv_x, config.blk_dim)
    cur_i = np.asarray(cur).astype(np.int32)
    return PairResult(
        field=host_field,
        comp=comp,
        psnr=frames_lib.image_psnr(comp, cur_i),
        original_score=frames_lib.residual_mse_c_float32(cur, ref),
        compensated_score=frames_lib.residual_mse_c_float32(cur_i, comp),
        total_ms=_elapsed_ms(t0, t3),
        h2d_ms=_elapsed_ms(t0, t1),
        kernel_ms=_elapsed_ms(t1, t2),
        d2h_ms=_elapsed_ms(t2, t3),
    )


def write_artifacts(
    result: PairResult,
    cur: np.ndarray,
    ref: np.ndarray,
    config: SearchConfig,
    output_dir: str | os.PathLike,
) -> str:
    """Write the 5-frame stacked YUV; returns the path."""
    os.makedirs(output_dir, exist_ok=True)
    stack = frames_lib.stack_output(ref, cur, result.comp)
    path = frames_lib.output_filename(output_dir, config.blk_dim, config.span)
    frames_lib.save_yuv(path, stack)
    return path
