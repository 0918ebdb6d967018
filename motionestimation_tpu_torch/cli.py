"""Command-line driver, argv-compatible with the reference binaries.

    python -m motionestimation_tpu_torch.cli <current> <reference> <outdir> \
        [blkDim] [extraSpan] [frameWidth] [frameHeight] [--device cuda|cpu] \
        [--metric mse|sad|ssim] [--algorithm full|diamond] \
        [--early-term THRESH] [--escape-policy canonical|crossover] \
        [--gop F1 F2 ...] [--profile DIR]

Stdout mirrors the reference binaries: the config echo block, then for
MSE/SAD `PSNR: %.6f`, the output dimensions, `Computation time: %.0f ms`
and `PSNR: %.0f `; for `--metric ssim` `Original Score: %.4f, Compensated
Score: %.4f` and the output dimensions. `--timing-row` adds
`total h2d kernel d2h psnr`. `--debug-block BY BX` prints one block's
cost surface and winner as `[debug]` lines, from the golden search's cost
volume. `--algorithm diamond` runs diamond search with `--early-term` and
`--escape-policy`, as the JAX command line does. `--gop F1 F2 ...`
processes the frames pairwise with `runner.run_gop` (one `mv_%05d.npz`
per pair in the output directory, existing dumps skipped) and prints
`GOP: N frame pairs -> DIR`. `--profile DIR` records the pair run with
`torch.profiler` (CUDA activity on the card) and writes a Chrome trace
into DIR; it holds the program's spans (`core.trace`): a full or SSIM
frame search as `me.search` around `me.operands`, `me.edges` and
`me.decode`, each kernel launch as `me.launch`, and `me.kernel_load`
where a kernel library is built or opened. The run uses the CUDA card
unless `--device cpu` is given; without CUDA the default raises.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch

from motionestimation_tpu_torch.core import frames as frames_lib
from motionestimation_tpu_torch.core.config import SearchConfig
from motionestimation_tpu_torch.core.device import resolve_device, to_tensor
from motionestimation_tpu_torch.pipeline import runner
from motionestimation_tpu_torch.search import full_search as fs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="motionestimation_tpu_torch",
        description="Block-matching motion estimation on PyTorch and CUDA",
    )
    p.add_argument("current", help="current frame (raw YUV luma)")
    p.add_argument("reference", help="reference frame (raw YUV luma)")
    p.add_argument("output_dir", help="directory for output artifacts")
    p.add_argument("blk_dim", nargs="?", type=int, default=8)
    p.add_argument("span", nargs="?", type=int, default=12)
    p.add_argument("frame_width", nargs="?", type=int, default=352)
    p.add_argument("frame_height", nargs="?", type=int, default=288)
    p.add_argument("--metric", choices=("mse", "sad", "ssim"), default="mse")
    p.add_argument(
        "--algorithm", choices=("full", "diamond"), default="full"
    )
    p.add_argument(
        "--escape-policy", choices=("canonical", "crossover"),
        default="canonical",
        help="diamond staged-escalation policy: 'canonical' keeps exact "
        "diamond trajectories; 'crossover' gives blocks that escape the "
        "first level the full-search optimum (a flagged deviation)",
    )
    p.add_argument(
        "--early-term", type=float, default=None, metavar="THRESH",
        help="diamond early-termination threshold: stop a block's search "
        "once its mean cost beats THRESH (MSE/SAD <=, SSIM >=)",
    )
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--gop", nargs="+", metavar="FRAME", default=None,
                   help="process a frame sequence pairwise")
    p.add_argument("--no-output", action="store_true")
    p.add_argument("--timing-row", action="store_true")
    p.add_argument(
        "--profile", metavar="DIR", default=None,
        help="record the pair run with torch.profiler and write a Chrome "
        "trace, with the program's me.* spans, into DIR",
    )
    p.add_argument(
        "--debug-block", nargs=2, type=int, metavar=("BY", "BX"), default=None
    )
    return p


def _print_debug_block(cur, ref, config: SearchConfig, by: int, bx: int,
                       device):
    """Dump the probe block's full cost surface and winner, from the golden
    search's cost volume on `device` (the JAX CLI's `_print_debug_block`,
    after the reference's -DDEBUG probe printfs)."""
    field, volume = fs.full_search_frame(
        to_tensor(cur, device), to_tensor(ref, device),
        blk_dim=config.blk_dim, span=config.span, metric=config.metric,
        return_cost_volume=True,
    )
    k = 2 * config.span + 1
    surface = volume[:, by, bx].reshape(k, k).cpu().numpy()
    print(f"[debug] block ({by},{bx}) cost surface ({config.metric}):")
    for dy in range(k):
        row = " ".join(f"{surface[dy, dx]:10.2f}" for dx in range(k))
        print(f"[debug]   dy={dy - config.span:+3d}: {row}")
    print(
        f"[debug] best mv=({int(field.mv_y[by, bx])},"
        f"{int(field.mv_x[by, bx])}) "
        f"score={float(field.score[by, bx]):.6f}"
    )


@contextlib.contextmanager
def _profiled(trace_dir, device):
    """Record the block with `torch.profiler` (CPU, and CUDA on the card)
    and write its Chrome trace into `trace_dir`; nothing when None."""
    if trace_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "run_pair.trace.json"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    config = SearchConfig(
        blk_dim=args.blk_dim,
        span=args.span,
        metric=args.metric,
        algorithm=args.algorithm,
        early_term=args.early_term,
        escape_policy=args.escape_policy,
        frame_width=args.frame_width,
        frame_height=args.frame_height,
    )

    print("[")
    print(f"  Current Frame: {args.current}")
    print(f"  Reference Frame: {args.reference}")
    print(f"  Output Dir: {args.output_dir}")
    print(f"  BlkDim: {config.blk_dim}")
    print(f"  ExtraSpan: {config.span}")
    print(f"  FrameWidth: {config.frame_width}")
    print(f"  FrameHeight: {config.frame_height}")
    print("]")

    if args.gop:
        dumps = runner.run_gop(
            args.gop, config, output_dir=args.output_dir, device=device,
        )
        print(f"GOP: {len(dumps)} frame pairs -> {args.output_dir}")
        return 0

    cur = frames_lib.load_yuv(
        args.current, config.frame_height, config.frame_width
    )
    ref = frames_lib.load_yuv(
        args.reference, config.frame_height, config.frame_width
    )
    with _profiled(args.profile, device):
        res = runner.run_pair(cur, ref, config, device=device)
    if args.debug_block:
        _print_debug_block(cur, ref, config, *args.debug_block, device)

    ssim = config.metric == "ssim"
    if ssim:
        print(
            f"Original Score: {res.original_score:.4f}, "
            f"Compensated Score: {res.compensated_score:.4f}"
        )
    else:
        print(f"PSNR: {res.psnr:.6f}")
    if not args.no_output:
        runner.write_artifacts(res, cur, ref, config, args.output_dir)
        print(
            f"Output file dimensions: ({config.frame_width} x "
            f"{5 * config.frame_height})"
        )
    if not ssim:
        print(f"Computation time: {res.kernel_ms:.0f} ms")
        print(f"PSNR: {res.psnr:.0f} ")
    if args.timing_row:
        print(res.timing_row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
