"""Command-line driver, argv-compatible with the reference binaries.

    python -m motionestimation_tpu_torch.cli <current> <reference> <outdir> \
        [blkDim] [extraSpan] [frameWidth] [frameHeight] [--device cuda|cpu]

Stdout mirrors the reference binaries: the config echo block, then for
MSE/SAD `PSNR: %.6f`, the output dimensions, `Computation time: %.0f ms`
and `PSNR: %.0f `; for `--metric ssim` `Original Score: %.4f, Compensated
Score: %.4f` and the output dimensions. `--timing-row` adds
`total h2d kernel d2h psnr`. The run uses the CUDA card unless
`--device cpu` is given; without CUDA the default raises. Options of the
JAX command line that later slices of the port bring (`--algorithm diamond`,
`--gop`, `--debug-block`, `--profile`) raise NotImplementedError naming
their ROADMAP.md item.
"""
from __future__ import annotations

import argparse
import sys

from motionestimation_tpu_torch.core import frames as frames_lib
from motionestimation_tpu_torch.core.config import SearchConfig
from motionestimation_tpu_torch.core.device import resolve_device
from motionestimation_tpu_torch.pipeline import runner

_LATER = {
    "gop": "--gop arrives with ROADMAP.md Queue 1 item 8 (GOP pipeline)",
    "debug_block": (
        "--debug-block needs the cost volume, which arrives with ROADMAP.md "
        "Queue 1 item 6 (cost volumes and K5-K7)"
    ),
    "profile": (
        "--profile arrives with ROADMAP.md Queue 1 item 10 (main-path bench "
        "and tracing)"
    ),
}


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
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--gop", nargs="+", metavar="FRAME", default=None)
    p.add_argument("--no-output", action="store_true")
    p.add_argument("--timing-row", action="store_true")
    p.add_argument("--profile", metavar="DIR", default=None)
    p.add_argument(
        "--debug-block", nargs=2, type=int, metavar=("BY", "BX"), default=None
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.algorithm == "diamond":
        raise NotImplementedError(runner.DIAMOND_SLICE)
    for opt, message in _LATER.items():
        if getattr(args, opt) is not None:
            raise NotImplementedError(message)
    device = resolve_device(args.device)
    config = SearchConfig(
        blk_dim=args.blk_dim,
        span=args.span,
        metric=args.metric,
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

    cur = frames_lib.load_yuv(
        args.current, config.frame_height, config.frame_width
    )
    ref = frames_lib.load_yuv(
        args.reference, config.frame_height, config.frame_width
    )
    res = runner.run_pair(cur, ref, config, device=device)

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
