"""Versioned benchmark runner: `python -m motionestimation_tpu_torch.bench`.

The port of `python -m motionestimation_tpu.bench`, which mirrors the
reference harness CLI (its src/gpu/run.sh:12-32):

    python -m motionestimation_tpu_torch.bench -v 2 -b 8 -s 12 \\
        --frames-dir DIR [--results-dir results/h100/sequences] \\
        [--device cuda] [--metric mse]

Runs the reference's three benchmark sequences — Foreman CIF (F4 against
F1, from --frames-dir, which is required: the bench reads no default path)
and Jockey/Beauty 4K (their F2 against F1 where the
frames directory has both, else deterministic synthetic 4K stand-ins,
seeded from the name) — through `run_pair`, keeps the best of --repeats
rows by search time, writes one `total h2d kernel d2h psnr` row per
sequence to `<results-dir>/v{N}.txt` in the JAX package's layout, and
epsilon-compares against v{N-1} (run.sh:74-96): timings worse by >0.1 ms or
PSNR worse by >0.5 dB are reported as regressions (exit code 1). On the
card each row also prints, on stdout only, the search kernels' device ms,
the search minus the kernels, and the launches per frame, from one more
`run_pair` under `torch.profiler`.

`--matrix` runs `bench/matrix.py` instead. The two modes keep their
version series apart: the rows go to results/h100/sequences and the
matrix to results/h100 unless --results-dir names another directory.
`--device cuda` (the default) raises where CUDA is absent; `--device cpu`
runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import os
import sys
import zlib

import numpy as np

from motionestimation_tpu_torch.bench import measure, regression
from motionestimation_tpu_torch.core import frames as frames_lib
from motionestimation_tpu_torch.core.config import SearchConfig
from motionestimation_tpu_torch.core.device import resolve_device
from motionestimation_tpu_torch.pipeline import runner

SEQUENCE_RESULTS = os.path.join("results", "h100", "sequences")
MATRIX_RESULTS = os.path.join("results", "h100")
SEQUENCES = ("Foreman", "Jockey", "Beauty")


def sequence_seed(name: str) -> int:
    """The synthetic stand-in's seed: CRC-32 of the name, the same in every
    process (`hash` of a str is not)."""
    return zlib.crc32(name.encode())


def _synthetic_4k(name: str):
    """Deterministic 4K stand-in for a stripped sequence: smooth random
    reference, globally shifted + noisy current (the JAX arithmetic)."""
    rng = np.random.default_rng(sequence_seed(name))
    h, w = 2160, 3840
    small = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2)).astype(
        np.float64
    )
    ref = np.clip(
        np.kron(small, np.ones((16, 16)))[:h, :w]
        + rng.normal(0, 3, (h, w)),
        0, 255,
    ).astype(np.uint8)
    cur = np.clip(
        np.roll(ref, (4, -6), (0, 1)).astype(np.int32)
        + rng.integers(-5, 6, (h, w)),
        0, 255,
    ).astype(np.uint8)
    return cur, ref


def load_sequence(name: str, frames_dir: str):
    """(cur, ref, h, w) for a benchmark sequence."""
    if name == "Foreman":
        cur = frames_lib.load_yuv(
            os.path.join(frames_dir, "ForemanYF4.yuv"), 288, 352
        )
        ref = frames_lib.load_yuv(
            os.path.join(frames_dir, "ForemanYF1.yuv"), 288, 352
        )
        return cur, ref, 288, 352
    f2 = os.path.join(frames_dir, f"{name}YF2.yuv")
    f1 = os.path.join(frames_dir, f"{name}YF1.yuv")
    if os.path.exists(f2) and os.path.exists(f1):
        cur = frames_lib.load_yuv(f2, 2160, 3840)
        ref = frames_lib.load_yuv(f1, 2160, 3840)
    else:
        cur, ref = _synthetic_4k(name)
    return cur, ref, 2160, 3840


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="motionestimation_tpu_torch.bench")
    p.add_argument("-v", "--version", type=int, required=True)
    p.add_argument(
        "--matrix", action="store_true",
        help="record the kernel matrix (bench/matrix.py: full search, "
        "diamond, SSIM and GOP rows) as <results-dir>/v{N}.txt with "
        "tag-wise epsilon comparison instead of the per-sequence rows",
    )
    p.add_argument("-b", "--blk-dim", type=int, default=8)
    p.add_argument("-s", "--span", type=int, default=12)
    p.add_argument(
        "--metric", choices=("mse", "sad", "ssim"), default="mse"
    )
    p.add_argument(
        "--algorithm", choices=("full", "diamond"), default="full",
        help="search algorithm (diamond = LDSP/SDSP, BASELINE config 3)",
    )
    p.add_argument(
        "--size", choices=("native", "1080p"), default="native",
        help="1080p crops the 4K sequences to 1920x1080 (config 3)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (default; raises without CUDA) or cpu (the kernels' "
        "plain versions)",
    )
    p.add_argument(
        "--results-dir",
        help=f"where v{{N}}.txt goes (default: {SEQUENCE_RESULTS}, or "
        f"{MATRIX_RESULTS} with --matrix)",
    )
    p.add_argument(
        "--frames-dir", required=True,
        help="directory of ForemanYF1/YF4.yuv (and ForemanYF2.yuv for the "
        "matrix's config1) and, where present, the Jockey and Beauty "
        "YF1/YF2.yuv",
    )
    p.add_argument(
        "--sequences", nargs="+", default=list(SEQUENCES),
        choices=SEQUENCES,
    )
    p.add_argument("--repeats", type=int, default=3,
                   help="timed repeats per sequence; best row is recorded")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.matrix:
        from motionestimation_tpu_torch.bench.matrix import run_matrix

        return run_matrix(args.version, args.results_dir or MATRIX_RESULTS,
                          frames_dir=args.frames_dir, device=dev)
    results_dir = args.results_dir or SEQUENCE_RESULTS

    rows = []
    for name in args.sequences:
        print(f"Running on {name}...")
        cur, ref, h, w = load_sequence(name, args.frames_dir)
        if args.size == "1080p" and (h, w) == (2160, 3840):
            h, w = 1080, 1920
            cur, ref = cur[:h, :w], ref[:h, :w]
        config = SearchConfig(
            blk_dim=args.blk_dim, span=args.span, metric=args.metric,
            algorithm=args.algorithm,
            frame_width=w, frame_height=h,
        )
        best = None
        for _ in range(max(1, args.repeats)):
            res = runner.run_pair(cur, ref, config, device=dev)
            if best is None or res.kernel_ms < best.kernel_ms:
                best = res
        rows.append(
            (
                name,
                (
                    best.total_ms, best.h2d_ms, best.kernel_ms,
                    best.d2h_ms, best.psnr,
                ),
            )
        )
        print(f"  {rows[-1][1][2]:.3f} ms kernel, PSNR {best.psnr:.4f}")
        if dev.type == "cuda":
            prof = measure.profile_pass(
                lambda: runner.run_pair(cur, ref, config, device=dev), 1, dev)
            print(f"  search kernels {prof.kernel_ms:.4f} ms on the card, "
                  f"search minus kernels {best.kernel_ms - prof.kernel_ms:.4f}"
                  f" ms, launches per frame {prof.launches} (one run_pair "
                  f"under torch.profiler) | {measure.card()}")
        else:
            print("  search kernels: none on the CPU (the plain versions "
                  "ran); device ms not measured")

    header = (
        f"[ Version= {args.version}, BlkDim= {args.blk_dim}, "
        f"ExtraSpan={args.span}, Metric= {args.metric}"
        + (f", Algorithm= {args.algorithm}" if args.algorithm != "full"
           else "")
        + (f", Size= {args.size}" if args.size != "native" else "")
        + " ]"
    )
    path = regression.write_results(
        results_dir, args.version, header, rows
    )
    print(f"Results -> {path}")

    regs = regression.compare_versions(
        results_dir, args.version, [r[0] for r in rows]
    )
    for name in {r.sequence for r in regs}:
        print(f"Regression Testing: {name}")
    for r in regs:
        print(f"  {r}")
    return 1 if regs else 0


if __name__ == "__main__":
    sys.exit(main())
