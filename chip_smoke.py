#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--runs N]

Run from the root of a checkout. Phases, each of which raises on failure:

1. Set-up: the card's name and power limit, the torch / CUDA / nvcc
   versions, and the build of every kernel under
   motionestimation_tpu_torch/kernels/csrc (one nvcc per source, all
   started together).
2. Byte-exact CLI runs against the C reference's fixtures: MSE (Foreman
   8x8 +-12 both ways, the truncated rand_mse_90x70_32_8) and SSIM
   (`--metric ssim`: Foreman 16x16 +-7 and 4x4 +-15, the truncated
   rand_ssim_45x33_4_5 and rand_ssim_52x36_8_7).
3. The main paths at full size, each with every launch count set to 0
   just before it and read just after: `cli.main --device cuda` at
   3840x2160 8x8 +-12 and 1920x1080 16x16 +-15 (MSE), then with
   `--metric ssim` at 3840x2160 16x16 +-7 and 1920x1080 16x16 +-15, on
   frames made from --seed. Each stacked output is checked against one
   built from the plain golden search on the card.
4. Each kernel against its plain PyTorch version on the card at full size
   (tolerance: exact equality of every int32 cost and index, and of every
   float32 SSIM score: kernel and plain version round each step alike).
5. Timing with CUDA events: `run_pair` (median of --runs runs after
   warm-up) at 4K 8x8 +-12, 1080p 16x16 +-15 and 4K 16x16 +-15 (MSE) and
   4K 16x16 +-7, 1080p 16x16 +-15 and 4K 32x32 +-7 (SSIM), and each
   kernel's own time beside its plain version's.
6. One JSON line listing the kernels, the nvidia-smi name/power-limit line,
   and as the last line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without CUDA or outside a checkout.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
CSRC = "motionestimation_tpu_torch/kernels/csrc/"
SOURCE = {
    "me_phase_search": CSRC + "full_search.cu",
    "me_int_search": CSRC + "full_search.cu",
    "me_ssim_fast_search": CSRC + "ssim.cu",
    "me_ssim_search": CSRC + "ssim.cu",
}
REPLACES = {
    "me_phase_search": "motionestimation_tpu/kernels/full_search_pallas.py:729",
    "me_int_search": "motionestimation_tpu/kernels/full_search_pallas.py:1076",
    "me_ssim_fast_search": "motionestimation_tpu/kernels/ssim_pallas.py:214",
    "me_ssim_search": "motionestimation_tpu/kernels/ssim_pallas.py:48",
}
# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, int8 ops/s, and
# float32 outside the tensor cores.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP32_OPS_S = 67e12
# Float operations of one SSIM score with the current block's terms
# hoisted (metrics/cost.py ssim_from_sums): the reference mean (1), its
# centred variance (8), the clamp and root (2), the cross-variance (1),
# luminance (8), contrast (8), structure (4) and the product (2).
SSIM_FLOPS = 34
# (label, height, width, blk, span)
CONFIGS = [
    ("4K 8x8 +-12", 2160, 3840, 8, 12),
    ("1080p 16x16 +-15", 1080, 1920, 16, 15),
    ("4K 16x16 +-15", 2160, 3840, 16, 15),
]
SSIM_CONFIGS = [
    ("4K 16x16 +-7 ssim", 2160, 3840, 16, 7),
    ("1080p 16x16 +-15 ssim", 1080, 1920, 16, 15),
    ("4K 32x32 +-7 ssim", 2160, 3840, 32, 7),
]
# (height, width, blk, span): the int kernel alone on a frame whose bottom
# and right block rows are both truncated.
EDGE_CASE = (700, 1000, 32, 8)


def fail(message: str):
    raise RuntimeError(f"chip_smoke: {message}")


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def synthetic_pair(h, w, seed):
    """A reference frame and a current frame moved by (3, -5) plus noise."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = np.roll(ref, (3, -5), (0, 1)).astype(np.int32)
    cur += rng.integers(-6, 7, (h, w))
    return np.clip(cur, 0, 255).astype(np.uint8), ref


def run_cli(cli, argv):
    """cli.main(argv); returns its stdout, which is also echoed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    print(buf.getvalue(), end="")
    if rc != 0:
        fail(f"cli.main returned {rc}")
    return buf.getvalue()


def cuda_ms(fn, n):
    """Mean device time of fn() over n calls, bracketed by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def valid_candidates(h, w, blk, span, tile, origin):
    """(pixel-candidates, block-candidates) a search of the tile's blocks
    needs: for each block, (valid dy) x (valid dx), times its in-frame
    pixels for the first."""
    (th, tw), (y0, x0) = tile, origin

    def axis(n, start, frame):
        tl = start + np.arange(-(-n // blk)) * blk
        ext = np.clip(frame - tl, 0, blk)
        lo = np.maximum(-span, -tl)
        hi = np.minimum(span, frame - ext - tl)
        return np.maximum(hi - lo + 1, 0), ext

    ny, ey = axis(th, y0, h)
    nx, ex = axis(tw, x0, w)
    return (int((ny * ey).sum()) * int((nx * ex).sum()),
            int(ny.sum()) * int(nx.sum()))


def bound(h, w, blk, span, tile, origin, ssim=False):
    """(bound_ms, bound_by): the largest of bytes read once / written once
    over the HBM rate, 2 integer ops (subtract or product, accumulate) per
    pixel-candidate over the int8 peak and, for SSIM, SSIM_FLOPS per
    block-candidate over the float32 rate."""
    th, tw = tile
    nby, nbx = -(-th // blk), -(-tw // blk)
    nbytes = th * tw + (th + 2 * span) * (tw + 2 * span) + 2 * 4 * nby * nbx
    pixel_cands, block_cands = valid_candidates(h, w, blk, span, tile, origin)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = max(2 * pixel_cands / INT8_OPS_S * 1e3,
                SSIM_FLOPS * block_cands / FP32_OPS_S * 1e3 if ssim else 0.0)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_stack(out_dir, cur, ref, field, blk, span, label, frames_lib):
    """The CLI's stacked output vs one built from `field` (the plain golden
    search's), byte for byte."""
    comp = frames_lib.compensate_frame_np(
        ref, field.mv_y.cpu().numpy(), field.mv_x.cpu().numpy(), blk)
    want = frames_lib.stack_output(ref, cur, comp).astype(np.uint8)
    got = np.fromfile(frames_lib.output_filename(out_dir, blk, span), np.uint8)
    if got.tobytes() != want.tobytes():
        fail(f"{label}: main-path stack differs from the plain search")
    return comp


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--runs", type=int, default=20)
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from motionestimation_tpu_torch import cli
    from motionestimation_tpu_torch.core import frames as frames_lib
    from motionestimation_tpu_torch.core.config import SearchConfig
    from motionestimation_tpu_torch.kernels import _build
    from motionestimation_tpu_torch.kernels import full_search_cuda as kc
    from motionestimation_tpu_torch.kernels import ssim_cuda as sc
    from motionestimation_tpu_torch.pipeline import runner
    from motionestimation_tpu_torch.search import full_search as fs

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    max_clock_mhz = float(smi("clocks.max.sm").split()[0])
    nvcc_version = subprocess.run(
        [_build.nvcc(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    print(f"== set-up: {card} | {props.multi_processor_count} SMs, max SM "
          f"clock {max_clock_mhz:.0f} MHz | python {sys.version.split()[0]} "
          f"torch {torch.__version__} CUDA {torch.version.cuda} | {nvcc_version}")
    t0 = time.perf_counter()
    built = _build.build()
    for name, (seconds, log) in built.items():
        print(f"built csrc/{name}.cu in {seconds:.1f} s")
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print("  " + line.strip())
    print(f"build phase {time.perf_counter() - t0:.1f} s")
    counters = {"me_phase_search": kc.phase_search,
                "me_int_search": kc.int_search,
                "me_ssim_fast_search": sc.ssim_fast_search,
                "me_ssim_search": sc.ssim_search}
    mse_kernels = ("me_phase_search", "me_int_search")
    ssim_kernels = ("me_ssim_fast_search", "me_ssim_search")

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts(names, what):
        counts = {n: counters[n].launches for n in names}
        print(f"{what} launches: {counts}")
        if not all(v > 0 for v in counts.values()):
            fail(f"{what}: a kernel never launched: {counts}")
        return counts

    def fixture_frames(name, work):
        d = os.path.join(FIXTURES, name)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        h, w = meta["height"], meta["width"]
        golden = np.fromfile(os.path.join(d, "output.yuv"), np.uint8)
        cur_path, ref_path = (os.path.join(d, meta[k]) for k in ("cur", "ref"))
        if not os.path.exists(cur_path):  # Foreman: F4/F1 from the planes
            planes = golden.reshape(5, h, w)
            cur_path = os.path.join(work, f"{name}_cur.yuv")
            ref_path = os.path.join(work, f"{name}_ref.yuv")
            planes[1].tofile(cur_path)
            planes[0].tofile(ref_path)
        with open(os.path.join(d, "stdout.txt")) as f:
            stdout = f.read()
        return meta, golden, cur_path, ref_path, stdout

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as work:
        # -- 2. byte-exact CLI runs against the C reference's outputs ------
        print("== byte-exact CLI runs vs the C reference fixtures")
        reset_counts()
        for name, psnr in (("foreman_mse_8_12", "31.816000"),
                           ("foreman_mse_rev_8_12", "31.750712"),
                           ("rand_mse_90x70_32_8", "23.476472")):
            meta, golden, cur_path, ref_path, _ = fixture_frames(name, work)
            h, w = meta["height"], meta["width"]
            out_dir = os.path.join(work, name)
            stdout = run_cli(cli, [
                cur_path, ref_path, out_dir, str(meta["blk_dim"]),
                str(meta["span"]), str(w), str(h), "--device", "cuda",
            ])
            if f"PSNR: {psnr}" not in stdout.splitlines():
                fail(f"{name}: expected 'PSNR: {psnr}'")
            got = np.fromfile(frames_lib.output_filename(
                out_dir, meta["blk_dim"], meta["span"]), np.uint8)
            if got.tobytes() != golden.tobytes():
                fail(f"{name}: stacked output differs from the fixture")
            print(f"{name}: PSNR {psnr}, stack byte-exact")
        read_counts(mse_kernels, "MSE fixture runs")

        def score_lines(text):
            return [line for line in text.splitlines() if line.startswith(
                ("Original Score:", "Output file dimensions", "PSNR"))]

        reset_counts()
        for name in ("foreman_ssim_16_7", "foreman_ssim_4_15",
                     "rand_ssim_45x33_4_5", "rand_ssim_52x36_8_7"):
            meta, golden, cur_path, ref_path, want = fixture_frames(name, work)
            h, w = meta["height"], meta["width"]
            out_dir = os.path.join(work, name)
            stdout = run_cli(cli, [
                cur_path, ref_path, out_dir, str(meta["blk_dim"]),
                str(meta["span"]), str(w), str(h), "--device", "cuda",
                "--metric", "ssim",
            ])
            if score_lines(stdout) != score_lines(want):
                fail(f"{name}: expected {score_lines(want)}, got "
                     f"{score_lines(stdout)}")
            got = np.fromfile(frames_lib.output_filename(
                out_dir, meta["blk_dim"], meta["span"]), np.uint8)
            if got.tobytes() != golden.tobytes():
                fail(f"{name}: stacked output differs from the fixture")
            print(f"{name}: {score_lines(stdout)[0]}, stack byte-exact")
        read_counts(ssim_kernels, "SSIM fixture runs")

        # -- 3. the main paths at full size, counted -----------------------
        pairs = {}
        for label, h, w, blk, span in CONFIGS[:2] + SSIM_CONFIGS[:2]:
            if (h, w) not in pairs:
                pairs[h, w] = synthetic_pair(h, w, args.seed)
                pairs[h, w][0].tofile(os.path.join(work, f"cur_{h}.yuv"))
                pairs[h, w][1].tofile(os.path.join(work, f"ref_{h}.yuv"))
        main_launches = {}
        for metric, configs, names in (("mse", CONFIGS[:2], mse_kernels),
                                       ("ssim", SSIM_CONFIGS[:2], ssim_kernels)):
            print(f"== main path ({metric}): cli.main --device cuda at full "
                  f"size")
            reset_counts()
            for label, h, w, blk, span in configs:
                run_cli(cli, [
                    os.path.join(work, f"cur_{h}.yuv"),
                    os.path.join(work, f"ref_{h}.yuv"),
                    os.path.join(work, f"main_{metric}_{h}"), str(blk),
                    str(span), str(w), str(h), "--device", "cuda",
                    "--metric", metric, "--timing-row",
                ])
            main_launches.update(read_counts(names, f"main path ({metric})"))
            for label, h, w, blk, span in configs:
                cur, ref = pairs[h, w]
                gold = fs.full_search_frame(
                    torch.from_numpy(cur).to(dev), torch.from_numpy(ref).to(dev),
                    blk_dim=blk, span=span, metric=metric,
                )
                comp = check_stack(os.path.join(work, f"main_{metric}_{h}"),
                                   cur, ref, gold, blk, span, label,
                                   frames_lib)
                print(f"{label}: stack equals the plain golden search's, "
                      f"PSNR {frames_lib.image_psnr(comp, cur):.6f}")

    # -- 4. each kernel against its plain version on the card -------------
    print("== kernels vs their plain versions on the card (exact)")
    max_err = dict.fromkeys(counters, 0.0)

    def compare(kernel_names, got, want, what):
        err = max(float((a.double() - b.double()).abs().max())
                  if a.numel() else 0.0 for a, b in zip(got, want))
        for name in kernel_names:
            max_err[name] = max(max_err[name], err)
        print(f"{what}: max |kernel - plain| = {err}")
        if err or any(a.dtype != b.dtype for a, b in zip(got, want)):
            fail(f"{what}: kernel disagrees with its plain version")

    def operands(h, w, span, seed):
        cur, ref = synthetic_pair(h, w, seed)
        cur_t = torch.from_numpy(cur).to(dev)
        halo = torch.nn.functional.pad(
            torch.from_numpy(ref).to(dev), (span, span, span, span))
        return cur_t, halo

    shapes = {}  # kernel -> (fn, plain, args, kwargs, bound geometry)
    _, h, w, blk, span = CONFIGS[0]  # the phase kernel alone, mse and sad
    cur_t, halo = operands(h, w, span, args.seed)
    for metric in ("mse", "sad"):
        kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
                  frame_width=w)
        compare(["me_phase_search"], kc.phase_search(cur_t, halo, **kw),
                kc.search_plain(cur_t, halo, **kw),
                f"me_phase_search {w}x{h} {blk}x{blk} +-{span} {metric}")
    shapes["me_phase_search"] = (
        kc.phase_search, kc.search_plain, (cur_t, halo),
        dict(kw, metric="mse"), (h, w, blk, span, (h, w), (0, 0)),
    )
    label, h, w, blk, span = CONFIGS[1]  # whole frame, with the int slab
    cur, ref = pairs[h, w]
    got = kc.full_search_frame_cuda(cur, ref, blk_dim=blk, span=span,
                                    device=dev)
    want = fs.full_search_frame(
        torch.from_numpy(cur).to(dev), torch.from_numpy(ref).to(dev),
        blk_dim=blk, span=span,
    )
    compare(mse_kernels, got, want,
            f"full_search_frame_cuda {w}x{h} {blk}x{blk} +-{span} "
            f"(phase interior + int bottom slab)")
    y0 = h // blk * blk
    halo = torch.nn.functional.pad(torch.from_numpy(ref).to(dev),
                                   (span, span, span, span))
    slab = (torch.from_numpy(cur).to(dev)[y0:], halo[y0:])
    slab_kw = dict(blk_dim=blk, span=span, metric="mse", frame_height=h,
                   frame_width=w, y_origin=y0)
    compare(["me_int_search"], kc.int_search(*slab, **slab_kw),
            kc.search_plain(*slab, **slab_kw),
            f"me_int_search {w}x{h} {blk}x{blk} +-{span} bottom slab "
            f"({h - y0} rows)")
    shapes["me_int_search"] = (
        kc.int_search, kc.search_plain, slab, slab_kw,
        (h, w, blk, span, (h - y0, w), (y0, 0)),
    )
    h, w, blk, span = EDGE_CASE  # the int kernels alone, both edges cut
    cur_t, halo = operands(h, w, span, args.seed + 1)
    kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w)
    compare(["me_int_search"], kc.int_search(cur_t, halo, metric="mse", **kw),
            kc.search_plain(cur_t, halo, metric="mse", **kw),
            f"me_int_search {w}x{h} {blk}x{blk} +-{span} (both edges "
            f"truncated)")
    compare(["me_ssim_search"], sc.ssim_search(cur_t, halo, **kw),
            sc.ssim_plain(cur_t, halo, **kw),
            f"me_ssim_search {w}x{h} {blk}x{blk} +-{span} (both edges "
            f"truncated)")

    _, h, w, blk, span = SSIM_CONFIGS[0]  # the fast SSIM kernel alone
    cur_t, halo = operands(h, w, span, args.seed)
    kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w)
    compare(["me_ssim_fast_search"], sc.ssim_fast_search(cur_t, halo, **kw),
            sc.ssim_plain(cur_t, halo, **kw),
            f"me_ssim_fast_search {w}x{h} {blk}x{blk} +-{span}")
    shapes["me_ssim_fast_search"] = (
        sc.ssim_fast_search, sc.ssim_plain, (cur_t, halo), kw,
        (h, w, blk, span, (h, w), (0, 0)),
    )
    # Span 0 with cur = 255 - ref: no candidate scores above 0, so every
    # block must keep score 0 and the centre index. At span 0 the halo is
    # the reference frame itself.
    ref_t = halo[span:-span, span:-span]
    inv = (255 - ref_t).contiguous()
    kw0 = dict(kw, span=0)
    got = sc.ssim_fast_search(inv, ref_t, **kw0)
    compare(["me_ssim_fast_search"], got, sc.ssim_plain(inv, ref_t, **kw0),
            f"me_ssim_fast_search {w}x{h} {blk}x{blk} +-0, cur = 255 - ref")
    if got[0].any() or got[1].any():
        fail("span 0, cur = 255 - ref: a block did not keep score 0 and "
             "the centre index")

    label, h, w, blk, span = SSIM_CONFIGS[1]  # 1080p: the bottom slab
    cur, ref = pairs[h, w]
    y0 = h // blk * blk
    halo = torch.nn.functional.pad(torch.from_numpy(ref).to(dev),
                                   (span, span, span, span))
    slab = (torch.from_numpy(cur).to(dev)[y0:], halo[y0:])
    slab_kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w,
                   y_origin=y0)
    compare(["me_ssim_search"], sc.ssim_search(*slab, **slab_kw),
            sc.ssim_plain(*slab, **slab_kw),
            f"me_ssim_search {w}x{h} {blk}x{blk} +-{span} bottom slab "
            f"({h - y0} rows)")
    shapes["me_ssim_search"] = (
        sc.ssim_search, sc.ssim_plain, slab, slab_kw,
        (h, w, blk, span, (h - y0, w), (y0, 0)),
    )
    label, h, w, blk, span = SSIM_CONFIGS[2]  # whole frame, 2160 % 32 = 16
    cur, ref = synthetic_pair(h, w, args.seed + 2)
    got = sc.ssim_search_frame_cuda(cur, ref, blk_dim=blk, span=span,
                                    device=dev)
    want = fs.full_search_frame(
        torch.from_numpy(cur).to(dev), torch.from_numpy(ref).to(dev),
        blk_dim=blk, span=span, metric="ssim",
    )
    compare(ssim_kernels, got, want,
            f"ssim_search_frame_cuda {w}x{h} {blk}x{blk} +-{span} (fast "
            f"interior + bottom slab of {h % blk} rows)")

    # -- 5. timing -------------------------------------------------------
    print(f"== timing ({card}), median of {args.runs} runs after warm-up")
    for metric, configs in (("mse", CONFIGS), ("ssim", SSIM_CONFIGS)):
        for label, h, w, blk, span in configs:
            cur, ref = pairs.get((h, w)) or synthetic_pair(h, w, args.seed)
            config = SearchConfig(blk_dim=blk, span=span, metric=metric,
                                  frame_width=w, frame_height=h)
            for _ in range(3):
                runner.run_pair(cur, ref, config)
            reset_counts()
            runner.run_pair(cur, ref, config)
            per_frame = {n: fn.launches for n, fn in counters.items()
                         if fn.launches}
            results = [runner.run_pair(cur, ref, config)
                       for _ in range(args.runs)]
            kernel_ms = statistics.median(r.kernel_ms for r in results)
            total_ms = statistics.median(r.total_ms for r in results)
            row = min(results, key=lambda r: abs(r.kernel_ms - kernel_ms))
            nblocks = -(-h // blk) * -(-w // blk)
            print(f"{label}: timing_row {row.timing_row} | kernel "
                  f"{kernel_ms:.4f} ms, {nblocks / kernel_ms / 1e3:.3f} M "
                  f"blocks/s, {1e3 / kernel_ms:.1f} fps (kernel), "
                  f"{1e3 / total_ms:.1f} fps (total {total_ms:.4f} ms) | "
                  f"launches/frame {per_frame} | {card}")
            cur_t = torch.from_numpy(cur).to(dev)
            halo = torch.nn.functional.pad(torch.from_numpy(ref).to(dev),
                                           (span, span, span, span))
            nyf, nxf = h // blk, w // blk
            kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w)
            if metric == "mse":
                kw["metric"] = "mse"
                fast, edge, plain = kc.phase_search, kc.int_search, kc.search_plain
            else:
                fast, edge, plain = (sc.ssim_fast_search, sc.ssim_search,
                                     sc.ssim_plain)
            interior = (cur_t[: nyf * blk, : nxf * blk], halo)
            k_ms = cuda_ms(lambda: fast(*interior, **kw), 20)
            p_ms = cuda_ms(lambda: plain(*interior, **kw), 1)
            line = f"  {fast.__name__} {k_ms:.4f} ms (plain {p_ms:.2f} ms)"
            if h % blk:
                skw = dict(kw, y_origin=nyf * blk)
                s_ops = (cur_t[nyf * blk:], halo[nyf * blk:])
                s_ms = cuda_ms(lambda: edge(*s_ops, **skw), 20)
                sp_ms = cuda_ms(lambda: plain(*s_ops, **skw), 1)
                line += (f" | {edge.__name__} {s_ms:.4f} ms (plain "
                         f"{sp_ms:.2f} ms)")
            print(line + f" | {card}")

    # -- 6. the kernels line ----------------------------------------------
    kernels = []
    for name, (fn, plain, fargs, fkw, geo) in shapes.items():
        ssim = name in ssim_kernels
        ms = cuda_ms(lambda: fn(*fargs, **fkw), 50)
        plain_ms = cuda_ms(lambda: plain(*fargs, **fkw), 2)
        bound_ms, bound_by = bound(*geo, ssim=ssim)
        h, w, blk, span, (th, tw), _ = geo
        pixel_cands, block_cands = valid_candidates(*geo)
        int32_ms = 2 * pixel_cands / (props.multi_processor_count * 64
                                      * max_clock_mhz * 1e6) * 1e3
        print(f"{name} at {tw}x{th} of a {w}x{h} frame, {blk}x{blk} "
              f"+-{span}: {ms:.4f} ms; bound {bound_ms:.6f} ms "
              f"({bound_by}; {pixel_cands:.4g} pixel-candidates, "
              f"{block_cands:.4g} block-candidates); int32-lane issue floor "
              f"{int32_ms:.4f} ms (2 ops per pixel-candidate / "
              f"({props.multi_processor_count} SMs x 64 x {max_clock_mhz:.0f} "
              f"MHz)) | {card}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": main_launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
