#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--runs N]

Run from the root of a checkout. Phases, each of which raises on failure:

1. Set-up: the card's name and power limit, the torch / CUDA / nvcc
   versions, and the build of every kernel under
   motionestimation_tpu_torch/kernels/csrc (one nvcc per source, all
   started together).
2. Byte-exact CLI runs against the C reference's fixtures (Foreman 8x8 +-12
   both ways, and the truncated rand_mse_90x70_32_8).
3. The main path at full size, with every launch count set to 0 just
   before and read just after: `cli.main --device cuda` at 3840x2160 8x8
   +-12 and 1920x1080 16x16 +-15 on frames made from --seed. Each stacked
   output is checked against one built from the plain golden search on the
   card.
4. Each kernel against its plain PyTorch version on the card at full size
   (tolerance: exact equality of every int32 cost and index).
5. Timing with CUDA events: `run_pair` (median of --runs runs after
   warm-up) at 4K 8x8 +-12, 1080p 16x16 +-15 and 4K 16x16 +-15, and each
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
SOURCE = "motionestimation_tpu_torch/kernels/csrc/full_search.cu"
REPLACES = {
    "me_phase_search": "motionestimation_tpu/kernels/full_search_pallas.py:729",
    "me_int_search": "motionestimation_tpu/kernels/full_search_pallas.py:1076",
}
# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, int8 ops/s.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
# (label, height, width, blk, span)
CONFIGS = [
    ("4K 8x8 +-12", 2160, 3840, 8, 12),
    ("1080p 16x16 +-15", 1080, 1920, 16, 15),
    ("4K 16x16 +-15", 2160, 3840, 16, 15),
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


def valid_pixel_candidates(h, w, blk, span, tile, origin):
    """Pixel-candidates a search of the tile's blocks needs: for each block,
    (valid dy) x (valid dx) x its in-frame pixels."""
    (th, tw), (y0, x0) = tile, origin

    def axis(n, start, frame):
        tl = start + np.arange(-(-n // blk)) * blk
        ext = np.clip(frame - tl, 0, blk)
        lo = np.maximum(-span, -tl)
        hi = np.minimum(span, frame - ext - tl)
        return np.maximum(hi - lo + 1, 0), ext

    ny, ey = axis(th, y0, h)
    nx, ex = axis(tw, x0, w)
    return int((ny * ey).sum()) * int((nx * ex).sum())


def bound(h, w, blk, span, tile, origin):
    """(bound_ms, bound_by): bytes read once / written once over HBM rate,
    vs 2 integer ops (subtract, multiply-add) per pixel-candidate over the
    int8 peak; the larger wins."""
    th, tw = tile
    nby, nbx = -(-th // blk), -(-tw // blk)
    nbytes = th * tw + (th + 2 * span) * (tw + 2 * span) + 2 * 4 * nby * nbx
    ops = 2 * valid_pixel_candidates(h, w, blk, span, tile, origin)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / INT8_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    counters = (kc.phase_search, kc.int_search)

    def reset_counts():
        for fn in counters:
            fn.launches = 0

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as work:
        # -- 2. byte-exact CLI runs against the C reference's outputs ------
        print("== byte-exact CLI runs vs the C reference fixtures")
        reset_counts()
        for name, psnr in (("foreman_mse_8_12", "31.816000"),
                           ("foreman_mse_rev_8_12", "31.750712"),
                           ("rand_mse_90x70_32_8", "23.476472")):
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
        if not all(fn.launches > 0 for fn in counters):
            fail(f"fixture runs left a launch count at 0: "
                 f"{[fn.launches for fn in counters]}")

        # -- 3. the main path at full size, counted ------------------------
        print("== main path: cli.main --device cuda at full size")
        pairs = {}
        for label, h, w, blk, span in CONFIGS[:2]:
            cur, ref = synthetic_pair(h, w, args.seed)
            pairs[label] = (cur, ref)
            cur.tofile(os.path.join(work, f"cur_{h}.yuv"))
            ref.tofile(os.path.join(work, f"ref_{h}.yuv"))
        reset_counts()
        for label, h, w, blk, span in CONFIGS[:2]:
            run_cli(cli, [
                os.path.join(work, f"cur_{h}.yuv"),
                os.path.join(work, f"ref_{h}.yuv"),
                os.path.join(work, f"main_{h}"), str(blk), str(span), str(w),
                str(h), "--device", "cuda", "--timing-row",
            ])
        main_launches = {"me_phase_search": kc.phase_search.launches,
                         "me_int_search": kc.int_search.launches}
        print(f"main-path launches: {main_launches}")
        if not all(v > 0 for v in main_launches.values()):
            fail(f"a kernel of the main path never launched: {main_launches}")
        for label, h, w, blk, span in CONFIGS[:2]:
            cur, ref = pairs[label]
            gold = fs.full_search_frame(
                torch.from_numpy(cur).to(dev), torch.from_numpy(ref).to(dev),
                blk_dim=blk, span=span,
            )
            comp = frames_lib.compensate_frame_np(
                ref, gold.mv_y.cpu().numpy(), gold.mv_x.cpu().numpy(), blk)
            want = frames_lib.stack_output(ref, cur, comp).astype(np.uint8)
            got = np.fromfile(frames_lib.output_filename(
                os.path.join(work, f"main_{h}"), blk, span), np.uint8)
            if got.tobytes() != want.tobytes():
                fail(f"{label}: main-path stack differs from the plain search")
            print(f"{label}: stack equals the plain golden search's, PSNR "
                  f"{frames_lib.image_psnr(comp, cur):.6f}")

    # -- 4. each kernel against its plain version on the card -------------
    print("== kernels vs their plain versions on the card (exact)")
    max_err = {"me_phase_search": 0.0, "me_int_search": 0.0}

    def compare(kernel_name, got, want, what):
        err = max(float((a.double() - b.double()).abs().max())
                  if a.numel() else 0.0 for a, b in zip(got, want))
        max_err[kernel_name] = max(max_err[kernel_name], err)
        print(f"{what}: max |kernel - plain| = {err}")
        if err:
            fail(f"{what}: kernel disagrees with its plain version")

    def operands(h, w, span, seed):
        cur, ref = synthetic_pair(h, w, seed)
        cur_t = torch.from_numpy(cur).to(dev)
        halo = torch.nn.functional.pad(
            torch.from_numpy(ref).to(dev), (span, span, span, span))
        return cur_t, halo

    shapes = {}  # kernel -> (fn, args, kwargs, bound geometry), timed below
    _, h, w, blk, span = CONFIGS[0]  # the phase kernel alone, mse and sad
    cur_t, halo = operands(h, w, span, args.seed)
    for metric in ("mse", "sad"):
        kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
                  frame_width=w)
        compare("me_phase_search", kc.phase_search(cur_t, halo, **kw),
                kc.search_plain(cur_t, halo, **kw),
                f"me_phase_search {w}x{h} {blk}x{blk} +-{span} {metric}")
    shapes["me_phase_search"] = (
        kc.phase_search, (cur_t, halo), dict(kw, metric="mse"),
        (h, w, blk, span, (h, w), (0, 0)),
    )
    label, h, w, blk, span = CONFIGS[1]  # whole frame, with the int slab
    cur, ref = pairs[label]
    got = kc.full_search_frame_cuda(cur, ref, blk_dim=blk, span=span,
                                    device=dev)
    want = fs.full_search_frame(
        torch.from_numpy(cur).to(dev), torch.from_numpy(ref).to(dev),
        blk_dim=blk, span=span,
    )
    compare("me_phase_search", got, want,
            f"full_search_frame_cuda {w}x{h} {blk}x{blk} +-{span} "
            f"(phase interior + int bottom slab)")
    y0 = h // blk * blk
    halo = torch.nn.functional.pad(torch.from_numpy(ref).to(dev),
                                   (span, span, span, span))
    slab = (torch.from_numpy(cur).to(dev)[y0:], halo[y0:])
    slab_kw = dict(blk_dim=blk, span=span, metric="mse", frame_height=h,
                   frame_width=w, y_origin=y0)
    compare("me_int_search", kc.int_search(*slab, **slab_kw),
            kc.search_plain(*slab, **slab_kw),
            f"me_int_search {w}x{h} {blk}x{blk} +-{span} bottom slab "
            f"({h - y0} rows)")
    shapes["me_int_search"] = (
        kc.int_search, slab, slab_kw,
        (h, w, blk, span, (h - y0, w), (y0, 0)),
    )
    h, w, blk, span = EDGE_CASE  # the int kernel alone, both edges cut
    cur_t, halo = operands(h, w, span, args.seed + 1)
    kw = dict(blk_dim=blk, span=span, metric="mse", frame_height=h,
              frame_width=w)
    compare("me_int_search", kc.int_search(cur_t, halo, **kw),
            kc.search_plain(cur_t, halo, **kw),
            f"me_int_search {w}x{h} {blk}x{blk} +-{span} (both edges "
            f"truncated)")

    # -- 5. timing -------------------------------------------------------
    print(f"== timing ({card}), median of {args.runs} runs after warm-up")
    for label, h, w, blk, span in CONFIGS:
        cur, ref = pairs.get(label) or synthetic_pair(h, w, args.seed)
        config = SearchConfig(blk_dim=blk, span=span, frame_width=w,
                              frame_height=h)
        for _ in range(3):
            runner.run_pair(cur, ref, config)
        reset_counts()
        runner.run_pair(cur, ref, config)
        per_frame = {"me_phase_search": kc.phase_search.launches,
                     "me_int_search": kc.int_search.launches}
        results = [runner.run_pair(cur, ref, config) for _ in range(args.runs)]
        kernel_ms = statistics.median(r.kernel_ms for r in results)
        total_ms = statistics.median(r.total_ms for r in results)
        row = min(results, key=lambda r: abs(r.kernel_ms - kernel_ms))
        nblocks = -(-h // blk) * -(-w // blk)
        print(f"{label}: timing_row {row.timing_row} | kernel {kernel_ms:.4f} "
              f"ms, {nblocks / kernel_ms / 1e3:.3f} M blocks/s, "
              f"{1e3 / kernel_ms:.1f} fps (kernel), {1e3 / total_ms:.1f} fps "
              f"(total {total_ms:.4f} ms) | launches/frame {per_frame} | "
              f"{card}")
        cur_t = torch.from_numpy(cur).to(dev)
        halo = torch.nn.functional.pad(torch.from_numpy(ref).to(dev),
                                       (span, span, span, span))
        nyf, nxf = h // blk, w // blk
        kw = dict(blk_dim=blk, span=span, metric="mse", frame_height=h,
                  frame_width=w)
        interior = (cur_t[: nyf * blk, : nxf * blk], halo)
        k_ms = cuda_ms(lambda: kc.phase_search(*interior, **kw), 50)
        p_ms = cuda_ms(lambda: kc.search_plain(*interior, **kw), 2)
        line = (f"  me_phase_search {k_ms:.4f} ms (plain {p_ms:.2f} ms)")
        if h % blk:
            y0 = nyf * blk
            skw = dict(kw, y_origin=y0)
            s_ops = (cur_t[y0:], halo[y0:])
            s_ms = cuda_ms(lambda: kc.int_search(*s_ops, **skw), 50)
            sp_ms = cuda_ms(lambda: kc.search_plain(*s_ops, **skw), 2)
            line += f" | me_int_search {s_ms:.4f} ms (plain {sp_ms:.2f} ms)"
        print(line + f" | {card}")

    # -- 6. the kernels line ----------------------------------------------
    kernels = []
    for name, (fn, fargs, fkw, geo) in shapes.items():
        ms = cuda_ms(lambda: fn(*fargs, **fkw), 50)
        plain_ms = cuda_ms(lambda: kc.search_plain(*fargs, **fkw), 3)
        bound_ms, bound_by = bound(*geo)
        h, w, blk, span, (th, tw), _ = geo
        ops = 2 * valid_pixel_candidates(*geo)
        int32_ms = ops / (props.multi_processor_count * 64
                          * max_clock_mhz * 1e6) * 1e3
        print(f"{name} at {tw}x{th} of a {w}x{h} frame, {blk}x{blk} "
              f"+-{span}: {ms:.4f} ms; bound {bound_ms:.6f} ms "
              f"({bound_by}; {ops / 2:.4g} pixel-candidates); "
              f"int32-lane issue floor {int32_ms:.4f} ms "
              f"(2 ops per pixel-candidate / ({props.multi_processor_count} "
              f"SMs x 64 x {max_clock_mhz:.0f} MHz)) | {card}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
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
