#!/usr/bin/env python3
"""Benchmark: full-search motion estimation throughput on one NVIDIA card.

    python3 bench_torch.py [--seed N]

The port of bench.py (the JAX package's, which stays as it is). Prints ONE
JSON line with bench.py's keys, each measured on the card, on frames made
from --seed with bench.py's arithmetic and sizes: 4K, BATCH 32 frame pairs
for the searches, a 33-frame GOP for `run_gop`. Exits non-zero without
CUDA; there is no CPU fallback.

Config as the reference's de-facto baseline (8x8 blocks, +-12 span, 4K
frame; BASELINE.md): the reference's CUDA v5 kernel took 64.577 ms a frame
on an sm_52 card (results/gpu/v5.txt:4). `vs_baseline` is that time over
ours (>1 = faster).

Keys:
  value / ms_per_frame / search_fps_4k — `full_search_frame_cuda` alone
    (the MV field stays on the card), the analogue of the reference's
    `kernel` column. Every search key is the median over 5 passes (after a
    warm-up pass) of back-to-back calls, one on each of its pairs already
    on the card (BATCH, or 16 for diamond at blk 32), between CUDA events,
    per call; the host's issue is included wherever the card waits for
    it.
  px_cand_per_s — (pixel x candidate) evaluations per second, H*W*K^2 a
    frame.
  pct_of_roofline — the bound of that search (`bench/roofline.bound`, the
    one copy of the arithmetic `chip_smoke.py` reports as each kernel's
    `bound_ms`: bytes at the HBM rate, 2 int8 ops per valid
    pixel-candidate at the data-sheet peak) over ms_per_frame, in percent.
  gop_fps_4k — `run_gop` over a 33-frame 4K GOP, disk to npz dumps, best
    of 3 runs after a warm-up; gop_load_s ... gop_wall_s its `stats_out`.
  gop_link_* — pinned h2d on a copy stream alone (`bench/measure.h2d_rate`)
    over 16-frame trains: two before the timed runs and one after each;
    gop_pct_of_link_bound pairs each run with the probe after it.
  gop_disk_* — `load_yuv_into` reads of the GOP's own files into one
    recycled buffer (`bench/measure.disk_rate`), before and after the timed
    runs.
  gop_workload_bound_mb_s — the same stream with the real chunk work: 17
    frames copied pinned on a copy stream, `runner._gop_chunk` over two
    chunks of 8 pairs on the compute stream, their outputs read back.
  north_star_* — BASELINE.json's 16x16 +-15 config, search only.
  diamond_1080p_ms / full_search_1080p_ms — BASELINE config 3: staged
    diamond vs full search at 1080p 16x16 +-15 on slow-motion content;
    diamond_worstcase_* on adversarial content (shift (14, -14)),
    diamond_crossover_* the same under escape_policy="crossover".
  blk32_span31_4k_ms / diamond_blk32_span31_4k_ms — BASELINE config 4's
    extreme point, full search and staged diamond.

Every key of bench.py has a counterpart on the card, so none is left out;
`card` (nvidia-smi's name and power limit) is added. Both link trains hold
16 frames (bench.py's second probe slices 12 frames where its docs say
16). Numbers are not rounded.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from motionestimation_tpu_torch.bench import measure
from motionestimation_tpu_torch.bench.roofline import bound
from motionestimation_tpu_torch.core import frames as frames_lib
from motionestimation_tpu_torch.core.config import SearchConfig
from motionestimation_tpu_torch.kernels.full_search_cuda import (
    full_search_frame_cuda,
)
from motionestimation_tpu_torch.pipeline import runner
from motionestimation_tpu_torch.search import diamond

BASELINE_KERNEL_MS = 64.577  # GPU v5, Jockey 4K, 8x8 +-12
BASELINE_TOTAL_MS = 71.508   # GPU v5, Jockey 4K, end-to-end total
H, W = 2160, 3840
BLK, SPAN = 8, 12
BATCH = 32
GOP_FRAMES = 33
PASSES = 5


def _median_ms(call, pairs):
    """Median over PASSES passes (after one warm-up pass) of `call` on each
    pair, back to back between CUDA events (`measure.pass_ms`), in ms per
    pair."""
    calls = [functools.partial(call, cur, ref) for cur, ref in pairs]
    measure.pass_ms(calls)
    return statistics.median(measure.pass_ms(calls) for _ in range(PASSES))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    card = measure.card()
    rng = np.random.default_rng(args.seed)
    refs = rng.integers(0, 256, (BATCH, H, W), dtype=np.uint8)
    curs = np.clip(
        np.roll(refs, (0, 3, -5), (0, 1, 2)).astype(np.int32)
        + rng.integers(-6, 7, refs.shape),
        0, 255,
    ).astype(np.uint8)
    curs_d = torch.from_numpy(curs).to(dev)
    refs_d = torch.from_numpy(refs).to(dev)

    def search_time(h, w, blk, span, metric="mse"):
        pairs = [(c[:h, :w].contiguous(), r[:h, :w].contiguous())
                 for c, r in zip(curs_d, refs_d)]
        return _median_ms(lambda c, r: full_search_frame_cuda(
            c, r, blk_dim=blk, span=span, metric=metric, device=dev), pairs)

    ms_per_frame = search_time(H, W, BLK, SPAN)
    blocks = (H // BLK) * (W // BLK)
    k = 2 * SPAN + 1
    px_cand_per_s = H * W * k * k / (ms_per_frame * 1e-3)
    bound_ms, bound_by = bound(H, W, BLK, SPAN, (H, W), (0, 0))
    ns_4k = search_time(2160, 3840, 16, 15)
    ns_1080 = search_time(1080, 1920, 16, 15)
    blk32_4k = search_time(2160, 3840, 32, 31)
    del curs_d, refs_d

    def staged(blk, span, policy="canonical"):
        return lambda c, r: diamond._diamond_staged(
            c, r, blk_dim=blk, span=span, metric="mse", early_term=None,
            max_steps=diamond.default_max_steps(span),
            record_trajectory=False, escape_policy=policy)

    # Staged diamond at config 4's extreme point on slow-motion content:
    # 16 current frames against one reference.
    d4_small = rng.integers(0, 256, (H // 4 + 2, W // 4 + 2)).astype(
        np.float64)
    d4_ref = np.clip(np.kron(d4_small, np.ones((4, 4)))[:H, :W]
                     + rng.normal(0, 1, (H, W)), 0, 255).astype(np.uint8)
    d4_curs = [np.clip(np.roll(d4_ref, (1, -2), (0, 1)).astype(np.int32)
                       + rng.integers(-1, 2, (H, W)), 0, 255).astype(np.uint8)
               for _ in range(16)]
    d4r = torch.from_numpy(d4_ref).to(dev)
    diamond_blk32_4k = _median_ms(staged(32, 31), [
        (torch.from_numpy(c).to(dev), d4r) for c in d4_curs])
    del d4_curs, d4r

    # BASELINE config 3: diamond vs full search, 1080p, slow motion.
    hh, ww = 1080, 1920
    small = rng.integers(0, 256, (hh // 4 + 2, ww // 4 + 2)).astype(
        np.float64)
    d_ref = np.clip(np.kron(small, np.ones((4, 4)))[:hh, :ww]
                    + rng.normal(0, 1, (hh, ww)), 0, 255).astype(np.uint8)
    d_cur = np.clip(np.roll(d_ref, (1, -2), (0, 1)).astype(np.int32)
                    + rng.integers(-1, 2, (hh, ww)), 0, 255).astype(np.uint8)
    dr = torch.from_numpy(d_ref).to(dev)
    d_pairs = [(torch.from_numpy(np.clip(
        d_cur.astype(np.int32) + rng.integers(-1, 2, (hh, ww)), 0, 255
    ).astype(np.uint8)).to(dev), dr) for _ in range(BATCH)]
    diamond_ms = _median_ms(staged(16, 15), d_pairs)
    full_1080_ms = _median_ms(lambda c, r: full_search_frame_cuda(
        c, r, blk_dim=16, span=15, device=dev), d_pairs)
    # Adversarial: a (14, -14) shift escalates every staged level.
    w_cur = np.clip(np.roll(d_ref, (14, -14), (0, 1)).astype(np.int32)
                    + rng.integers(-2, 3, (hh, ww)), 0, 255).astype(np.uint8)
    w_pairs = [(torch.from_numpy(np.clip(
        w_cur.astype(np.int32) + rng.integers(-1, 2, (hh, ww)), 0, 255
    ).astype(np.uint8)).to(dev), dr) for _ in range(BATCH)]
    diamond_worst_ms = _median_ms(staged(16, 15), w_pairs)
    diamond_xover_worst_ms = _median_ms(staged(16, 15, "crossover"), w_pairs)
    del d_pairs, w_pairs, dr

    # End-to-end GOP at 4K, bracketed by pinned-h2d link probes and disk
    # reads of its own files.
    frame_mb = H * W / 1e6
    half = (GOP_FRAMES - 1) // 2

    config = SearchConfig(blk_dim=BLK, span=SPAN, metric="mse",
                          frame_width=W, frame_height=H)

    def workload_rate(frames17):
        """MB/s of 17 frames in (pinned, copy stream) and two chunks of 8
        pairs' outputs back, with the chunk work on the compute stream."""
        pinned = [torch.from_numpy(f).pin_memory() for f in frames17]
        copy = torch.cuda.Stream(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.cuda.stream(copy):
            staged_frames = [f.to(dev, non_blocking=True) for f in pinned]
        done = torch.cuda.Event()
        done.record(copy)
        torch.cuda.current_stream(dev).wait_event(done)
        outs = [runner._to_host(runner._gop_chunk(staged_frames[a:b], config,
                                                  dev), dev)
                for a, b in ((0, 9), (8, 17))]
        for _, event in outs:
            event.synchronize()
        dt = time.perf_counter() - t0
        nbytes = sum(f.nbytes for f in frames17) + sum(
            t.numel() * t.element_size() for host, _ in outs for t in host)
        return nbytes / 1e6 / dt

    with tempfile.TemporaryDirectory() as td:
        paths, prev = [], refs[0]
        for i in range(GOP_FRAMES):
            prev = np.clip(np.roll(prev, (1, -2), (0, 1)).astype(np.int32)
                           + rng.integers(-3, 4, (H, W)), 0, 255
                           ).astype(np.uint8)
            paths.append(os.path.join(td, f"f{i:03d}.yuv"))
            frames_lib.save_yuv(paths[-1], prev)
        outdir = os.path.join(td, "out")
        runner.run_gop(paths[:2], config, output_dir=outdir, resume=False,
                       device=dev)  # warm-up
        disk_rates = [measure.disk_rate(paths, H, W)]
        workload_rates = [workload_rate(refs[4:4 + 17])]
        link_rates = [measure.h2d_rate(refs[:half], dev),
                      measure.h2d_rate(refs[half:2 * half], dev)]
        gop_stats, gop_fps, run_fps, adj_rates = {}, 0.0, [], []
        for _ in range(3):
            stats = {}
            t0 = time.perf_counter()
            runner.run_gop(paths, config, output_dir=outdir, resume=False,
                           device=dev, stats_out=stats)
            fps = (GOP_FRAMES - 1) / (time.perf_counter() - t0)
            run_fps.append(fps)
            if fps > gop_fps:
                gop_fps, gop_stats = fps, stats
            adj_rates.append(measure.h2d_rate(
                rng.integers(0, 256, (half, H, W), dtype=np.uint8), dev))
        disk_rates.append(measure.disk_rate(paths, H, W))
        workload_rates.append(workload_rate(refs[4:4 + 17]))

    link_rates += adj_rates
    link_mb_s = max(link_rates)
    pct_adjacent = 100.0 * max(f * frame_mb / rate
                               for f, rate in zip(run_fps, adj_rates))
    nby, nbx = -(-H // BLK), -(-W // BLK)
    gop_bytes = GOP_FRAMES * H * W + (GOP_FRAMES - 1) * nby * nbx * 4
    eff_link_mb_s = gop_bytes / 1e6 / gop_stats["wall_s"]

    print(json.dumps({
        "metric": "full-search MV throughput, 4K 8x8 +-12, 1 card",
        "value": blocks / (ms_per_frame * 1e-3) / 1e6,
        "unit": "M blocks/s",
        "vs_baseline": BASELINE_KERNEL_MS / ms_per_frame,
        "ms_per_frame": ms_per_frame,
        "search_fps_4k": 1e3 / ms_per_frame,
        "px_cand_per_s": px_cand_per_s / 1e12,
        "px_cand_unit": "T diff/s",
        "pct_of_roofline": 100.0 * bound_ms / ms_per_frame,
        "roofline_bound_ms": bound_ms,
        "roofline_bound_by": bound_by,
        "gop_fps_4k": gop_fps,
        "gop_h2d_mb_s": gop_fps * frame_mb,
        "gop_link_mb_s": link_mb_s,
        "gop_link_probe_min_mb_s": min(link_rates),
        "gop_link_drift_ratio": max(link_rates) / min(link_rates),
        "gop_effective_link_mb_s": eff_link_mb_s,
        "gop_disk_mb_s": max(disk_rates),
        "gop_disk_probe_min_mb_s": min(disk_rates),
        "gop_pct_of_link_bound": pct_adjacent,
        "gop_pct_of_max_probe": 100.0 * gop_fps * frame_mb / link_mb_s,
        "gop_workload_bound_mb_s": max(workload_rates),
        "gop_pct_of_workload_bound": 100.0 * eff_link_mb_s
        / max(workload_rates),
        "gop_vs_baseline_total": gop_fps / (1e3 / BASELINE_TOTAL_MS),
        "gop_load_s": gop_stats["load_s"],
        "gop_h2d_enqueue_s": gop_stats["h2d_enqueue_s"],
        "gop_dispatch_s": gop_stats["dispatch_s"],
        "gop_d2h_wait_s": gop_stats["d2h_wait_s"],
        "gop_dump_s": gop_stats["dump_s"],
        "gop_wall_s": gop_stats["wall_s"],
        "north_star_16x16_s15_mblocks_s":
            (2160 // 16) * (3840 // 16) / ns_4k / 1e3,
        "north_star_search_fps_4k": 1e3 / ns_4k,
        "north_star_search_fps_1080p": 1e3 / ns_1080,
        "diamond_1080p_ms": diamond_ms,
        "full_search_1080p_ms": full_1080_ms,
        "diamond_worstcase_1080p_ms": diamond_worst_ms,
        "diamond_worst_vs_full_search": diamond_worst_ms / full_1080_ms,
        "diamond_crossover_worst_1080p_ms": diamond_xover_worst_ms,
        "diamond_crossover_worst_vs_full_search":
            diamond_xover_worst_ms / full_1080_ms,
        "blk32_span31_4k_ms": blk32_4k,
        "diamond_blk32_span31_4k_ms": diamond_blk32_4k,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
