"""Kernel-matrix recorder: `python -m motionestimation_tpu_torch.bench
--matrix -v N`.

The port of `motionestimation_tpu.bench.matrix`'s `run_matrix`: the same 25
rows (`TAGS`, letter for letter and in order), written as `v{N}.txt` and
compared tag by tag with `v{N-1}.txt` by the same `compare_rows` (the
gop-e2e-pct row gated at -10 points, the gop-e2e row informational, every
other row under the reference's 0.1 ms rule, src/gpu/run.sh:79).

Frames: Foreman F1, F2 and F4 from the frames directory (config1 is left
out, with a line that names the missing file, where F2 is absent: no other
frames stand in for it); the synthetic ones from one
`np.random.default_rng(0)`, drawn in the JAX order (`matrix_frames`), so
they equal the JAX rows' frames.

Timing. The JAX rows chain n pairs through one `lax.map` to amortise a TPU
host round trip; here the row's frames go to the card once, its entry runs
once as a warm-up, and the row records the best of 3 passes of n
back-to-back calls between CUDA events, divided by n: what a caller of the
entry sees, the host's issue included wherever the card waits for it. Each
row keeps the JAX row's n. Then one more pass of n calls runs under
`torch.profiler` and prints, per frame, the search kernels' device ms and
names, their launches, the row's ms minus the kernels', the card's busy
ms and its idle share (of the timed pass: 1 - busy / the row's ms; and of
the profiled pass, whose host issue the profiler slows) and the host ops
with the most self CPU time.

The GOP rows run `run_gop` over the JAX row's 17 4K frames (16 pairs, two
chunks of 8), best of 2 runs after a warm-up; the link bound that brackets
them is pinned h2d on a copy stream alone, over the same 17 frames before
and 16 random frames after, as many as the JAX probes ship.
"""
from __future__ import annotations

import dataclasses
import os
import re
import tempfile
import time

import numpy as np
import torch

from motionestimation_tpu_torch.bench import measure
from motionestimation_tpu_torch.core.config import SearchConfig
from motionestimation_tpu_torch.core.device import resolve_device
from motionestimation_tpu_torch.core.frames import load_yuv, save_yuv
from motionestimation_tpu_torch.kernels.full_search_cuda import (
    full_search_frame_cuda,
)
from motionestimation_tpu_torch.kernels.ssim_cuda import ssim_search_frame_cuda
from motionestimation_tpu_torch.pipeline import runner
from motionestimation_tpu_torch.search import diamond

KERNEL_EPSILON_MS = 0.1  # run.sh:79
GOP_PCT_DROP = 10.0  # pct-of-link-bound points a gop-e2e-pct row may drop


def compare_rows(rows, prev_rows):
    """Epsilon-compare this run's rows against the previous version's.

    Returns (lines, n_regressions). Three row classes:

    * `gop-e2e-pct` rows carry pct-of-link-bound (HIGHER is better, the
      link probe brackets the same run): regression when the pct drops
      more than GOP_PCT_DROP points.
    * `gop-e2e` raw-ms rows are informational only.
    * every other row is a per-frame time under the reference's absolute
      0.1 ms rule (src/gpu/run.sh:79).
    """
    lines = []
    regressions = 0
    for tag, val in rows:
        if tag not in prev_rows:
            lines.append(f"new: {tag}: {val:.4f} (no previous row)")
            continue
        prev = float(prev_rows[tag])
        if tag.startswith("gop-e2e-pct"):
            flag = "REGRESSION" if val < prev - GOP_PCT_DROP else "ok"
        elif tag.startswith("gop-e2e"):
            flag = "info"
        else:
            flag = "REGRESSION" if val > prev + KERNEL_EPSILON_MS else "ok"
        regressions += flag == "REGRESSION"
        lines.append(f"{flag}: {tag}: {val:.4f} vs previous {prev:.4f}")
    return lines, regressions


def _synth(rng, h, w, texture=4, shift=(1, -2), noise=1):
    small = rng.integers(0, 256, (h // texture + 2, w // texture + 2))
    ref = np.clip(
        np.kron(small, np.ones((texture, texture)))[:h, :w]
        + rng.normal(0, 1, (h, w)),
        0, 255,
    ).astype(np.uint8)
    cur = np.clip(
        np.roll(ref, shift, (0, 1)).astype(np.int32)
        + rng.integers(-noise, noise + 1, (h, w)),
        0, 255,
    ).astype(np.uint8)
    return cur, ref


@dataclasses.dataclass(frozen=True)
class Row:
    """One timed row: its tag, the frames it searches (a key of
    `matrix_frames`), the JAX row's n, and its entry with the row's
    arguments. Entries: "full" (`full_search_frame_cuda`), "ssim"
    (`ssim_search_frame_cuda`), "staged" (`diamond._diamond_staged`, no
    trajectory, `default_max_steps(span)` rounds), "lazy" and "volume"
    (`diamond_search_frame(volume_mode="lazy" / "full")`)."""

    tag: str
    frames: str
    n: int
    entry: str
    blk: int
    span: int
    metric: str = "mse"
    early_term: float | None = None
    escape_policy: str = "canonical"


ROWS = (
    Row("config1: Foreman F1->F2, SAD, blk 16, span 7 (real frames)",
        "foreman-f2", 1024, "full", 16, 7, "sad"),
    Row("config2: Foreman F1->F4, SSD (mse), blk 16, span 15 (real frames)",
        "foreman-f4", 1024, "full", 16, 15),
    Row("config3: synthetic-Beauty 1080p, DIAMOND, blk 16, span 15",
        "config3", 64, "staged", 16, 15),
    Row("config3-ref: synthetic-Beauty 1080p, full search, blk 16, span 15",
        "config3", 64, "full", 16, 15),
    Row("config3-early: synthetic-Beauty 1080p, DIAMOND early-term 2.0, "
        "blk 16, span 15", "config3", 64, "staged", 16, 15, early_term=2.0),
    Row("config3-sad: synthetic-Beauty 1080p, DIAMOND SAD, blk 16, span 15",
        "config3", 64, "staged", 16, 15, "sad"),
    Row("config3-sad-ref: synthetic-Beauty 1080p, full search SAD, "
        "blk 16, span 15", "config3", 64, "full", 16, 15, "sad"),
    Row("config3-ssim: synthetic-Beauty 1080p, DIAMOND SSIM (lazy), "
        "blk 16, span 15", "config3", 4, "lazy", 16, 15, "ssim"),
    Row("config3-ssim-staged: synthetic-Beauty 1080p, DIAMOND SSIM "
        "(staged volumes), blk 16, span 15", "config3", 16, "staged", 16, 15,
        "ssim"),
    Row("diamond-worstcase: adversarial 1080p (full escalation), "
        "DIAMOND, blk 16, span 15", "adversarial", 64, "staged", 16, 15),
    Row("diamond-worstcase-crossover: adversarial 1080p, DIAMOND "
        "escape_policy=crossover, blk 16, span 15", "adversarial", 64,
        "staged", 16, 15, escape_policy="crossover"),
    Row("diamond-fullvol: adversarial 1080p, DIAMOND full-volume replay, "
        "blk 16, span 15 (worst-case bound denominator)", "adversarial", 64,
        "volume", 16, 15),
    *(Row(f"config4: synthetic-Jockey 4K, SSD, blk {blk}, span 31", "4k", 16,
          "full", blk, 31) for blk in (8, 16, 32)),
    Row("config4-diamond: synthetic-Jockey 4K, DIAMOND, blk 32, span 31",
        "4k", 16, "staged", 32, 31),
    Row("diamond-worstcase-4k: adversarial 4K (full escalation), "
        "DIAMOND, blk 32, span 31", "adversarial-4k", 16, "staged", 32, 31),
    Row("diamond-worstcase-crossover-4k: adversarial 4K, DIAMOND "
        "escape_policy=crossover, blk 32, span 31", "adversarial-4k", 16,
        "staged", 32, 31, escape_policy="crossover"),
    Row("diamond-fullvol-4k: adversarial 4K, DIAMOND full-volume replay, "
        "blk 32, span 31 (worst-case bound denominator)", "adversarial-4k", 16,
        "volume", 32, 31),
    Row("headline: synthetic-Jockey 4K, SSD, blk 8, span 12", "4k", 32,
        "full", 8, 12),
    Row("north-star: synthetic-Jockey 4K, SSD, blk 16, span 15", "4k", 32,
        "full", 16, 15),
    Row("ssim: synthetic-Jockey 4K, SSIM, blk 16, span 7", "4k", 16, "ssim",
        16, 7, "ssim"),
    Row("ssim-blk32: synthetic-Jockey 4K, SSIM, blk 32, span 7 "
        "(fast split-fold kernel)", "4k", 4, "ssim", 32, 7, "ssim"),
)
GOP_TAG = ("gop-e2e: synthetic-Jockey 4K GOP, SSD, blk 8, span 12 "
           "(pipelined end-to-end, link-bound; informational)")
GOP_PCT_TAG = ("gop-e2e-pct: pct of bracketing link bound reached by the GOP "
               "pipeline (gated; higher is better)")
TAGS = tuple(row.tag for row in ROWS) + (GOP_TAG, GOP_PCT_TAG)
# The GOP rows' frames after the first (JAX: 17 frames, 16 pairs).
GOP_FRAMES = 17
FOREMAN = (288, 352)


def matrix_frames(frames_dir: str):
    """{key: (cur, ref)} of the rows' frames, "gop" (GOP_FRAMES frames after
    the 4K reference) and "post" (the random frames of the last link probe),
    as uint8 numpy arrays. "foreman-f2" is missing where the frames
    directory has no ForemanYF2.yuv. The synthetic frames come from one
    `np.random.default_rng(0)` in the JAX order: config3, adversarial 1080p,
    4K, adversarial 4K, the GOP, the post-probe frames."""
    def foreman(i):
        path = os.path.join(frames_dir, f"ForemanYF{i}.yuv")
        return load_yuv(path, *FOREMAN) if os.path.exists(path) else None

    f1, f2, f4 = foreman(1), foreman(2), foreman(4)
    if f1 is None or f4 is None:
        raise FileNotFoundError(
            f"ForemanYF1.yuv and ForemanYF4.yuv are needed in {frames_dir}")
    frames = {"foreman-f4": (f4, f1)}
    if f2 is not None:
        frames["foreman-f2"] = (f2, f1)
    rng = np.random.default_rng(0)
    frames["config3"] = _synth(rng, 1080, 1920)
    frames["adversarial"] = _synth(rng, 1080, 1920, shift=(14, -14), noise=2)
    frames["4k"] = _synth(rng, 2160, 3840)
    frames["adversarial-4k"] = _synth(rng, 2160, 3840, shift=(28, -28),
                                      noise=2)
    prev, gop = frames["4k"][1], []
    for _ in range(GOP_FRAMES):
        prev = np.clip(
            np.roll(prev, (1, -2), (0, 1)).astype(np.int32)
            + rng.integers(-3, 4, prev.shape),
            0, 255,
        ).astype(np.uint8)
        gop.append(prev)
    frames["gop"] = gop
    frames["post"] = [rng.integers(0, 256, prev.shape, dtype=np.uint8)
                      for _ in range(GOP_FRAMES - 1)]
    return frames


def rows_to_run(frames, frames_dir: str) -> list[Row]:
    """The rows whose frames `frames` holds, in order; prints a line for
    each row left out (config1 without ForemanYF2.yuv)."""
    rows = []
    for row in ROWS:
        if row.frames in frames:
            rows.append(row)
        else:
            print(f"{row.tag}: left out: no ForemanYF2.yuv in {frames_dir}",
                  flush=True)
    return rows


def row_call(row: Row, cur, ref, device):
    """A call of the row's entry on (cur, ref) that returns its MotionField."""
    kw = dict(blk_dim=row.blk, span=row.span)
    if row.entry == "full":
        return lambda: full_search_frame_cuda(cur, ref, metric=row.metric,
                                              device=device, **kw)
    if row.entry == "ssim":
        return lambda: ssim_search_frame_cuda(cur, ref, device=device, **kw)
    if row.entry == "staged":
        return lambda: diamond._diamond_staged(
            cur, ref, metric=row.metric, early_term=row.early_term,
            max_steps=diamond.default_max_steps(row.span),
            record_trajectory=False, escape_policy=row.escape_policy, **kw,
        )[0]
    mode = {"lazy": "lazy", "volume": "full"}[row.entry]
    return lambda: diamond.diamond_search_frame(
        cur, ref, metric=row.metric, volume_mode=mode, device=device, **kw)


def _gop_rows(frames, device, card):
    """(gop ms per pair, pct of the link bound): run_gop over the GOP
    frames, best of 2 runs after a warm-up, beside the best pinned-h2d rate
    over the same frames (before) and the post-probe frames (after); then
    one run under the profiler."""
    gop = frames["gop"]
    h, w = gop[0].shape
    config = SearchConfig(blk_dim=8, span=12, metric="mse", frame_width=w,
                          frame_height=h)
    frame_mb = h * w / 1e6
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i, f in enumerate(gop):
            paths.append(os.path.join(td, f"f{i:03d}.yuv"))
            save_yuv(paths[-1], f)
        outdir = os.path.join(td, "out")

        def run(p=paths):
            return runner.run_gop(p, config, output_dir=outdir,
                                  resume=False, device=device)

        run(paths[:2])  # warm-up
        rates = [measure.h2d_rate(gop, device)]
        gop_ms = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            gop_ms = min(gop_ms, (time.perf_counter() - t0)
                         / (len(paths) - 1) * 1e3)
        rates.append(measure.h2d_rate(frames["post"], device))
        prof = measure.profile_pass(run, 1, device)
    pairs = len(paths) - 1
    print(f"  GOP profile (one run_gop call of {pairs} pairs): kernels "
          f"{prof.kernels} (records, ms per launch), launches per "
          f"pair {({k: v / pairs for k, v in prof.launches.items()})}; card "
          f"busy {prof.busy_ms:.4f} ms, idle "
          f"{prof.idle_of(gop_ms * pairs):.1%} of the best timed call (1 - "
          f"busy / wall), {prof.idle:.1%} of the profiled call; link probes "
          f"{[round(r, 1) for r in rates]} MB/s pinned h2d | {card}",
          flush=True)
    link_bound_ms = frame_mb / max(rates) * 1e3
    return gop_ms, 100.0 * link_bound_ms / gop_ms


def run_matrix(version: int, results_dir: str, *, frames_dir: str,
               device="cuda", on_first=None) -> int:
    """Time every row of the matrix on the card and write
    `results_dir/v{version}.txt`; returns 1 when a row regressed against
    `v{version-1}.txt`, else 0. `on_first(row, cur, ref, field)`, where
    given, receives each timed row's first output (the warm-up call's) on
    its frames on the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the matrix times the card: it needs device cuda")
    card = measure.card()
    t0 = time.perf_counter()
    frames = matrix_frames(frames_dir)
    print(f"matrix frames made in {time.perf_counter() - t0:.1f} s")
    rows: list[tuple[str, float]] = []

    def record(tag, value, how):
        rows.append((tag, value))
        print(f"{tag}: {value:.4f} {how} | {card}", flush=True)

    on_card = {}
    for row in rows_to_run(frames, frames_dir):
        t0 = time.perf_counter()
        if row.frames not in on_card:
            on_card[row.frames] = tuple(torch.from_numpy(f).to(dev)
                                        for f in frames[row.frames])
        cur, ref = on_card[row.frames]
        call = row_call(row, cur, ref, dev)
        field = call()  # warm-up
        if on_first is not None:
            on_first(row, cur, ref, field)
        ms = min(measure.pass_ms([call] * row.n) for _ in range(3))
        record(row.tag, ms, f"ms per frame (best of 3 passes of {row.n} "
               f"back-to-back calls of the {row.entry} entry between CUDA "
               f"events, host issue included)")
        prof = measure.profile_pass(call, row.n, dev)
        print(f"  profile of {row.n} calls: {prof.describe(ms)}; row "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    del on_card
    gop_ms, pct = _gop_rows(frames, dev, card)
    record(GOP_TAG, gop_ms, "ms per pair (run_gop wall, best of 2)")
    record(GOP_PCT_TAG, pct, "pct of the best pinned-h2d link bound")

    os.makedirs(results_dir, exist_ok=True)
    out = os.path.join(results_dir, f"v{version}.txt")
    with open(out, "w") as f:
        f.write(
            f"# {card}, one card. Search ms per frame "
            "(motionestimation_tpu_torch.bench --matrix):\n"
            "# frames on the card once, one warm-up call, then the best of 3 "
            "passes of N back-to-back calls between CUDA events, / N: what a "
            "caller of the entry sees, host issue included.\n"
            "# synthetic frames from np.random.default_rng(0) in the JAX "
            "matrix's order, so they equal its rows' frames.\n"
            "# diamond-worstcase rows: adversarial full-escalation content.\n"
            "# gop-e2e row: run_gop wall ms per pair, 17 4K frames "
            "(informational).\n"
            "# gop-e2e-pct row: pct of the bracketing pinned-h2d link bound "
            f"the pipeline reached (gated: -{GOP_PCT_DROP:.0f} pts flags).\n"
        )
        for tag, ms in rows:
            f.write(f"[ {tag} ]\nkernel {ms:.4f} ms\n")
    print(f"wrote {out}")

    prev_path = os.path.join(results_dir, f"v{version - 1}.txt")
    regressions = 0
    if os.path.exists(prev_path):
        with open(prev_path) as f:
            prev_rows = dict(re.findall(r"\[ (.+?) \]\nkernel ([\d.]+) ms",
                                        f.read()))
        lines, regressions = compare_rows(rows, prev_rows)
        for line in lines:
            print(line)
    return 1 if regressions else 0
