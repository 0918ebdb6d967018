"""The search kernels timed in turns on the same work.

    python -m motionestimation_tpu_torch.tools.kernel_turns [--seed N]
        [--group LABEL ...]

For each cell of GROUPS, the interior of a synthetic frame pair (a random
reference, the current frame moved by (3, -5) plus noise, from --seed) goes
through each listed kernel, and for each cell of SLAB_GROUPS its truncated
bottom block row: first once, to load it and to check that the kernels of
one metric give equal (cost or score, idx); then LAUNCHES launches each
between CUDA events, in turns (A B ... B A), queued behind a sleep on the
card so that they run back to back and the events time the card, not the
host's issue of a short kernel. Prints each kernel's mean ms per launch and
its two runs, with the card's name. Each cell of WALK_GROUPS (the lazy
mode's cases of `chip_smoke.py`, on the JAX bench's synthetic content) runs
`me_diamond_walk` through `kernels/diamond_cuda.walk_cuda`: the call's mean
ms over LAUNCHES calls behind a sleep, twice, the kernel's own device time
from a profiled pass, and a digest of the result, so that two checkouts'
runs can be seen to agree. Each cell of REPLAY_GROUPS (a staged level of
`bench/matrix`'s diamond rows, on its content) does the same for
`me_diamond_replay` through `kernels/diamond_cuda.replay_cuda` over the
level's volume. Each cell of LAB_GROUPS (the speed-of-light tools' L1, the
variants of L2-L7, and P1, on their tools' inputs, `kern_lab.make_inputs`
and `vpu_peak.peak_input`) times its entries through `kern_lab.variant_fn`
(`kernels/lab_cuda.lab_padded`, or the wrappers `lab_phase`, `lab_diff`,
`lab_p3`, `lab_p5`, `lab_p6`, `lab_p7`) or `lab_peak` in turns, as GROUPS
does, with a digest of each entry's output. --group times only the cells with
those labels (e.g. "4K 7x7 +-15 sad", "lazy 4K 8x8 +-31 mse", "replay
worstcase-4k level 31", "lab key 2048x2048 tile_h 128").
`chip_smoke.py` times its in-turns groups with `time_group`; the tool uses
only the public wrappers of `kernels/full_search_cuda.py` (MSE, SAD),
`kernels/ssim_cuda.py` (SSIM) and `kernels/diamond_cuda.py` (the walk and
the replay), so it times any checkout's kernels: dropped into a `git
archive` copy of a parent commit, it times the parent's, and runs of the
two copies in turns (parent, change, change, parent) compare them on one
card.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import statistics
import sys

import numpy as np
import torch
import torch.nn.functional as F

from motionestimation_tpu_torch.bench import matrix, measure
from motionestimation_tpu_torch.core.device import resolve_device
from motionestimation_tpu_torch.kernels import diamond_cuda as dc
from motionestimation_tpu_torch.kernels import full_search_cuda as kc
from motionestimation_tpu_torch.kernels import lab_cuda as lab
from motionestimation_tpu_torch.kernels import ssim_cuda as sc
from motionestimation_tpu_torch.search import diamond
from motionestimation_tpu_torch.tools import kern_lab, vpu_peak

LAUNCHES = 20
# (label, height, width, blk, span, entries); an entry is (name, wrapper,
# metric, return_volume): the wrapper of `kernels/ssim_cuda.py` for SSIM,
# of `kernels/full_search_cuda.py` for MSE and SAD.
GROUPS = [
    ("4K 8x8 +-12", 2160, 3840, 8, 12, [
        ("K1 me_phase_search", "phase_search", "mse", False),
        ("K1 me_phase_search sad", "phase_search", "sad", False),
        ("K5 me_chunked_search", "chunked_search", "mse", False),
        ("K6 me_chunked_u8_search", "chunked_u8_search", "mse", False)]),
    ("4K 7x7 +-15", 2160, 3840, 7, 15, [
        ("K5 me_chunked_search", "chunked_search", "mse", False),
        ("K6 me_chunked_u8_search", "chunked_u8_search", "mse", False)]),
    ("4K 16x16 +-15", 2160, 3840, 16, 15, [
        ("K1 me_phase_search", "phase_search", "mse", False),
        ("K5 me_chunked_search", "chunked_search", "mse", False)]),
    ("1080p 16x16 +-15", 1080, 1920, 16, 15, [
        ("K1 me_phase_search", "phase_search", "mse", False),
        ("K1e me_phase_search (emit)", "phase_search", "mse", True)]),
    ("1080p 24x24 +-15", 1080, 1920, 24, 15, [
        ("K7 me_wide_search", "wide_search", "mse", False)]),
    # The JAX bench's config4 row at blk 32 (bench/matrix.py:297-302).
    ("4K 32x32 +-31", 2160, 3840, 32, 31, [
        ("K1 me_phase_search", "phase_search", "mse", False),
        ("K7 me_wide_search", "wide_search", "mse", False)]),
    # The JAX bench's SSIM cells (bench/matrix.py:223-247, 354-379).
    ("4K 16x16 +-7 ssim", 2160, 3840, 16, 7, [
        ("K3 me_ssim_fast_search", "ssim_fast_search", "ssim", False),
        ("K3e me_ssim_fast_search (emit)", "ssim_fast_search", "ssim",
         True)]),
    ("1080p 16x16 +-15 ssim", 1080, 1920, 16, 15, [
        ("K3 me_ssim_fast_search", "ssim_fast_search", "ssim", False),
        ("K3e me_ssim_fast_search (emit)", "ssim_fast_search", "ssim",
         True)]),
    ("4K 32x32 +-7 ssim", 2160, 3840, 32, 7, [
        ("K3 me_ssim_fast_search", "ssim_fast_search", "ssim", False)]),
    # The truncated-extent kernels where they take whole frames: K2's SAD at
    # the reference's Jockey blk and span, with and without its volume (the
    # SAD volume's route there), K2's and K5's SSD beside it as a
    # yardstick; K4 above blk 32.
    ("4K 7x7 +-15 sad", 2160, 3840, 7, 15, [
        ("K2 me_int_search sad", "int_search", "sad", False),
        ("K2e me_int_search sad (emit)", "int_search", "sad", True),
        ("K2 me_int_search", "int_search", "mse", False),
        ("K5 me_chunked_search", "chunked_search", "mse", False)]),
    ("4K 64x64 +-15 ssim", 2160, 3840, 64, 15, [
        ("K4 me_ssim_search", "ssim_search", "ssim", False)]),
]
# The same, on the truncated bottom block row (y_origin = h // blk * blk):
# the slabs where the truncated-extent kernels run beside an interior
# kernel.
SLAB_GROUPS = [
    ("1080p 16x16 +-15 bottom slab", 1080, 1920, 16, 15, [
        ("K2 me_int_search", "int_search", "mse", False),
        ("K2e me_int_search (emit)", "int_search", "mse", True),
        ("K4 me_ssim_search", "ssim_search", "ssim", False),
        ("K4e me_ssim_search (emit)", "ssim_search", "ssim", True)]),
    ("4K 7x7 +-15 bottom slab", 2160, 3840, 7, 15, [
        ("K2 me_int_search", "int_search", "mse", False)]),
    ("4K 32x32 +-7 bottom slab", 2160, 3840, 32, 7, [
        ("K4 me_ssim_search", "ssim_search", "ssim", False)]),
]


# The lazy mode's cases (`chip_smoke.py` LAZY_RUNS), W through `walk_cuda`
# with `default_max_steps(span)` rounds and no trajectory: (label, content,
# blk, span, metric, early_term). Content as `chip_smoke.py` makes it:
# "config3" the JAX bench's 1080p frames from --seed, "4K" from --seed + 2.
WALK_GROUPS = [
    ("lazy 4K 8x8 +-31 mse", "4K", 8, 31, "mse", None),
    ("lazy config3-ssim 1080p 16x16 +-15", "config3", 16, 15, "ssim", None),
    ("lazy 1080p 16x16 +-15 sad", "config3", 16, 15, "sad", None),
    ("lazy 1080p 16x16 +-15 mse early-term 2.0", "config3", 16, 15, "mse",
     2.0),
    ("lazy 1080p 24x24 +-15 mse", "config3", 24, 15, "mse", None),
    ("lazy 4K 64x64 +-15 ssim", "4K", 64, 15, "ssim", None),
]


def walk_content(name, seed):
    """(cur, ref) uint8 numpy frames of a WALK_GROUPS content: the JAX
    bench's synthetic frames (`bench/matrix._synth`), config3 at 1080p."""
    if name == "config3":
        return matrix._synth(np.random.default_rng(seed), 1080, 1920)
    return matrix._synth(np.random.default_rng(seed + 2), 2160, 3840)


def time_walk(content, blk, span, metric, early_term, seed=0, device=None):
    """(call ms [two runs], W's device ms, digest) of a WALK_GROUPS cell:
    the `walk_cuda` call's mean ms over LAUNCHES calls behind a sleep, in
    two runs; `me_diamond_walk`'s mean device time per launch in a
    profiled pass of LAUNCHES calls; a digest of the MotionField."""
    dev = resolve_device(device)
    cur, ref = (torch.from_numpy(a).to(dev)
                for a in walk_content(content, seed))
    call = functools.partial(
        dc.walk_cuda, cur, ref, blk_dim=blk, span=span, metric=metric,
        early_term=early_term, max_steps=diamond.default_max_steps(span),
        record_trajectory=False)
    field, _ = call()  # loads the kernel
    digest = hashlib.sha1(b"".join(
        t.cpu().numpy().tobytes() for t in field)).hexdigest()[:12]
    runs = [cuda_ms(call, LAUNCHES) for _ in range(2)]
    prof = measure.profile_pass(call, LAUNCHES, dev)
    kernel_ms = next(ms for name, (_, ms) in prof.kernels.items()
                     if "walk_kernel" in name)
    return runs, kernel_ms, digest


# The staged levels of `bench/matrix`'s diamond rows, R through
# `replay_cuda` over the level's volume with `default_max_steps(span)`
# rounds, escape tracking below the span and no trajectory: (label,
# content, blk, span, level radius, metric). Content as `bench/matrix`
# makes it (`replay_content`).
REPLAY_GROUPS = [
    ("replay config3 mse level 6", "config3", 16, 15, 6, "mse"),
    ("replay config3 ssim level 6", "config3", 16, 15, 6, "ssim"),
    ("replay worstcase level 6", "adversarial", 16, 15, 6, "mse"),
    ("replay worstcase level 15", "adversarial", 16, 15, 15, "mse"),
    ("replay worstcase-4k level 6", "adversarial-4k", 32, 31, 6, "mse"),
    ("replay worstcase-4k level 12", "adversarial-4k", 32, 31, 12, "mse"),
    ("replay worstcase-4k level 31", "adversarial-4k", 32, 31, 31, "mse"),
]


@functools.cache
def replay_content(name, seed):
    """(cur, ref) uint8 numpy frames of a REPLAY_GROUPS content: the
    synthetic frames of `bench/matrix.matrix_frames`, drawn in its order
    from one generator (`--seed` 0 gives the matrix's)."""
    rng = np.random.default_rng(seed)
    frames = {"config3": matrix._synth(rng, 1080, 1920),
              "adversarial": matrix._synth(rng, 1080, 1920, shift=(14, -14),
                                           noise=2)}
    if name in frames:
        return frames[name]
    matrix._synth(rng, 2160, 3840)  # the matrix's "4k" frames
    return matrix._synth(rng, 2160, 3840, shift=(28, -28), noise=2)


def time_replay(content, blk, span, r, metric, seed=0, device=None):
    """(call ms [two runs], R's device ms, digest) of a REPLAY_GROUPS cell:
    the `replay_cuda` call's mean ms over LAUNCHES calls behind a sleep, in
    two runs; `me_diamond_replay`'s mean device time per launch in a
    profiled pass of LAUNCHES calls (`device_ms`); a digest of the
    MotionField and the escape mask."""
    dev = resolve_device(device)
    cur, ref = (torch.from_numpy(a).to(dev)
                for a in replay_content(content, seed))
    h, w = cur.shape
    volume = (sc.ssim_volume_cuda(cur, ref, blk_dim=blk, span=r, device=dev)
              if metric == "ssim" else kc.full_search_volume_cuda(
                  cur, ref, blk_dim=blk, span=r, metric=metric, device=dev))
    call = functools.partial(
        dc.replay_cuda, volume, blk_dim=blk, span=r, metric=metric,
        early_term=None, max_steps=diamond.default_max_steps(span),
        record_trajectory=False, frame_height=h, frame_width=w,
        track_escape=r < span)
    field, _, escaped = call()  # loads the kernel
    digest = hashlib.sha1(b"".join(
        t.cpu().numpy().tobytes() for t in (*field, escaped))).hexdigest()[:12]
    runs = [cuda_ms(call, LAUNCHES) for _ in range(2)]
    return runs, device_ms(call, "replay_kernel", dev), digest


# The speed-of-light tools' L1, key and cross variants at the lab's
# 2048x2048 8x8 +-12 (`kern_lab.make_inputs(seed)`) and P1's mixes on the
# tool's input (`vpu_peak.peak_input`, INNER 64, OUTER 4096): (label, tool,
# entries); an entry is an L1, key or cross variant at that label's tile_h
# or a P1 mix at its rows.
LAB_GROUPS = [
    ("lab L1 2048x2048 tile_h 128", "kern_lab 128",
     ["NOP", "L0", "L1", "M1", "M2", "M3"]),
    ("lab L1 2048x2048 tile_h 64", "kern_lab 64",
     ["NOP", "L0", "L1", "M1", "M2", "M3"]),
    ("lab key 2048x2048 tile_h 128", "kern_lab 128",
     ["P4", "P4S", "P5", "P5S", "P5B", "P5SB", "P7", "P7S", "P3S"]),
    ("lab key 2048x2048 tile_h 64", "kern_lab 64", ["P4", "P4S"]),
    ("lab cross 2048x2048 tile_h 128", "kern_lab 128",
     ["P0", "P1", "P3", "P3A", "P3B", "P6", "P6B"]),
    ("lab cross 2048x2048 tile_h 64", "kern_lab 64", ["P0", "P1"]),
    ("lab P1 64x1024", "vpu_peak 64", ["fma", "mix", "roll"]),
    ("lab P1 512x1024", "vpu_peak 512", ["fma", "mix", "roll"]),
]


def time_lab(tool, entries, seed=0, device=None):
    """({entry: [ms, ms]}, {entry: digest}) of a LAB_GROUPS cell: each
    entry once (its output's digest), then LAUNCHES launches each between
    CUDA events behind a sleep, in turns."""
    dev = resolve_device(device)
    name, size = tool.split()
    if name == "kern_lab":
        cur, ref_p = (torch.from_numpy(x).to(dev)
                      for x in kern_lab.make_inputs(seed))
        fns = {v: functools.partial(kern_lab.variant_fn(f"{v}:{size}")[0],
                                    cur, ref_p)
               for v in entries}
    else:
        a = vpu_peak.peak_input(int(size)).to(dev)
        fns = {m: functools.partial(lab.lab_peak, a, mix=m,
                                    inner=vpu_peak.INNER,
                                    outer=vpu_peak.OUTER)
               for m in entries}
    digests = {}
    for entry, fn in fns.items():
        out = fn()
        outs = out if isinstance(out, tuple) else (out,)
        digests[entry] = hashlib.sha1(b"".join(
            t.cpu().numpy().tobytes() for t in outs)).hexdigest()[:12]
    times = {entry: [] for entry in fns}
    for entry in [*fns, *reversed(fns)]:
        times[entry].append(cuda_ms(fns[entry], LAUNCHES))
    return times, digests


def device_ms(call, kernel, device, n=LAUNCHES, tries=3):
    """Mean device time per launch of the kernel whose name holds `kernel`,
    from a profiled pass of n calls of `call`. The profiler can lose every
    record of a short pass (PERF.md question 14): the pass is then repeated
    with ten times the calls, up to `tries` passes; nan after that."""
    for _ in range(tries):
        prof = measure.profile_pass(call, n, device)
        ms = next((ms for name, (_, ms) in prof.kernels.items()
                   if kernel in name), None)
        if ms is not None:
            return ms
        n *= 10
    return float("nan")


def synthetic_pair(h, w, seed):
    """A reference frame and a current frame moved by (3, -5) plus noise."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = np.roll(ref, (3, -5), (0, 1)).astype(np.int32)
    cur += rng.integers(-6, 7, (h, w))
    return np.clip(cur, 0, 255).astype(np.uint8), ref


# Card clock cycles of sleep queued per launch before a timed run: 100 us at
# 2 GHz, more than the host takes to issue one launch.
SLEEP_CYCLES = 200_000


def cuda_ms(fn, n):
    """Mean device time of fn() over n calls, bracketed by CUDA events,
    queued behind a sleep on the card so that the calls run back to back
    where the host issues them faster than SLEEP_CYCLES each."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES * n)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def operands(h, w, blk, span, seed, device, slab=False):
    """(tile, halo, y_origin) of a synthetic (h, w) frame pair on `device`:
    its whole blocks and the reference zero-padded by `span` (y_origin 0),
    or with `slab` its truncated last block row and the halo rows it
    reaches."""
    cur, ref = synthetic_pair(h, w, seed)
    cur_t = torch.from_numpy(cur).to(device)
    halo = F.pad(torch.from_numpy(ref).to(device), (span, span, span, span))
    y0 = h // blk * blk
    if slab:
        return cur_t[y0:], halo[y0:], y0
    return cur_t[:y0, : w // blk * blk], halo, 0


def entry_call(entry, h, w, blk, span):
    """(wrapper, keyword arguments) that time an entry of GROUPS on the
    interior of an (h, w) frame pair."""
    _, wrapper, metric, volume = entry
    kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w)
    if metric != "ssim":
        kw["metric"] = metric
    if volume:
        kw["return_volume"] = True
    return getattr(sc if metric == "ssim" else kc, wrapper), kw


def time_group(h, w, blk, span, entries, seed=0, device=None, slab=False):
    """{name: [ms, ms]}: each entry's mean ms per launch over LAUNCHES
    launches, in turns, on the interior (or with `slab` the bottom slab).
    Raises if two entries of one metric disagree on (cost or score,
    idx)."""
    tile, halo, y0 = operands(h, w, blk, span, seed, resolve_device(device),
                              slab)
    fns, first = {}, {}
    for entry in entries:
        name, metric = entry[0], entry[2]
        fn, kw = entry_call(entry, h, w, blk, span)
        if y0:
            kw["y_origin"] = y0
        fns[name] = lambda fn=fn, kw=kw: fn(tile, halo, **kw)
        out = fns[name]()[:2]
        want = first.setdefault(metric, out)
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            raise RuntimeError(f"{name} differs from the first {metric} "
                               f"kernel at {w}x{h} {blk}x{blk} +-{span}")
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        times[name].append(cuda_ms(fns[name], LAUNCHES))
    return times


def select(labels=None):
    """[(cell, is a slab)] of GROUPS and then SLAB_GROUPS with the given
    labels, in that order (every cell for None); raises ValueError on a
    label neither has."""
    cells = [(g, False) for g in GROUPS] + [(g, True) for g in SLAB_GROUPS]
    known = [g[0] for g, _ in cells]
    unknown = sorted(set(labels or ()) - set(known))
    if unknown:
        raise ValueError(f"unknown groups {unknown}; the groups are {known}")
    return [c for c in cells if labels is None or c[0][0] in labels]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--group", nargs="+", metavar="LABEL",
                   help="time only these cells of GROUPS, SLAB_GROUPS, "
                   "WALK_GROUPS, REPLAY_GROUPS and LAB_GROUPS (default: "
                   "all)")
    args = p.parse_args(argv)
    if args.group is None:
        groups, walks, replays = select(), WALK_GROUPS, REPLAY_GROUPS
        labs = LAB_GROUPS
    else:
        walks = [g for g in WALK_GROUPS if g[0] in args.group]
        replays = [g for g in REPLAY_GROUPS if g[0] in args.group]
        labs = [g for g in LAB_GROUPS if g[0] in args.group]
        taken = {g[0] for g in walks + replays + labs}
        rest = [g for g in args.group if g not in taken]
        groups = select(rest) if rest else []
    dev = resolve_device()
    print(f"# {torch.cuda.get_device_name(dev)}, {LAUNCHES} launches each, "
          f"in turns")
    for (label, h, w, blk, span, entries), slab in groups:
        for name, ts in time_group(h, w, blk, span, entries, args.seed,
                                   dev, slab).items():
            print(f"{label}{'' if slab else ' interior'}: {name} "
                  f"{statistics.mean(ts):.4f} ms (runs "
                  f"{[round(t, 4) for t in ts]})")
    for label, content, blk, span, metric, early in walks:
        runs, kernel_ms, digest = time_walk(content, blk, span, metric, early,
                                            args.seed, dev)
        print(f"{label}: W me_diamond_walk {kernel_ms:.4f} ms (device time, "
              f"profiled mean of {LAUNCHES}); walk_cuda call "
              f"{statistics.mean(runs):.4f} ms (runs "
              f"{[round(t, 4) for t in runs]}); result {digest}")
    for label, content, blk, span, r, metric in replays:
        runs, kernel_ms, digest = time_replay(content, blk, span, r, metric,
                                              args.seed, dev)
        print(f"{label}: R me_diamond_replay {kernel_ms:.4f} ms (device "
              f"time, profiled mean of {LAUNCHES}); replay_cuda call "
              f"{statistics.mean(runs):.4f} ms (runs "
              f"{[round(t, 4) for t in runs]}); result {digest}")
    for label, tool, entries in labs:
        times, digests = time_lab(tool, entries, args.seed, dev)
        for entry, ts in times.items():
            print(f"{label}: {entry} {statistics.mean(ts):.4f} ms (runs "
                  f"{[round(t, 4) for t in ts]}); result {digests[entry]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
