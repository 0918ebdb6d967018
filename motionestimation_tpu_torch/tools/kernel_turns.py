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
its two runs, with the card's name. --group times only the cells with those
labels (e.g. "4K 7x7 +-15 sad").
`chip_smoke.py` times its in-turns groups with `time_group`; the tool uses
only the public wrappers of `kernels/full_search_cuda.py` (MSE, SAD) and
`kernels/ssim_cuda.py` (SSIM), so it times any checkout's kernels.
"""
from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch
import torch.nn.functional as F

from motionestimation_tpu_torch.core.device import resolve_device
from motionestimation_tpu_torch.kernels import full_search_cuda as kc
from motionestimation_tpu_torch.kernels import ssim_cuda as sc

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
                   help="time only these cells of GROUPS (default: all)")
    args = p.parse_args(argv)
    groups = select(args.group)
    dev = resolve_device()
    print(f"# {torch.cuda.get_device_name(dev)}, {LAUNCHES} launches each, "
          f"in turns")
    for (label, h, w, blk, span, entries), slab in groups:
        for name, ts in time_group(h, w, blk, span, entries, args.seed,
                                   dev, slab).items():
            print(f"{label}{'' if slab else ' interior'}: {name} "
                  f"{statistics.mean(ts):.4f} ms (runs "
                  f"{[round(t, 4) for t in ts]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
