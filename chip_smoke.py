#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--runs N]

Run from the root of a checkout. Phases, each of which raises on failure:

1. Set-up: the card's name and power limit, the torch / CUDA / nvcc
   versions, and the build of every kernel under
   motionestimation_tpu_torch/kernels/csrc (one nvcc per source, all
   started together); registers, spills, shared memory and resident CUDA
   blocks per SM of the chunked kernel at 4K 7x7 +-15, 4K 8x8 +-12, 4K
   16x16 +-15 and 1080p 7x7 +-7, of the phase kernel (MSE and SAD) at 4K
   8x8 +-12, 16x16 +-15 and 32x32 +-31, of the wide kernel at 1080p
   24x24 +-15 and 4K 32x32 +-31, of the fast SSIM kernel at 4K 16x16
   +-7, 1080p 16x16 +-15 and 4K 32x32 +-7, and of the truncated-extent
   kernels over the 4K 7x7 +-15 (SAD) and 64x64 +-15 (SSIM) frames and on
   the slabs of the 4K 7x7 +-15, 1080p 16x16 +-15 and 4K 32x32 +-7 cells.
2. Every fixture under tests/fixtures (13, by glob) through
   `tools/verify_card.py` on the card: `full_search_frame_cuda` or
   `ssim_search_frame_cuda` against the plain golden search (MVs, integer
   costs, SSIM scores bit for bit), and `cli.main --device cuda` (frames
   read and stacks written by the native frame IO, `io_native`, built
   with g++) with its stack byte-equal to the C reference's output.yuv and
   its PSNR or score lines equal to its stdout.txt; the phase, int, fast
   SSIM and truncated-extent SSIM kernels each launched.
3. The main paths at full size, each with every launch count set to 0 just
   before it and read just after: `cli.main --device cuda` at 3840x2160 8x8
   +-12 and 1920x1080 16x16 +-15 (MSE), then with `--metric ssim` at
   3840x2160 16x16 +-7 and 1920x1080 16x16 +-15, then (MSE) at 3840x2160
   7x7 +-15 (the chunked kernel, the int kernel on both slabs) and
   1920x1080 24x24 +-15 (the wide kernel), and the whole-frame routes:
   `--metric sad` at 3840x2160 7x7 +-15 (one launch of the int kernel, none
   of the phase kernel) and `--metric ssim` at 3840x2160 64x64 +-15 (one
   launch of the truncated-extent SSIM kernel), on frames made from --seed.
   Each stacked output is checked against one built from the plain golden
   search on the card. Then `full_search_frame_cuda(phase=False,
   operand_bf16=True)` at 3840x2160 8x8 +-12 (the packed-byte chunked
   kernel), every field equal to the golden search's, and the volume path:
   `full_search_volume_cuda` at 1920x1080 16x16 +-15 (MSE and SAD) and 7x7
   +-7 (MSE, and SAD: the int kernel's emit over the whole frame), entry
   for entry equal to the golden volume, from the emit modes alone. Then
   the diamond main path: `cli.main --device cuda --algorithm diamond` at
   1920x1080 16x16 +-15 on the JAX bench's config3 content (MSE, SAD, SSIM,
   MSE `--early-term 2.0`) and its adversarial content (MSE, canonical
   escalation and `--escape-policy crossover`), each run's MVs, costs and
   trajectories equal to the plain replay (`replay_plain`) over the golden
   volume on the card, and its stack to one built from those MVs; each
   run launches `me_diamond_replay` once a level (a level is one volume of
   the interior kernel's emit mode), runs no plain replay or plain search,
   and each replay call runs under `torch.cuda.set_sync_debug_mode("error")`
   (the staged path branches on the host once a level, outside it). Then
   the lazy mode's main path (`LAZY_RUNS`): config3-ssim (lazy) at 1080p
   16x16 +-15 SSIM, 1080p 24x24 +-15 MSE diamond through `run_pair` and
   3840x2160 64x64 +-15 SSIM diamond through the CLI (auto falls back to
   lazy there), an explicit lazy 3840x2160 8x8 +-31 MSE, SAD, span 1 and
   MSE early term 2.0 and 2500 (where the early check must stop blocks),
   after the registers, spills, resident warps and walks in flight of each
   of the walk kernel's team shapes; each call exactly one
   `me_diamond_walk` launch and
   no other, no golden plane, no replay and no host sync inside the lazy
   mode; each case's `walk_cuda` against its plain version `lazy_plain`
   (MVs, costs or scores and trajectories bit for bit) and the entry's
   output against the plain version's; timed: the kernel's device time,
   the lazy call's and `lazy_plain`'s ms, the evaluations and the bound
   (`bench/roofline.walk_bound`), and at 4K 8x8 +-31 the peak memory of
   the call beside `lazy_plain`'s. Then the GOP main path:
   `cli.main --device cuda --gop` over 33 frames at 3840x2160 8x8 +-12
   (the JAX bench's headline GOP, bench.py's content from --seed; the
   packed readback): exactly 32 launches of the phase kernel and none of
   another, every dump equal to `run_pair`'s on its pair (MVs, best_cost,
   score, psnr), a second call rewriting no dump, and a deleted dump
   recomputed alone and equal; `run_gop` at 1920x1080 16x16 +-15 and
   32x32 +-7 (MSE, the phase kernel and the int kernel on the bottom slab),
   16x16 +-15 SSIM (the fast and truncated-extent SSIM kernels), 9 frames
   each, and 16x16 +-15 diamond MSE `early_term=2.0` over 5 frames of
   config3 content, each launching its kernels once a pair and every dump
   equal to `run_pair`'s. The full-search and SSIM GOPs run under
   `torch.cuda.set_sync_debug_mode("error")`. Timed: the 4K GOP's pairs/s
   (best of 3 runs after a warm-up) with its `stats_out` split, over the
   33 files and over them thrice (97 frames), which splits the wall into
   a cost per call and one per pair; `run_pair` at that cell, and the two
   rates that bracket the pipeline on the same 33 files: disk reads into
   one recycled buffer (the native reader, with the numpy reader beside
   it in alternate passes) and pinned h2d on a copy stream alone. Then the
   sharded main path on meshes whose slots are all this one card (the
   halo exchange then copies on the card; no process crosses a card):
   `sharded_full_search` on a (1, 2, 2) mesh at 3840x2160 8x8 +-12 MSE
   (the phase kernel once a tile), 1920x1080 16x16 +-15 MSE (and the int
   kernel on the two tiles that hold the truncated block row) and SSIM
   (the fast and truncated-extent SSIM kernels), on a (1, 1, 4) mesh at
   3840x2160 7x7 +-15 SAD (the int kernel once a tile), and on a (1, 2, 4)
   mesh at 130x100 8x8 +-60 (halos of two hops on both axes), each with
   exactly those launches, no plain search (no call of
   `make_displacement_cost`) and MVs, costs and compensated frame equal to
   the unsharded frame entry's; `sharded_motion_step(algorithm="diamond")`
   on the config3 frames, MSE and MSE `early_term=2.0`, on the phase and
   int kernels' emit modes alone, equal to `diamond_search_frame`'s; and
   `run_gop_sharded` over the 4K GOP on (1, 2, 2) meshes, pipelined and
   per pair, a (2, 1, 1) mesh ("dp" batching) and, after
   `distributed_init` of a NCCL process group of one, pipelined again:
   one phase-kernel launch a tile and pair, every dump equal to
   `run_gop`'s on every key, and a second call rewriting nothing; in that
   group also `sharded_full_search` at 4K 8x8 +-12, equal to the frame
   entry. Each sharded run prints the torch.distributed calls it issued
   (`parallel.halo.COLLECTIVES`, set to 0 before it, beside the launch
   counts): none on the slot meshes of one process, and in the group one
   gather to rank 0 and two all-reduces a GOP chunk, one all-gather and
   two all-reduces for the single pair. The
   diamond steps launch one replay a tile and level and no plain replay,
   each replay under the sync check, as the GOP's diamond run. Timed
   (tiling overhead on one card, not scaling): `sharded_full_search` at 4K
   8x8 +-12 on (1, 1, 1) and (1, 2, 2) meshes beside
   `full_search_frame_cuda`, frames on the card, and the pairs/s of
   `run_gop_sharded` beside `run_gop`'s over the 4K GOP. Then the graft
   entry: `graft_entry.entry()` (the CIF 16x16 +-7 MSE step, one
   phase-kernel launch, equal to the plain golden path) and
   `dryrun_multichip(8)`, the sharded MSE, diamond and SSIM steps on a
   (2, 2, 2) mesh of this card's slots (JAX's `_factor_mesh` split; a 13x13
   frame at blk 8 +-9: truncated edges and two-hop halos), held inside it
   against the unsharded port for every batch element; the sharded steps'
   launches, counted apart from those of the unsharded runs, equal the
   count from their tiles (`dryrun_launches`: the replay, the phase, int,
   fast SSIM and truncated-extent SSIM kernels and the phase and int
   kernels' emit modes), and no plain search or replay runs; and
   `examples/ssim_demo_torch.py` on the card, within 1e-6 of the same
   formula in float64.
4. Each kernel and emit mode against its plain PyTorch version on the
   card at full size (tolerance: exact equality of every int32 cost, index
   and volume entry, and of every float32 SSIM score and -inf: kernel and
   plain version round each step alike), the phase kernel at every blk it
   covers (MSE and SAD, with and without its volume, off the origin, on
   constant frames), the fast SSIM kernel at every blk 1..32 (spans 0 and
   5, with and without its volume, on a 400x300 frame's tile off the
   origin), the packed-byte chunked kernel at 4K 7x7 +-15 and 8x8 +-12,
   `ssim_volume_cuda` against the golden SSIM volume, and the
   truncated-extent kernels (int: SSD and SAD; SSIM), with and without
   their volumes, over the two whole 4K frames and at every blk 1..33,
   40, 48 and 64, spans 0, 1 and 7, on small whole frames, their bottom
   and right slabs, tiles off the origin and constant frames. First of
   them `me_diamond_replay` against `replay_plain` (`replay_checks`):
   fields, trajectories and escape masks bit for bit at both staged
   levels of config3 MSE, SAD, SSIM and MSE early term 2.0 and of the
   adversarial content, on a tile at (544, 960) that holds the frame's
   truncated bottom block row, and on the 4K 32x32 +-31 worst case's
   first level, each with and without the trajectory.
5. Timing with CUDA events: `run_pair` (median of --runs runs after
   warm-up) at 4K 8x8 +-12, 1080p 16x16 +-15, 4K 16x16 +-15, 4K 7x7 +-15
   and 1080p 24x24 +-15 (MSE) and 4K 16x16 +-7, 1080p 16x16 +-15 and 4K
   32x32 +-7 (SSIM), and each kernel's own time beside its plain
   version's; `run_pair` at the two whole-frame cells, with the
   truncated-extent kernel's search and emit beside their plain versions;
   `tools/kernel_turns.py`'s groups, each kernel in turns with
   the others on the same work (K1's M blocks/s at 4K 8x8 +-12 and 16x16
   +-15 and the GOP phase's pinned h2d MB/s then feed
   `tools/record_scaling.py`, whose text is printed (into a temporary
   file, not over the committed results/h100/scaling.txt), and
   the scaling model's (2, 2) step is printed beside the measured (1, 2,
   2) slot mesh): the phase kernel (MSE and SAD), the
   chunked and packed-byte chunked kernels at 4K 8x8 +-12, the two chunked
   kernels on the 4K 7x7 +-15 interior, the phase and chunked kernels at
   4K 16x16 +-15, the phase kernel with and without its volume at 1080p
   16x16 +-15, the wide kernel at 1080p 24x24 +-15, the phase and wide
   kernels at 4K 32x32 +-31, and the fast SSIM kernel with and without
   its volume at 4K 16x16 +-7 and 1080p 16x16 +-15 and without at 4K 32x32
   +-7, the int kernel (SAD with and without its volume, SSD) beside the
   chunked kernel on the 4K 7x7 +-15 interior, the truncated-extent SSIM
   kernel at 4K 64x64 +-15, and both with their emit modes on the bottom
   slabs of 1080p 16x16 +-15, 4K 7x7 +-15 and 4K 32x32 +-7, the kernels of
   one metric in a group giving the same (cost or score, idx); the volume
   entries and the emit modes at 1080p 16x16 +-15, and the chunked kernel
   with and without its volume at 1080p 7x7 +-7; `run_pair` diamond
   beside full search on the config3 frames and on the adversarial frames
   (canonical and crossover), and the diamond replay alone at level 6 (MSE
   and SSIM): `me_diamond_replay` beside `replay_plain`, with its bound
   (`bench/roofline.replay_bound`: the distinct volume entries this run's
   trajectories read, counted by `replay_reads`, and the outputs), the
   instance's registers, spill and stack bytes (ptxas) and LDSP rounds a
   trip, and the device time of an empty kernel on the same grid (the
   floor of a launch).
6. The bench main path, counted: `python -m motionestimation_tpu_torch.bench`
   -v 1, then -v 2, into a temp dir, with Foreman F4/F1 written from
   planes 1 and 0 of the foreman_mse_8_12 fixture (Jockey and Beauty
   synthetic): Foreman's PSNR 31.816000 and v2's PSNR column equal to v1's
   (a timing flag between the two runs is a measurement, not a failure);
   then the matrix (`bench/matrix.run_matrix`, every row printed with its
   per-frame ms and its profiler pass: the search kernels' device ms and
   names, launches, the row minus the kernels, the card's idle share and
   the top host ops), config1 left out for want of ForemanYF2.yuv, each
   row's first call held against the plain golden path on the card: the
   full-search and SSIM rows' fields equal to the golden search's, the
   diamond rows' fields (and, but for crossover, trajectories) equal to
   the replay over the golden volume, each staged or full row's
   trajectory call launching `me_diamond_replay` and no `replay_plain`,
   the lazy row's one `me_diamond_walk` launch and no replay or golden
   plane; then
   `bench_torch.main()`, whose JSON line is printed, every number finite
   and `pct_of_roofline` in (0, 100].
7. The speed-of-light tools' main path, counted: `vpu_peak.main()` (the
   fma, mix and roll mixes of P1 and the P2 chain at the JAX tool's
   shapes) and `kern_lab.main()` on the lab's L2 ("P0", "P1") and L4
   ("P4", "P4S") variants at tile_h 64 and 128 (2048x2048 8x8 +-12, frames
   from --seed). Then P1 against its plain version at the tool's shape
   on inputs where every step of each chain moves the result
   (`vpu_peak.check_input`, OUTER 8: finite, 1e-4 relative for fma and
   mix, whose kernel fuses the multiply-add, 1e-5 for roll), P2 exactly,
   each L2/L4 variant exactly and, decoded, against K1's cost and index on
   the same frames; T elem-ops/s at the tool's shapes and at card-filling
   sizes beside the FP32-lane floor (a rate above it fails: the compiler
   dropped work; roll by the adds it executes, `vpu_peak.roll_adds`, with
   the tool's count beside it), and L2/L4 timed in turns beside K1. L1's
   six variants and L3, L5-L7 are held exactly against their plain
   versions at tile_h 64 and 128, L0, M1 and M2 against K1 on the blocks
   whose window lies inside the frame, each variant beside the bound its
   arithmetic sets (`bench/roofline.lab_bound`; L2 and L4 at both tile_h).
   The sixteen variants of the key kernel (L2-L7 but L1) are also held
   exactly against their plain versions (`kern_lab.key_plain`) on
   KEY_CHECKS' frames with partial CUDA blocks (random, tie and
   wrapping-key contents, the halo NaN, 1e9 and -7.5; "P3B" the zero
   halo); the registers, spills and resident warps of L1's, the key
   kernel's seven and the roll's instances are printed.
8. One JSON line listing the kernels and emit modes, the nvidia-smi
   name/power-limit line, and as the last line {"ok": true, "device":
   {...}}.

Exits non-zero, printing no result, without CUDA or outside a checkout.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import re
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
    "me_int_search": CSRC + "int_search.cu",
    "me_ssim_fast_search": CSRC + "ssim.cu",
    "me_ssim_search": CSRC + "ssim_search.cu",
    "me_chunked_search": CSRC + "chunked.cu",
    "me_chunked_u8_search": CSRC + "chunked.cu",
    "me_wide_search": CSRC + "chunked.cu",
    "me_diamond_replay": CSRC + "diamond.cu",
    "me_diamond_walk": CSRC + "diamond_walk.cu",
    "me_lab_peak": CSRC + "lab.cu",
    "me_lab_chain": CSRC + "lab.cu",
    "me_lab_phase": CSRC + "lab.cu",
    "me_lab_diff": CSRC + "lab.cu",
    "me_lab_padded": CSRC + "lab.cu",
    "me_lab_p3": CSRC + "lab.cu",
    "me_lab_p5": CSRC + "lab.cu",
    "me_lab_p6": CSRC + "lab.cu",
    "me_lab_p7": CSRC + "lab.cu",
}
REPLACES = {
    "me_phase_search": "motionestimation_tpu/kernels/full_search_pallas.py:729",
    "me_int_search": "motionestimation_tpu/kernels/full_search_pallas.py:1076",
    "me_ssim_fast_search": "motionestimation_tpu/kernels/ssim_pallas.py:214",
    "me_ssim_search": "motionestimation_tpu/kernels/ssim_pallas.py:48",
    "me_chunked_search":
        "motionestimation_tpu/kernels/full_search_pallas.py:131",
    "me_chunked_u8_search":
        "motionestimation_tpu/kernels/full_search_pallas.py:348",
    "me_wide_search": "motionestimation_tpu/kernels/full_search_pallas.py:471",
    # An XLA program, not a Pallas kernel: the jitted `_diamond_replay`.
    "me_diamond_replay": "motionestimation_tpu/search/diamond.py:259",
    # An XLA program, not a Pallas kernel: the jitted `_diamond_lazy`.
    "me_diamond_walk": "motionestimation_tpu/search/diamond.py:463",
    "me_lab_peak": "tools/vpu_peak.py:44",
    "me_lab_chain": "tools/vpu_peak.py:99",
    "me_lab_phase": "tools/kern_lab.py:357",
    "me_lab_diff": "tools/kern_lab.py:657",
    "me_lab_padded": "tools/kern_lab.py:74",
    "me_lab_p3": "tools/kern_lab.py:504",
    "me_lab_p5": "tools/kern_lab.py:773",
    "me_lab_p6": "tools/kern_lab.py:898",
    "me_lab_p7": "tools/kern_lab.py:1044",
}
# (label, height, width, blk, span)
CONFIGS = [
    ("4K 8x8 +-12", 2160, 3840, 8, 12),
    ("1080p 16x16 +-15", 1080, 1920, 16, 15),
    ("4K 16x16 +-15", 2160, 3840, 16, 15),
    # The reference's Jockey run (BASELINE.md): the chunked kernel on the
    # interior, the int kernel on the 4-row and 4-column slabs.
    ("4K 7x7 +-15", 2160, 3840, 7, 15),
    ("1080p 24x24 +-15", 1080, 1920, 24, 15),  # the wide kernel, no slab
]
CHUNKED_CONFIGS = CONFIGS[3:]
# The JAX package's own A/B config of its half-width-operand kernel
# (tools/kern_bench.py): phase=False, operand_bf16=True.
U8_CONFIG = ("4K 8x8 +-12", 2160, 3840, 8, 12)
# The JAX bench's config4 row at blk 32 (bench/matrix.py:297-302): K1 and
# K7 on the same work.
WIDE_CONFIG = ("4K 32x32 +-31", 2160, 3840, 32, 31)
# (blk, span): the phase kernel at every blk it covers, checked at 1080p.
PHASE_CHECKS = [(1, 3), (2, 5), (4, 8), (8, 12), (16, 15), (32, 31)]
# (label, height, width, blk, span, metric): the diamond cells' config
# (bench/matrix.py), and the chunked kernel's emit with both edge slabs.
VOLUME_CONFIGS = [
    ("1080p 16x16 +-15 mse", 1080, 1920, 16, 15, "mse"),
    ("1080p 16x16 +-15 sad", 1080, 1920, 16, 15, "sad"),
    ("1080p 7x7 +-7 mse", 1080, 1920, 7, 7, "mse"),
    # SAD outside the phase kernel: the int kernel's emit on the whole frame.
    ("1080p 7x7 +-7 sad", 1080, 1920, 7, 7, "sad"),
]
SSIM_CONFIGS = [
    ("4K 16x16 +-7 ssim", 2160, 3840, 16, 7),
    ("1080p 16x16 +-15 ssim", 1080, 1920, 16, 15),
    ("4K 32x32 +-7 ssim", 2160, 3840, 32, 7),
]
# (height, width, blk, span): the int kernel alone on a frame whose bottom
# and right block rows are both truncated.
EDGE_CASE = (700, 1000, 32, 8)
# The whole-frame routes of the truncated-extent kernels, (label, height,
# width, blk, span, metric): SAD at the reference's Jockey blk and span
# (BASELINE.md; the phase kernel does not take blk 7, so the int kernel
# takes the frame), and SSIM above blk 32.
WHOLE_CONFIGS = [
    ("4K 7x7 +-15 sad", 2160, 3840, 7, 15, "sad"),
    ("4K 64x64 +-15 ssim", 2160, 3840, 64, 15, "ssim"),
]
# The truncated-extent kernels' checks: every blk 1..33 and three above 32,
# each at span 0, 1 and 7.
EDGE_BLKS = list(range(1, 34)) + [40, 48, 64]
EDGE_SPANS = (0, 1, 7)


def edge_frame(blk):
    """(h, w) of the truncated-extent checks: two whole block rows and five
    whole block columns, then a truncated one of each (blk >= 2)."""
    return (3 * blk - 1 - (blk % 3 if blk > 2 else 0),
            5 * blk + (blk + 1) // 2)
# The JAX bench's diamond cells (bench/matrix.py:186-263): 1080p 16x16
# +-15 on config3 content (texture 4, shift (1, -2), noise +-1) and on
# adversarial content (shift (14, -14), noise +-2) that escalates.
DIAMOND = (1080, 1920, 16, 15)
# (label, content, extra CLI arguments, metric)
DIAMOND_RUNS = [
    ("mse", "config3", [], "mse"),
    ("sad", "config3", ["--metric", "sad"], "sad"),
    ("ssim", "config3", ["--metric", "ssim"], "ssim"),
    ("mse early-term 2.0", "config3", ["--early-term", "2.0"], "mse"),
    ("mse adversarial", "adversarial", [], "mse"),
    ("mse adversarial crossover", "adversarial",
     ["--escape-policy", "crossover"], "mse"),
]
# One blk of each of W's instances (a team shape and where a lane finds
# the block's words) and the blk range it takes.
WALK_SHAPES = [(4, "1-4"), (8, "5-8"), (12, "9-12"), (16, "13-16"),
               (32, "17-32"), (64, "33-64"), (70, "65 and above")]
# The lazy mode's main path, one `me_diamond_walk` launch a call: (label,
# entry, content, blk, span, metric, early_term, volume_mode). config3-ssim
# (lazy), the JAX bench's lazy row (bench/matrix.py:139-140); the full
# search cells' blk 24 MSE (K7) and 4K 64x64 SSIM (K4) as diamond, which
# the staged path cannot take (auto falls back to lazy), through
# `run_pair` and the CLI; the JAX lazy mode's own case, 4K 8x8 +-31
# (motionestimation_tpu/search/diamond.py:477-480); SAD, span 1 (auto ->
# lazy) and early termination on config3 content: at 2.0, the threshold of
# the diamond GOP, no block stops (config3's true shift (1, -2) is never an
# LDSP centre, and one pixel off its 4x4 tiles costs an MSE in the
# thousands); at 2500 about half of them stop before an LDSP round, so the
# kernel's early stop runs at full size.
LAZY_RUNS = [
    ("config3-ssim (lazy) 1080p 16x16 +-15 ssim", "frame", "config3", 16,
     15, "ssim", None, "lazy"),
    ("1080p 24x24 +-15 mse, run_pair (auto -> lazy)", "run_pair", "config3",
     24, 15, "mse", None, "auto"),
    ("4K 64x64 +-15 ssim, cli (auto -> lazy)", "cli", "4K", 64, 15, "ssim",
     None, "auto"),
    ("4K 8x8 +-31 mse (lazy)", "frame", "4K", 8, 31, "mse", None, "lazy"),
    ("1080p 16x16 +-15 sad (lazy)", "frame", "config3", 16, 15, "sad", None,
     "lazy"),
    ("1080p 16x16 +-1 mse (auto -> lazy)", "frame", "config3", 16, 1, "mse",
     None, "auto"),
    ("1080p 16x16 +-15 mse early-term 2.0 (lazy)", "frame", "config3", 16,
     15, "mse", 2.0, "lazy"),
    ("1080p 16x16 +-15 mse early-term 2500 (lazy)", "frame", "config3", 16,
     15, "mse", 2500.0, "lazy"),
]
# The GOP main path. The JAX package's headline (bench.py:15-24, 73): a
# 33-frame 4K 8x8 +-12 MSE GOP, through the CLI (the packed readback); then
# run_gop at 1080p, (label, frames, config keywords, content, launches per
# pair): MSE with K2 on the 8-row slab, 32x32 +-7 (K2 on the 24-row slab),
# SSIM, and diamond MSE with early termination on config3 content. The
# first three are unpacked (cost * K^2 does not fit 32 bits there).
GOP_4K = ("4K 8x8 +-12 mse", 33, 2160, 3840, 8, 12)
GOP_RUNS = [
    ("1080p 16x16 +-15 mse", 9, dict(blk_dim=16, span=15), "bench",
     {"me_phase_search": 1, "me_int_search": 1}),
    ("1080p 32x32 +-7 mse", 9, dict(blk_dim=32, span=7), "bench",
     {"me_phase_search": 1, "me_int_search": 1}),
    ("1080p 16x16 +-15 ssim", 9, dict(blk_dim=16, span=15, metric="ssim"),
     "bench", {"me_ssim_fast_search": 1, "me_ssim_search": 1}),
    ("1080p 16x16 +-15 diamond mse early-term 2.0", 5,
     dict(blk_dim=16, span=15, algorithm="diamond", early_term=2.0),
     "config3", {"me_phase_search": 1, "me_phase_search (emit)": 1,
                 "me_int_search": 1, "me_int_search (emit)": 1,
                 "me_diamond_replay": 1}),
]
# The speed-of-light tools: the lab's variants at 2048x2048 8x8 +-12 and
# tile_h 64 and 128 (L2 "P0"/"P1", L4 "P4"/"P4S"), and the card-filling
# sizes of the peak kernels: 8x the rows of P1, 32x the width of P2.
LAB_SPECS = [f"{v}:{t}" for v in ("P0", "P1", "P4", "P4S") for t in (64, 128)]
# Every other variant of the JAX lab at tile_h 128: (name, kernel, plain
# version, K1 metric its decoded output equals: on every block for the key
# forms, on the blocks whose whole window lies inside the frame for the
# unmasked L1 forms). The kernel line reports each kernel's first variant.
NEW_LAB = [
    ("L0", "me_lab_padded", "padded mse", "mse"),
    ("NOP", "me_lab_padded", "nop", None),
    ("L1", "me_lab_padded", "raw", None),
    ("M1", "me_lab_padded", "padded mse", "mse"),
    ("M2", "me_lab_padded", "padded sad", "sad"),
    ("M3", "me_lab_padded", "padded bf16", None),
    ("P3", "me_lab_p3", "diff mse", "mse"),
    ("P3S", "me_lab_p3", "diff sad", "sad"),
    ("P3A", "me_lab_p3", "nochain", None),
    ("P3B", "me_lab_p3", "nofold", None),
    ("P5", "me_lab_p5", "diff mse", "mse"),
    ("P5S", "me_lab_p5", "diff sad", "sad"),
    ("P5B", "me_lab_p5", "diff mse", "mse"),
    ("P5SB", "me_lab_p5", "diff sad", "sad"),
    ("P6", "me_lab_p6", "diff mse", "mse"),
    ("P6B", "me_lab_p6", "diff mse", "mse"),
    ("P7", "me_lab_p7", "diff mse", "mse"),
    ("P7S", "me_lab_p7", "diff sad", "sad"),
]
NEW_SPECS = [f"{v}:128" for v, *_ in NEW_LAB]
LAB_KERNELS = ("me_lab_peak", "me_lab_chain", "me_lab_phase", "me_lab_diff",
               "me_lab_padded", "me_lab_p3", "me_lab_p5", "me_lab_p6",
               "me_lab_p7")
FILL_ROWS = 512
FILL_CH_W = 65536
# The key kernel's edge checks (`lab_key_kernel`, the sixteen variants of
# L2-L7): (height, width, tile_h) of frames whose last CUDA block is partial
# in one or both directions, each with `kern_lab.check_inputs`' contents
# (random, tie, wrap) inside a halo of NaN, 1e9 and -7.5 ("P3B", which
# masks nothing, inside the zero halo).
KEY_CHECKS = [(24, 24, 8), (40, 72, 8), (128, 2040, 64)]


def fail(message: str):
    raise RuntimeError(f"chip_smoke: {message}")


def key_checks(dev, compare):
    """The key kernel's sixteen variants (`kern_lab.KEY_VARIANTS` and
    `CROSS_VARIANTS`, each through `kern_lab.variant_fn`), each exactly
    against its plain version (`kern_lab.key_plain`) on the KEY_CHECKS
    frames with every `kern_lab.check_inputs` content, at the frame's
    tile_h; "P3B" on the zero halo around the same frame. Returns the
    number of checks."""
    from motionestimation_tpu_torch.tools import kern_lab
    kernel = {v: name for v, name, *_ in NEW_LAB}
    kernel.update(P4="me_lab_diff", P4S="me_lab_diff", P0="me_lab_phase",
                  P1="me_lab_phase")
    n = 0
    for h, w, tile_h in KEY_CHECKS:
        for content in kern_lab.CHECK_CONTENTS:
            cur, ref_p = (torch.from_numpy(a).to(dev) for a in
                          kern_lab.check_inputs(h + w, height=h, width=w,
                                                content=content))
            for v in (*kern_lab.KEY_VARIANTS, *kern_lab.CROSS_VARIANTS):
                ref = (kern_lab.zero_halo(ref_p, height=h, width=w)
                       if v == "P3B" else ref_p)
                got = kern_lab.variant_fn(f"{v}:{tile_h}")[0](cur, ref)
                want = kern_lab.key_plain(v, cur, ref)
                compare([kernel[v]], got if isinstance(got, tuple) else [got],
                        want if isinstance(want, tuple) else [want],
                        f"{kernel[v]} \"{v}\" {w}x{h} tile_h {tile_h} "
                        f"{content}", quiet=True)
                n += 1
    return n


def synth(rng, h, w, texture=4, shift=(1, -2), noise=1):
    """The JAX bench's synthetic content (bench/matrix.py `_synth`):
    blocky texture plus Gaussian noise, the current frame moved by
    `shift` plus uniform noise."""
    small = rng.integers(0, 256, (h // texture + 2, w // texture + 2))
    ref = np.clip(np.kron(small, np.ones((texture, texture)))[:h, :w]
                  + rng.normal(0, 1, (h, w)), 0, 255).astype(np.uint8)
    cur = np.clip(np.roll(ref, shift, (0, 1)).astype(np.int32)
                  + rng.integers(-noise, noise + 1, (h, w)),
                  0, 255).astype(np.uint8)
    return cur, ref


def run_cli(cli, argv):
    """cli.main(argv); returns its stdout, which is also echoed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    print(buf.getvalue(), end="")
    if rc != 0:
        fail(f"cli.main returned {rc}")
    return buf.getvalue()


def gop_frames(rng, n, h, w, content):
    """n frames from `rng`: "bench" as the JAX bench makes its GOP
    (bench.py:415-430), a random frame and then each frame the previous one
    moved by (1, -2) plus noise in [-3, 3]; "config3" from synth's
    reference, each next frame moved by (1, -2) plus noise in [-1, 1]."""
    if content == "bench":
        prev, noise = rng.integers(0, 256, (h, w), dtype=np.uint8), 3
    else:
        prev, noise = synth(rng, h, w)[1], 1
    out = [] if content == "bench" else [prev]
    while len(out) < n:
        prev = np.clip(np.roll(prev, (1, -2), (0, 1)).astype(np.int32)
                       + rng.integers(-noise, noise + 1, (h, w)),
                       0, 255).astype(np.uint8)
        out.append(prev)
    return out


def check_gop_dump(path, pair, metric, what):
    """A GOP dump against `run_pair` on the same pair: MVs, best_cost (the
    SSIM score for SSIM), score and psnr, with their dtypes."""
    d = np.load(path)
    f = pair.field
    want = {"mv_y": f.mv_y, "mv_x": f.mv_x, "score": f.score,
            "best_cost": f.score if metric == "ssim" else f.best_cost_i32}
    for key, value in want.items():
        if d[key].dtype != value.dtype or not np.array_equal(d[key], value):
            fail(f"{what}: {key} differs from run_pair's")
    if float(d["psnr"]) != pair.psnr:
        fail(f"{what}: psnr {float(d['psnr'])} != run_pair's {pair.psnr}")


def gop_phase(work, seed, dev, card, counted, sync_errors, time_run_pair):
    """The GOP main path (checks) and its timing; see the module docstring.
    `counted(expected, what)` zeroes every launch count and checks them
    after the block; `sync_errors()` makes a synchronising call raise.
    Returns the 4K GOP's frame paths, its dump directory and its config."""
    from motionestimation_tpu_torch import cli
    from motionestimation_tpu_torch.bench import measure
    from motionestimation_tpu_torch.core import frames as frames_lib
    from motionestimation_tpu_torch.core.config import SearchConfig
    from motionestimation_tpu_torch.pipeline import runner

    rng = np.random.default_rng(seed)
    label, n, h, w, blk, span = GOP_4K
    print(f"== main path (GOP {label}): cli.main --device cuda --gop with "
          f"{n} frames at {w}x{h}")
    paths = []
    for i, frame in enumerate(gop_frames(rng, n, h, w, "bench")):
        paths.append(os.path.join(work, f"gop_{i:03d}.yuv"))
        frame.tofile(paths[-1])
    config = SearchConfig(blk_dim=blk, span=span, frame_width=w,
                          frame_height=h)
    out_dir = os.path.join(work, "gop_4k")
    argv = [paths[0], paths[0], out_dir, str(blk), str(span), str(w), str(h),
            "--device", "cuda", "--gop", *paths]
    if runner._gop_pack_kk(config) is None:
        fail(f"GOP {label}: expected the packed readback")
    with counted({"me_phase_search": n - 1}, f"GOP {label}"), sync_errors():
        stdout = run_cli(cli, argv)
    if stdout.splitlines()[-1] != f"GOP: {n - 1} frame pairs -> {out_dir}":
        fail(f"GOP {label}: no 'GOP:' line")
    dumps = sorted(os.path.join(out_dir, p) for p in os.listdir(out_dir))
    if [os.path.basename(p) for p in dumps] != [
            f"mv_{i:05d}.npz" for i in range(n - 1)]:
        fail(f"GOP {label}: dumps {dumps}")
    frames = [frames_lib.load_yuv(p, h, w) for p in paths]
    for i, path in enumerate(dumps):
        check_gop_dump(path, runner.run_pair(frames[i + 1], frames[i], config,
                                             device=dev), "mse",
                       f"GOP {label} pair {i}")
    print(f"GOP {label}: {n - 1} dumps equal run_pair's (MVs, best_cost, "
          f"score, psnr)")
    mtimes = {p: os.stat(p).st_mtime_ns for p in dumps}
    with counted({}, f"GOP {label}, resumed"), sync_errors():
        run_cli(cli, argv)
    if {p: os.stat(p).st_mtime_ns for p in dumps} != mtimes:
        fail(f"GOP {label}: a second call rewrote a dump")
    hole = dumps[(n - 1) // 2]
    golden = dict(np.load(hole))
    os.remove(hole)
    del mtimes[hole]
    with counted({"me_phase_search": 1}, f"GOP {label}, one hole"), \
            sync_errors():
        run_cli(cli, argv)
    if any(os.stat(p).st_mtime_ns != t for p, t in mtimes.items()):
        fail(f"GOP {label}: filling the hole rewrote another dump")
    got = np.load(hole)
    if sorted(got.files) != sorted(golden) or not all(
            got[k].dtype == v.dtype and np.array_equal(got[k], v)
            for k, v in golden.items()):
        fail(f"GOP {label}: the recomputed hole differs")
    print(f"GOP {label}: a second call rewrote nothing; the hole "
          f"{os.path.basename(hole)} was recomputed alone and equal")

    for run_label, m, kw, content, per_pair in GOP_RUNS:
        rh, rw = 1080, 1920
        run_config = SearchConfig(**kw, frame_width=rw, frame_height=rh)
        print(f"== main path (GOP {run_label}): run_gop with {m} frames, "
              f"{content} content, "
              f"{'packed' if runner._gop_pack_kk(run_config) else 'unpacked'}"
              f" readback")
        run_frames = gop_frames(rng, m, rh, rw, content)
        run_paths = []
        for i, frame in enumerate(run_frames):
            run_paths.append(os.path.join(work, f"run_{i:03d}.yuv"))
            frame.tofile(run_paths[-1])
        expected = {k: v * (m - 1) for k, v in per_pair.items()}
        diamond = kw.get("algorithm") == "diamond"
        # Diamond branches on the host between levels: there only the
        # replay runs under the sync check, and no plain replay may run.
        with counted(expected, f"GOP {run_label}"), (
                replay_without_sync(sync_errors) if diamond
                else sync_errors()), (
                no_plain_path(f"GOP {run_label}") if diamond
                else contextlib.nullcontext()):
            out = runner.run_gop(
                run_paths, run_config, device=dev, chunk_pairs=3,
                output_dir=os.path.join(work, "gop_" + run_label.replace(
                    " ", "_")))
        for i, path in enumerate(out):
            check_gop_dump(path, runner.run_pair(
                run_frames[i + 1], run_frames[i], run_config, device=dev),
                run_config.metric, f"GOP {run_label} pair {i}")
        print(f"GOP {run_label}: {m - 1} dumps equal run_pair's")

    # -- timing: the 4K GOP, run_pair at its cell, and the two rates that
    # bracket the pipeline (disk reads, pinned h2d on a copy stream).
    print(f"== GOP timing at {label}, {n - 1} pairs ({card})")
    timed_dir = os.path.join(work, "gop_timed")
    runner.run_gop(paths, config, output_dir=timed_dir, device=dev,
                   resume=False)  # warm-up
    # The same files thrice over (97 frames, 96 pairs) split the wall into
    # a cost per call (pool, threads, fill and drain) and one per pair.
    walls = {}
    for gop in (paths, paths + paths[1:] + paths[1:]):
        results = []
        for _ in range(3):
            stats = {}
            t0 = time.perf_counter()
            runner.run_gop(gop, config, output_dir=timed_dir, device=dev,
                           resume=False, stats_out=stats)
            results.append((time.perf_counter() - t0, stats))
        wall, stats = min(results, key=lambda r: r[0])
        walls[len(gop) - 1] = wall
        split = {k: round(v, 6) if isinstance(v, float) else v
                 for k, v in stats.items()}
        print(f"GOP {label}, {len(gop)} frames: best of 3 "
              f"{(len(gop) - 1) / wall:.2f} pairs/s (runs "
              f"{[round((len(gop) - 1) / r[0], 2) for r in results]}, "
              f"resume=False, after one warm-up); stats_out of the best "
              f"{split} | {card}")
    (short, t_short), (long_, t_long) = sorted(walls.items())
    per_pair = (t_long - t_short) / (long_ - short)
    per_call = t_short - short * per_pair
    print(f"GOP {label}: {per_pair * 1e3:.4f} ms a pair beyond the first "
          f"{short} ({1 / per_pair:.2f} pairs/s), {per_call * 1e3:.4f} ms "
          f"a call besides | {card}")
    time_run_pair(f"run_pair at the GOP cell {label}", frames[1], frames[0],
                  config)
    frame_mb = h * w / 1e6
    disk, disk_np = [], []
    for _ in range(3):  # alternate passes, the page cache warm for both
        disk.append(measure.disk_rate(paths, h, w))
        disk_np.append(measure.disk_rate(paths, h, w,
                                         reader=frames_lib.load_yuv_into_np))
    try:
        h2d = [measure.h2d_rate(frames, dev, check=True) for _ in range(3)]
    except ValueError as e:
        fail(str(e))
    print(f"GOP {label} bracket: disk read (load_yuv_into, native, one "
          f"recycled buffer) best {max(disk):.1f} MB/s = "
          f"{max(disk) / frame_mb:.1f} frames/s (passes "
          f"{[round(r, 1) for r in disk]}); the numpy reader "
          f"(load_yuv_into_np) in alternate passes best {max(disk_np):.1f} "
          f"MB/s (passes {[round(r, 1) for r in disk_np]}); pinned h2d on a "
          f"copy stream alone best {max(h2d):.1f} MB/s = "
          f"{max(h2d) / frame_mb:.1f} frames/s (passes "
          f"{[round(r, 1) for r in h2d]}); {n} frames of {frame_mb:.3f} MB | "
          f"{card}")
    return paths, out_dir, config, max(h2d)


# The sharded main path on slot meshes of the one card, (label, mesh (dp,
# ty, tx), height, width, blk, span, metric, launches a frame: once a tile,
# and the truncated-edge kernel on the tiles that hold the frame's last
# block row or column).
SHARDED_RUNS = [
    ("4K 8x8 +-12 mse", (1, 2, 2), 2160, 3840, 8, 12, "mse",
     {"me_phase_search": 4}),
    ("1080p 16x16 +-15 mse", (1, 2, 2), 1080, 1920, 16, 15, "mse",
     {"me_phase_search": 4, "me_int_search": 2}),
    ("1080p 16x16 +-15 ssim", (1, 2, 2), 1080, 1920, 16, 15, "ssim",
     {"me_ssim_fast_search": 4, "me_ssim_search": 2}),
    ("4K 7x7 +-15 sad", (1, 1, 4), 2160, 3840, 7, 15, "sad",
     {"me_int_search": 4}),
    # span 60 > the 40-column and 56-row tiles: two hops on each axis; the
    # bottom row of tiles holds the truncated block row, the right column
    # of tiles the truncated block column.
    ("multi-hop 130x100 8x8 +-60 mse", (1, 2, 4), 100, 130, 8, 60, "mse",
     {"me_phase_search": 8, "me_int_search": 6}),
]
# run_gop_sharded over the GOP phase's 4K GOP: (label, mesh, pipelined,
# launches a pair).
SHARDED_GOPS = [
    ("(1, 2, 2) pipelined", (1, 2, 2), True, 4),
    ("(1, 2, 2) per pair", (1, 2, 2), False, 4),
    ("(2, 1, 1) dp batching", (2, 1, 1), "auto", 1),
]


@contextlib.contextmanager
def no_plain_path(what, search=True):
    """Fails if the block runs a plain search (with `search`) or a plain
    replay: every plain version of a search kernel (the kernels', the
    golden tile search and volume) evaluates its costs through
    `search.full_search.make_displacement_cost`, and diamond's plain
    replay is `kernels.diamond_cuda.replay_plain`."""
    from motionestimation_tpu_torch.kernels import diamond_cuda as dc
    from motionestimation_tpu_torch.search import full_search as fs

    calls = {}
    reals = [(dc, "replay_plain", dc.replay_plain)]
    if search:
        reals.append(
            (fs, "make_displacement_cost", fs.make_displacement_cost))

    def counting(name, real):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **kw)
        return call

    for module, name, real in reals:
        setattr(module, name, counting(name, real))
    try:
        yield
    finally:
        for module, name, real in reals:
            setattr(module, name, real)
    if calls:
        fail(f"{what}: the plain path ran {calls}")


@contextlib.contextmanager
def replay_without_sync(sync_errors):
    """Each replay call of the diamond paths (`search.diamond._replay`)
    inside the block runs under `sync_errors()`: the replay itself issues
    no host sync (the staged path around it still branches on the host
    once a level)."""
    from motionestimation_tpu_torch.search import diamond

    real = diamond._replay

    def checked(*a, **kw):
        with sync_errors():
            return real(*a, **kw)

    diamond._replay = checked
    try:
        yield
    finally:
        diamond._replay = real


@contextlib.contextmanager
def lazy_without_sync(sync_errors):
    """Each call of the lazy mode (`search.diamond._diamond_lazy`) inside
    the block runs under `sync_errors()`: on the card it issues no host
    sync."""
    from motionestimation_tpu_torch.search import diamond

    real = diamond._diamond_lazy

    def checked(*a, **kw):
        with sync_errors():
            return real(*a, **kw)

    diamond._diamond_lazy = checked
    try:
        yield
    finally:
        diamond._diamond_lazy = real


def lazy_phase(work, contents, dev, card, counted, sync_errors, compare,
               cuda_ms):
    """The lazy mode's main path (LAZY_RUNS): each case once through its
    entry, counted (one `me_diamond_walk` launch and no other kernel), with
    no golden plane, no plain replay and no host sync in the lazy mode; then
    `walk_cuda` against its plain version `lazy_plain` on the card (MVs,
    costs or scores and trajectories bit for bit), the entry's output
    against the plain version's, and the timing: the kernel's device time,
    the whole call's and the plain version's ms, the evaluations and the
    bound (`bench/roofline.walk_bound`), and at 4K 8x8 +-31 the peak memory
    of the call beside the plain version's. Fails where no early-term case
    stopped a block (`bench/roofline.walk_terminated`). Returns {label:
    (kernel ms, plain ms, bound ms, bound by)}."""
    from motionestimation_tpu_torch import cli
    from motionestimation_tpu_torch.bench import measure, roofline
    from motionestimation_tpu_torch.core import frames as frames_lib
    from motionestimation_tpu_torch.core.config import SearchConfig
    from motionestimation_tpu_torch.kernels import diamond_cuda as dc
    from motionestimation_tpu_torch.pipeline import runner
    from motionestimation_tpu_torch.search import diamond

    # W's instances: one team shape and block placement a blk range.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for metric in ("mse", "sad", "ssim"):
        for blk, blks in WALK_SHAPES:
            occ = dc.walk_occupancy(blk, metric)
            print(f"me_diamond_walk {metric} at blk {blks}: "
                  f"{occ['team_threads']} threads a walk, "
                  f"{occ['walks_per_block']} walks a CUDA block; "
                  f"{occ['registers']} registers and {occ['local_bytes']} "
                  f"bytes of local memory (spills) per thread; "
                  f"{occ['blocks_per_sm']} CUDA blocks "
                  f"({occ['warps_per_sm']} warps) resident per SM, "
                  f"{occ['walks_per_sm'] * sms} walks in flight on {sms} "
                  f"SMs")
    out = {}
    stopped = 0  # blocks the early check stopped, over the early-term cases
    for label, entry, content, blk, span, metric, early, mode in LAZY_RUNS:
        cur, ref = contents[content]
        h, w = cur.shape
        cur_t, ref_t = (torch.from_numpy(a).to(dev) for a in (cur, ref))
        kw = dict(blk_dim=blk, span=span, metric=metric, early_term=early,
                  max_steps=diamond.default_max_steps(span))
        what = f"diamond {label}"
        print(f"== main path ({what}): {entry}, volume_mode {mode!r}, "
              f"{content} content")
        out_dir = os.path.join(work, "lazy_" + content + f"_{blk}_{span}")
        with counted({"me_diamond_walk": 1}, f"main path ({what})"), \
                no_plain_path(what), lazy_without_sync(sync_errors):
            if entry == "frame":
                got_main = diamond.diamond_search_frame(
                    cur_t, ref_t, record_trajectory=True, volume_mode=mode,
                    device=dev, **kw)
            elif entry == "run_pair":
                res = runner.run_pair(cur, ref, SearchConfig(
                    blk_dim=blk, span=span, metric=metric,
                    algorithm="diamond", early_term=early, frame_width=w,
                    frame_height=h), device=dev)
            else:
                paths = [os.path.join(work, f"{n}_{content}.yuv")
                         for n in ("cur", "ref")]
                cur.tofile(paths[0])
                ref.tofile(paths[1])
                run_cli(cli, [*paths, out_dir, str(blk), str(span), str(w),
                              str(h), "--device", "cuda", "--metric", metric,
                              "--algorithm", "diamond", "--timing-row"])
        # The kernel against its plain version, the pass loop on the card.
        want, want_traj = diamond.lazy_plain(cur_t, ref_t,
                                             record_trajectory=True, **kw)
        got, got_traj = dc.walk_cuda(cur_t, ref_t, record_trajectory=True,
                                     **kw)
        compare(["me_diamond_walk"], [*got, got_traj], [*want, want_traj],
                f"me_diamond_walk {label}: fields and trajectory vs "
                f"lazy_plain")
        if entry == "frame":
            field, traj = got_main
            equal_fields(field, want, what)
            if not torch.equal(traj, want_traj):
                fail(f"{what}: trajectory differs from lazy_plain's")
        elif entry == "run_pair":
            for name, a, b in zip(want._fields, res.field, want):
                if not np.array_equal(a, b.cpu().numpy()):
                    fail(f"{what}: run_pair's {name} differs from "
                         f"lazy_plain's")
        else:
            check_stack(out_dir, cur, ref, want, blk, span, label,
                        frames_lib)
        moved = int(((want.mv_y != 0) | (want.mv_x != 0)).sum())
        print(f"{what}: the entry's output equals lazy_plain's; {moved} of "
              f"{want.mv_y.numel()} blocks moved")

        # Timing: the kernel alone in a profiled pass, the whole call and the
        # plain version (CUDA events; the calls queued behind a sleep).
        walk = functools.partial(dc.walk_cuda, cur_t, ref_t,
                                 record_trajectory=False, **kw)
        walk()  # warm-up
        prof = measure.profile_pass(walk, 10, dev)
        kernel_ms = next(ms for name, (_, ms) in prof.kernels.items()
                         if "walk_kernel" in name)
        call = functools.partial(
            diamond.diamond_search_frame, cur_t, ref_t, volume_mode=mode,
            device=dev, **kw)
        call_ms = [cuda_ms(call, 10) for _ in range(3)]
        plain = functools.partial(diamond.lazy_plain, cur_t, ref_t,
                                  record_trajectory=False, **kw)
        plain_ms = [cuda_ms(plain, 1) for _ in range(3)]
        count = (np.minimum(blk, h - np.arange(0, h, blk))[:, None]
                 * np.minimum(blk, w - np.arange(0, w, blk))[None, :])
        traj_np = got_traj.cpu().numpy()
        cost = (got.score if metric == "ssim" else got.best_cost_i32)
        terminated = roofline.walk_terminated(
            got.mv_y.cpu().numpy(), got.mv_x.cpu().numpy(),
            cost.cpu().numpy(), traj_np, early_term=early, count=count,
            minimise=metric != "ssim")
        stopped += int(terminated.sum())
        block_evals, pixel_evals = roofline.walk_evals(
            traj_np, span=span, blk_dim=blk, frame_height=h, frame_width=w,
            terminated=terminated)
        bound_ms, bound_by = roofline.walk_bound(
            h, w, nblocks=got.mv_y.numel(), block_evals=block_evals,
            pixel_evals=pixel_evals, metric=metric)
        print(f"  {label}: me_diamond_walk {kernel_ms:.4f} ms (device time, "
              f"mean of 10 launches in a profiled pass; "
              f"{prof.device_ops:g} operations on the card a walk_cuda "
              f"call); the lazy call ({mode}) median "
              f"{statistics.median(call_ms):.4f} ms (runs "
              f"{[round(t, 4) for t in call_ms]}, 10 calls each behind a "
              f"sleep); lazy_plain median {statistics.median(plain_ms):.4f}"
              f" ms (runs {[round(t, 4) for t in plain_ms]}); "
              f"{block_evals} block-candidates ({pixel_evals} "
              f"pixel-candidates) evaluated, {int(terminated.sum())} blocks "
              f"stopped early; bound {bound_ms:.6f} ms ({bound_by}), the "
              f"kernel at {bound_ms / kernel_ms:.1%} of it | {card}")
        if (blk, span) == (8, 31):
            peaks = {}
            for name, fn in (("lazy call", call), ("lazy_plain", plain)):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                peaks[name] = torch.cuda.max_memory_allocated() - base
            print(f"  {label}: peak memory above the frames "
                  f"{peaks['lazy call'] / 1e6:.3f} MB for the lazy call, "
                  f"{peaks['lazy_plain'] / 1e6:.3f} MB for lazy_plain (a "
                  f"[{(2 * span + 1) ** 2}, {got.mv_y.shape[0]}, "
                  f"{got.mv_y.shape[1]}] volume) | {card}")
        out[label] = (kernel_ms, statistics.median(plain_ms), bound_ms,
                      bound_by)
    if stopped == 0:
        fail("lazy phase: the early check stopped no block in any early-term "
             "case, so the kernel's early stop never ran")
    return out


def check_dumps(got, want, what):
    """Every key of every dump equal to the other set's, dtypes included."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} dumps, expected {len(want)}")
    for a, b in zip(got, want):
        za, zb = np.load(a), np.load(b)
        if sorted(za.files) != sorted(zb.files) or not all(
                za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])
                for k in zb.files):
            fail(f"{what}: {os.path.basename(a)} differs from run_gop's")


def sharded_phase(work, gop, pairs, diamond_pair, dev, card, counted,
                  reset_counts, counts, sync_errors):
    """The sharded main path on slot meshes of the card (checks) and the
    overhead of tiling on one card; see the module docstring. `gop` is the
    GOP phase's (frame paths, run_gop dump directory, config, pinned h2d
    MB/s), `pairs` the
    main path's frames by (height, width), `diamond_pair` the config3
    frames; `counted` as in `gop_phase`, `reset_counts()` sets every launch
    count to 0 and `counts()` returns the counts above 0 by name;
    `sync_errors()` makes a synchronising call raise inside it. Returns
    the median ms a frame of `sharded_full_search` on the (1, 2, 2) mesh
    at the first SHARDED_RUNS cell."""
    from motionestimation_tpu_torch.bench.measure import EMIT
    from motionestimation_tpu_torch.kernels import full_search_cuda as kc
    from motionestimation_tpu_torch.kernels import ssim_cuda as sc
    from motionestimation_tpu_torch.parallel import halo, ingest, make_mesh
    from motionestimation_tpu_torch.parallel import sharded
    from motionestimation_tpu_torch.pipeline import runner
    from motionestimation_tpu_torch.search import diamond
    from motionestimation_tpu_torch.search import full_search as fs

    def mesh_of(shape):
        return make_mesh(*shape, devices=[dev] * int(np.prod(shape)))

    @contextlib.contextmanager
    def collectives(expected, what):
        """Counts the torch.distributed calls of the block (`halo.COLLECTIVES`,
        set to 0 before it), prints them and fails unless they equal
        `expected` ({}: one process, whose slots exchange and gather by
        copies)."""
        halo.COLLECTIVES.clear()
        yield
        got = dict(halo.COLLECTIVES)
        print(f"{what} collectives: {got or 'none (one process: copies)'}")
        if got != expected:
            fail(f"{what}: collectives {got}, expected {expected}")

    def same(got, want, what):
        for name, a, b in zip(("mv_y", "mv_x", "cost", "comp"), got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"{what}: {name} differs from the unsharded path")

    frame_wants = {}
    for label, shape, h, w, blk, span, metric, per_frame in SHARDED_RUNS:
        if label.startswith("multi-hop"):
            rng = np.random.default_rng(h + w + span)
            ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
            cur = np.clip(np.roll(ref, (5, -9), (0, 1)).astype(np.int32)
                          + rng.integers(-3, 4, (h, w)), 0, 255
                          ).astype(np.uint8)
        else:
            cur, ref = pairs[h, w]
        mesh = mesh_of(shape)
        print(f"== main path (sharded {label}): sharded_full_search on a "
              f"{shape} mesh of {dev} slots")
        with counted(per_frame, f"sharded {label}"), \
                no_plain_path(f"sharded {label}"), \
                collectives({}, f"sharded {label}"):
            got = sharded.sharded_full_search(cur, ref, mesh=mesh,
                                              blk_dim=blk, span=span,
                                              metric=metric)
            torch.cuda.synchronize()
        if metric == "ssim":
            want = sc.ssim_search_frame_cuda(cur, ref, blk_dim=blk,
                                             span=span, device=dev)
            cost = want.score
        else:
            want = kc.full_search_frame_cuda(cur, ref, blk_dim=blk,
                                             span=span, metric=metric,
                                             device=dev)
            cost = want.best_cost_i32
        comp = fs.compensate_frame(torch.from_numpy(ref).to(dev), want,
                                   frame_height=h, frame_width=w,
                                   blk_dim=blk, span=span)
        same(got, (want.mv_y, want.mv_x, cost, comp), f"sharded {label}")
        print(f"sharded {label}: MVs, costs and compensated frame equal the "
              f"unsharded frame entry's")
        frame_wants[label] = (want.mv_y, want.mv_x, cost, comp)

    h, w, blk, span = DIAMOND
    cur, ref = diamond_pair
    for early_term in (None, 2.0):
        label = f"diamond mse{'' if early_term is None else ' early-term 2.0'}"
        print(f"== main path (sharded {label}): sharded_motion_step "
              f"algorithm='diamond' at {w}x{h} {blk}x{blk} +-{span} on "
              f"config3 content, (1, 2, 2) mesh of {dev} slots")
        kernels = ("me_phase_search", "me_int_search")
        reset_counts()
        with no_plain_path(f"sharded {label}"), \
                replay_without_sync(sync_errors), \
                collectives({}, f"sharded {label}"):
            res = sharded.gather(sharded.sharded_motion_step(
                cur[None], ref[None], mesh=mesh_of((1, 2, 2)), blk_dim=blk,
                span=span, frame_height=h, frame_width=w,
                algorithm="diamond", early_term=early_term))
            torch.cuda.synchronize()
        got = counts()
        print(f"sharded {label} launches: {got}")
        # Every tile holds whole blocks: one interior emit and one replay a
        # level it replays.
        if set(got) != {n + e for n in kernels for e in ("", EMIT)} | {
                "me_diamond_replay"} or any(
                got[n] != got[n + EMIT] for n in kernels) or (
                got["me_diamond_replay"] != got["me_phase_search" + EMIT]):
            fail(f"sharded {label}: launches {got}, expected the phase and "
                 f"int kernels' emit modes alone and one replay a level")
        want = diamond.diamond_search_frame(cur, ref, blk_dim=blk, span=span,
                                            early_term=early_term, device=dev)
        nby, nbx = want.mv_y.shape
        comp = fs.compensate_frame(torch.from_numpy(ref).to(dev), want,
                                   frame_height=h, frame_width=w,
                                   blk_dim=blk, span=span)
        same((res.mv_y[0, :nby, :nbx], res.mv_x[0, :nby, :nbx],
              res.best_cost[0, :nby, :nbx], res.comp[0, :h, :w]),
             (want.mv_y, want.mv_x, want.best_cost_i32, comp),
             f"sharded {label}")
        print(f"sharded {label}: MVs, costs and compensated frame equal "
              f"diamond_search_frame's")

    paths, gop_dir, config, _ = gop
    want = sorted(os.path.join(gop_dir, p) for p in os.listdir(gop_dir))
    pairs_n = len(paths) - 1
    runs = [(label, shape, pipelined, per_pair, None)
            for label, shape, pipelined, per_pair in SHARDED_GOPS]
    runs.append(("(1, 2, 2) pipelined, NCCL process group of one",
                 (1, 2, 2), True, 4, "nccl"))
    for label, shape, pipelined, per_pair, backend in runs:
        print(f"== main path (sharded GOP {label}): run_gop_sharded over the "
              f"{len(paths)}-frame {config.frame_width}x"
              f"{config.frame_height} {config.blk_dim}x{config.blk_dim} "
              f"+-{config.span} GOP")
        if backend:
            ingest.distributed_init(f"localhost:{free_port()}", 1, 0,
                                    backend=backend)
        try:
            mesh = mesh_of(shape)
            out_dir = os.path.join(work, "sharded_" + re.sub(r"\W+", "_",
                                                              label))
            # A chunk: 8 pairs pipelined, a "dp" batch per pair; under the
            # process group each gathers its grids to rank 0 in one
            # collective and reduces its stats in two.
            chunks = -(-pairs_n // (8 if pipelined else shape[0]))
            with counted({"me_phase_search": per_pair * pairs_n},
                         f"sharded GOP {label}"), \
                    no_plain_path(f"sharded GOP {label}"), \
                    collectives({"gather": chunks, "all_reduce": 2 * chunks}
                                if backend else {}, f"sharded GOP {label}"):
                got = runner.run_gop_sharded(paths, config, mesh=mesh,
                                             output_dir=out_dir,
                                             pipelined=pipelined)
            check_dumps(got, want, f"sharded GOP {label}")
            mtimes = [os.stat(p).st_mtime_ns for p in got]
            with counted({}, f"sharded GOP {label}, resumed"):
                runner.run_gop_sharded(paths, config, mesh=mesh,
                                       output_dir=out_dir,
                                       pipelined=pipelined)
            if [os.stat(p).st_mtime_ns for p in got] != mtimes:
                fail(f"sharded GOP {label}: a second call rewrote a dump")
            if backend:
                # The single pair's gather: to every rank, the compensated
                # frame included, in one collective.
                flabel, fshape, h, w, blk, span, metric, per_frame = (
                    SHARDED_RUNS[0])
                cur, ref = pairs[h, w]
                with counted(per_frame, f"sharded {flabel}, {backend}"), \
                        collectives({"all_gather_into_tensor": 1,
                                     "all_reduce": 2},
                                    f"sharded {flabel}, {backend}"):
                    fgot = sharded.sharded_full_search(
                        cur, ref, mesh=mesh_of(fshape), blk_dim=blk,
                        span=span, metric=metric)
                    torch.cuda.synchronize()
                same(fgot, frame_wants[flabel], f"sharded {flabel}, "
                     f"{backend}")
                print(f"sharded {flabel} in the {backend} process group of "
                      f"one: MVs, costs and compensated frame equal the "
                      f"unsharded frame entry's")
        finally:
            if backend:
                torch.distributed.destroy_process_group()
        print(f"sharded GOP {label}: {pairs_n} dumps equal run_gop's on "
              f"every key; a second call rewrote nothing")

    # -- the overhead of tiling on one card --------------------------------
    label, _, h, w, blk, span, _, _ = SHARDED_RUNS[0]
    cur_d, ref_d = (torch.from_numpy(x).to(dev) for x in pairs[h, w])
    fns = {"full_search_frame_cuda": lambda: kc.full_search_frame_cuda(
        cur_d, ref_d, blk_dim=blk, span=span, device=dev)}
    for shape in ((1, 1, 1), (1, 2, 2)):
        fns[f"sharded_full_search {shape}"] = (
            lambda m=mesh_of(shape): sharded.sharded_full_search(
                cur_d, ref_d, mesh=m, blk_dim=blk, span=span))
    times = {name: [] for name in fns}
    for fn in fns.values():
        for _ in range(3):
            fn()  # warm-up
    for _ in range(10):
        for name in [*fns, *reversed(fns)]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    print(f"sharded timing at {label} (frames on the card; host clock around "
          f"each call and a synchronize, 20 calls each in turns; one card: "
          f"tiling overhead, not scaling):")
    for name, ts in times.items():
        print(f"  {name}: median {statistics.median(ts):.4f} ms a frame "
              f"(min {min(ts):.4f}, max {max(ts):.4f}) | {card}")
    sharded_ms = statistics.median(times["sharded_full_search (1, 2, 2)"])
    gop_fns = {"run_gop": lambda d: runner.run_gop(
        paths, config, output_dir=d, device=dev, resume=False)}
    for glabel, shape, pipelined in (("(1, 1, 1) pipelined", (1, 1, 1),
                                      True),
                                     ("(1, 2, 2) pipelined", (1, 2, 2),
                                      True),
                                     ("(1, 2, 2) per pair", (1, 2, 2),
                                      False)):
        gop_fns[f"run_gop_sharded {glabel}"] = (
            lambda d, m=mesh_of(shape), p=pipelined: runner.run_gop_sharded(
                paths, config, mesh=m, output_dir=d, resume=False,
                pipelined=p))
    timed_dir = os.path.join(work, "sharded_timed")
    for name, fn in gop_fns.items():
        fn(timed_dir)  # warm-up
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(timed_dir)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"  {name} over {pairs_n} pairs: best of 3 "
              f"{pairs_n / min(walls):.2f} pairs/s (runs "
              f"{[round(pairs_n / t, 2) for t in walls]}, resume=False, after "
              f"one warm-up) | {card}")
    return sharded_ms


def dryrun_launches(n):
    """Each kernel's launches in the three sharded steps of
    `dryrun_multichip(n)`, counted from its tiles: for every pair, a tile
    whose in-frame part holds whole blocks launches its interior kernel
    once (phase; fast SSIM), and each truncated slab it holds (bottom,
    right) the truncated-extent kernel once (int; SSIM). The MSE step
    searches, diamond emits one volume a tile and replays it once (span 9
    has one level), the SSIM step searches; the phase and int counts hold
    their emit launches too."""
    from motionestimation_tpu_torch import graft_entry
    from motionestimation_tpu_torch.core.geometry import cdiv
    from motionestimation_tpu_torch.search.diamond import _staged_levels

    g = graft_entry.dryrun_geometry(n)
    blk, h, w = g["blk_dim"], g["h"], g["w"]
    tile_h, tile_w = cdiv(h, blk * g["ty"]) * blk, cdiv(w, blk * g["tx"]) * blk
    interior = slabs = 0
    for i in range(g["ty"]):
        for j in range(g["tx"]):
            h_in = max(0, min(tile_h, h - i * tile_h))
            w_in = max(0, min(tile_w, w - j * tile_w))
            interior += h_in >= blk and w_in >= blk
            slabs += bool(h_in % blk and w_in) + bool(w_in % blk and h_in)
    interior, slabs = interior * g["batch"], slabs * g["batch"]
    if len(_staged_levels(g["span"])) != 1:
        fail(f"dryrun_launches: span {g['span']} replays more than one level")
    return {"me_diamond_replay": g["ty"] * g["tx"] * g["batch"],
            "me_phase_search": 2 * interior,
            "me_phase_search (emit)": interior,
            "me_int_search": 2 * slabs, "me_int_search (emit)": slabs,
            "me_ssim_fast_search": interior, "me_ssim_search": slabs}


def graft_phase(dev, card, counted):
    """`graft_entry.entry()` and `dryrun_multichip(8)` on the card, counted,
    and the SSIM demo; see the module docstring. `counted` as in
    `gop_phase`."""
    import importlib.util

    from motionestimation_tpu_torch import graft_entry
    from motionestimation_tpu_torch.search import full_search as fs

    print("== main path (graft entry): entry() on the card")
    step, (cur, ref) = graft_entry.entry()
    with counted({"me_phase_search": 1}, "entry()"), no_plain_path("entry()"):
        got = step(cur, ref)
        torch.cuda.synchronize()
    want = fs.full_search_frame(cur, ref, blk_dim=16, span=7, metric="mse")
    want = (want.mv_y, want.mv_x, want.best_cost_i32, fs.compensate_frame(
        ref, want, frame_height=288, frame_width=352, blk_dim=16, span=7))
    for name, a, b in zip(("mv_y", "mv_x", "cost", "comp"), got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"entry(): {name} differs from the plain golden path")
    print(f"entry(): CIF 16x16 +-7 MSE step on {cur.device}, MVs, costs and "
          f"comp {tuple(got[3].shape)} equal the plain golden path's")

    n = 8
    print(f"== main path (multi-slot dry run): dryrun_multichip({n}) on "
          f"{min(n, torch.cuda.device_count())} card(s)")
    # The counts cover the sharded steps alone: the unsharded runs they are
    # held against launch the same kernels outside the window.
    t0 = time.perf_counter()
    with no_plain_path(f"dryrun_multichip({n})"):
        summary = graft_entry.dryrun_multichip(n, around_sharded=counted(
            dryrun_launches(n), f"dryrun_multichip({n}) sharded steps"))
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"{summary} ({seconds:.1f} s) | {card}")

    spec = importlib.util.spec_from_file_location(
        "ssim_demo_torch", os.path.join(ROOT, "examples", "ssim_demo_torch.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = demo.main(["0"])
    lines = out.getvalue().splitlines()
    a, b = demo.blocks(0)
    value = float(demo.ssim_unbiased(torch.from_numpy(a).to(dev),
                                     torch.from_numpy(b).to(dev)))
    # The same formula in float64 on the host, as the tolerance's yardstick.
    a, b = a.astype(np.float64), b.astype(np.float64)
    mu_a, mu_b = a.mean(), b.mean()
    s_a, s_b = a.std(ddof=1), b.std(ddof=1)
    s_ab = ((a - mu_a) * (b - mu_b)).sum() / (a.size - 1)
    exact = ((2 * mu_a * mu_b + 2) / (mu_a**2 + mu_b**2 + 2)
             * (2 * s_a * s_b + 2) / (s_a**2 + s_b**2 + 2)
             * (s_ab + 1) / (s_a * s_b + 1))
    if (rc != 0 or lines != [f"SSIM VALUE OBTAINED IS {value:f} ",
                             "(self-SSIM sanity: 1.000000)"]
            or abs(value - exact) > 1e-6):
        fail(f"ssim_demo_torch: {lines} (float64 value {exact})")
    print(f"ssim_demo_torch on the card: {lines}, |float32 - float64| = "
          f"{abs(value - exact):.3g} (tolerance 1e-6)")


def free_port() -> int:
    """A free TCP port on this machine, for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def diamond_reference(best, volume, *, span, crossover, **kw):
    """(field, trajectory or None, escaped or None): the canonical replay
    over the golden volume, as `diamond_search_frame` must give it; with
    `crossover`, the replay over the first staged level, the golden full
    search's field (`best`) on the blocks that escape it. The replay is the
    kernel's plain version, `replay_plain`."""
    from motionestimation_tpu_torch.kernels import diamond_cuda as dc
    from motionestimation_tpu_torch.search import diamond

    if not crossover:
        want, want_traj, _ = dc.replay_plain(volume, span=span,
                                             record_trajectory=True, **kw)
        return want, want_traj, None
    r, k = diamond._staged_levels(span)[0], 2 * span + 1
    level = volume.view(k, k, *volume.shape[1:])[
        span - r : span + r + 1, span - r : span + r + 1]
    want, _, esc = dc.replay_plain(
        level.reshape(-1, *volume.shape[1:]).contiguous(), span=r,
        record_trajectory=False, track_escape=True, **kw)
    return diamond._merge(esc, best, want), None, esc


def replay_resources(log):
    """{("int" or "float", D): "N registers, N bytes stack frame, N bytes
    spill stores, N bytes spill loads"}: ptxas's lines for each instance of
    `me_diamond_replay` (D: LDSP rounds a trip, 0 for a round a load) in
    the build log of csrc/diamond.cu."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"replay_kernelI([if])Li(\d+)E", entry or "")
        if m is None:
            continue
        kind = ("float" if m.group(1) == "f" else "int", int(m.group(2)))
        if "stack frame" in line:
            out[kind] = line.strip()
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[kind] = f"{regs} registers, " + out.get(kind, "")
    return out


def replay_checks(contents, dev, compare, seed):
    """`me_diamond_replay` against `replay_plain` on the card, bit for bit
    (fields, trajectories and escape masks): at every staged level of the
    config3 MSE, SAD, SSIM and MSE early-term 2.0 cells and of the
    adversarial content (which escalates), with and without the
    trajectory; on a tile at a nonzero origin that holds the frame's
    truncated bottom block row (the volumes of `diamond_search_tile`);
    at 4K 8x8 +-15 (129,600 blocks a plane, the kernel's instance that
    walks a round a load); and on the 4K 32x32 +-31 worst case's first
    level. `compare` records the largest difference. Returns the number of
    checks."""
    import torch.nn.functional as F

    from motionestimation_tpu_torch.kernels import diamond_cuda as dc
    from motionestimation_tpu_torch.kernels import full_search_cuda as kc
    from motionestimation_tpu_torch.kernels import ssim_cuda as sc
    from motionestimation_tpu_torch.search import diamond

    checks = 0

    def check(volume, what, search_span, **kw):
        nonlocal checks
        kw["max_steps"] = diamond.default_max_steps(search_span)
        for record in (True, False):
            got = dc.replay_cuda(volume, record_trajectory=record, **kw)
            want = dc.replay_plain(volume, record_trajectory=record, **kw)
            compare(["me_diamond_replay"],
                    [*got[0], *(t for t in got[1:] if t is not None)],
                    [*want[0], *(t for t in want[1:] if t is not None)],
                    f"me_diamond_replay {what}"
                    f"{', trajectory' if record else ''}: "
                    f"{int(want[2].sum())} blocks escape", quiet=True)
            checks += 1

    h, w, blk, span = DIAMOND
    levels = diamond._staged_levels(span)
    for content, metric, early in (
            ("config3", "mse", None), ("config3", "sad", None),
            ("config3", "ssim", None), ("config3", "mse", 2.0),
            ("adversarial", "mse", None)):
        cur, ref = (torch.from_numpy(a).to(dev) for a in contents[content])
        for r in levels:
            volume = (sc.ssim_volume_cuda(cur, ref, blk_dim=blk, span=r,
                                          device=dev) if metric == "ssim"
                      else kc.full_search_volume_cuda(
                          cur, ref, blk_dim=blk, span=r, metric=metric,
                          device=dev))
            check(volume, f"{content} {metric} early-term {early} level {r}",
                  blk_dim=blk, span=r, search_span=span, metric=metric,
                  early_term=early, frame_height=h, frame_width=w,
                  track_escape=r < span)

    # The bottom-right tile of a (2, 2) split of the config3 frame: origin
    # (544, 960), its last block row truncated to 8 of 16 rows.
    cur, ref = (torch.from_numpy(a).to(dev) for a in contents["config3"])
    hp, wp = (-(-n // (2 * blk)) * 2 * blk for n in (h, w))
    y0, x0 = hp // 2, wp // 2
    cur_tile = F.pad(cur, (0, wp - w, 0, hp - h))[y0:, x0:]
    th, tw = cur_tile.shape
    ref_halo = F.pad(ref, (span, span + wp - w, span, span + hp - h))[
        y0 : y0 + th + 2 * span, x0 : x0 + tw + 2 * span]
    for early in (None, 2.0):
        for r in levels:
            rh = ref_halo[span - r : span - r + th + 2 * r,
                          span - r : span - r + tw + 2 * r]
            volume = kc.full_search_volume_tile_cuda(
                cur_tile, rh, y0, x0, frame_height=h, frame_width=w,
                blk_dim=blk, span=r)
            check(volume, f"tile at ({y0}, {x0}) {th}x{tw} mse early-term "
                  f"{early} level {r}", blk_dim=blk, span=r,
                  search_span=span, metric="mse", early_term=early,
                  frame_height=h, frame_width=w, track_escape=r < span,
                  y_origin=y0, x_origin=x0)

    # A plane of 129,600 blocks (4K 8x8 +-15), which the kernel walks one
    # round a load: the first level, MSE and SSIM, and the full span.
    cur, ref = (torch.from_numpy(a).to(dev) for a in contents["4K"])
    for metric, r in (("mse", 6), ("ssim", 6), ("mse", 15)):
        volume = (sc.ssim_volume_cuda(cur, ref, blk_dim=8, span=r,
                                      device=dev) if metric == "ssim"
                  else kc.full_search_volume_cuda(cur, ref, blk_dim=8,
                                                  span=r, device=dev))
        check(volume, f"4K 8x8 +-15 {metric} level {r}", blk_dim=8, span=r,
              search_span=15, metric=metric, early_term=None,
              frame_height=2160, frame_width=3840, track_escape=r < 15)
        del volume

    # The 4K worst case's first level (bench/matrix.py diamond-worstcase-4k).
    h4, w4, blk4, span4 = 2160, 3840, 32, 31
    cur, ref = (torch.from_numpy(a).to(dev) for a in synth(
        np.random.default_rng(seed + 1), h4, w4, shift=(28, -28), noise=2))
    r = diamond._staged_levels(span4)[0]
    volume = kc.full_search_volume_cuda(cur, ref, blk_dim=blk4, span=r,
                                        device=dev)
    check(volume, f"4K {blk4}x{blk4} +-{span4} adversarial level {r}",
          blk_dim=blk4, span=r, search_span=span4, metric="mse",
          early_term=None, frame_height=h4, frame_width=w4,
          track_escape=True)
    return checks


def equal_fields(got, want, what):
    """Every field of two MotionFields equal, dtypes included."""
    for name, a, b in zip(want._fields, got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"{what}: {name} differs from the plain golden path")


def bench_phase(work, dev, card):
    """The bench main path; see the module docstring."""
    import bench_torch
    from motionestimation_tpu_torch.bench import __main__ as bench_main
    from motionestimation_tpu_torch.bench import matrix, regression
    from motionestimation_tpu_torch.kernels import diamond_cuda as dc
    from motionestimation_tpu_torch.search import diamond
    from motionestimation_tpu_torch.search import full_search as fs

    frames_dir = os.path.join(work, "frames")
    os.makedirs(frames_dir)
    planes = np.fromfile(os.path.join(FIXTURES, "foreman_mse_8_12",
                                      "output.yuv"), np.uint8)
    planes = planes.reshape(5, 288, 352)
    planes[1].tofile(os.path.join(frames_dir, "ForemanYF4.yuv"))
    planes[0].tofile(os.path.join(frames_dir, "ForemanYF1.yuv"))
    results = os.path.join(work, "results")
    t0 = time.perf_counter()
    for version in (1, 2):
        print(f"== main path (bench -v {version}): python -m "
              f"motionestimation_tpu_torch.bench -v {version} --frames-dir "
              f"(Foreman F4/F1 from the fixture's planes; Jockey and Beauty "
              f"synthetic)")
        rc = bench_main.main(["-v", str(version), "--results-dir", results,
                              "--frames-dir", frames_dir])
        print(f"bench -v {version}: exit {rc}"
              + (" (a timing flag between two back-to-back runs is a "
                 "measurement)" if rc else ""))
    v1, v2 = (regression.read_rows(results, v, 3) for v in (1, 2))
    if f"{v1[0][4]:.6f}" != "31.816000":
        fail(f"bench -v 1: Foreman PSNR {v1[0][4]:.6f}, expected 31.816000")
    if [r[4] for r in v2] != [r[4] for r in v1]:
        fail(f"bench: v2's PSNR column {[r[4] for r in v2]} differs from "
             f"v1's {[r[4] for r in v1]}")
    print(f"bench: Foreman PSNR 31.816000; v2's PSNR column equals v1's "
          f"{[r[4] for r in v1]}; {time.perf_counter() - t0:.1f} s")

    print("== main path (bench --matrix): run_matrix into a temp dir, each "
          "row's first call held against the plain golden path on the card")
    golden = {}  # the last (frames, metric, blk, span) -> (field, volume)

    def check_row(row, cur, ref, field):
        what = f"matrix {row.tag.split(':')[0]}"
        if row.entry in ("full", "ssim"):
            equal_fields(field, fs.full_search_frame(
                cur, ref, blk_dim=row.blk, span=row.span, metric=row.metric),
                what)
            print(f"{what}: MVs, costs and scores equal the golden search's")
            return
        key = (row.frames, row.metric, row.blk, row.span)
        if key not in golden:
            golden.clear()
            golden[key] = fs.full_search_frame(
                cur, ref, blk_dim=row.blk, span=row.span, metric=row.metric,
                return_cost_volume=True)
        best, volume = golden[key]
        h, w = cur.shape
        kw = dict(blk_dim=row.blk, metric=row.metric,
                  early_term=row.early_term,
                  max_steps=diamond.default_max_steps(row.span),
                  frame_height=h, frame_width=w)
        crossover = row.escape_policy == "crossover"
        want, want_traj, esc = diamond_reference(
            best, volume, span=row.span, crossover=crossover, **kw)
        equal_fields(field, want, what)
        if crossover:
            if not esc.any():
                fail(f"{what}: no block escaped the first level")
            print(f"{what}: MVs and costs equal the replay over the golden "
                  f"volume, the golden search's on the {int(esc.sum())} "
                  f"escaped blocks")
            return
        # The staged and full modes replay on the kernel once a level; the
        # lazy mode is one walk launch with no replay and no golden plane.
        lazy = row.entry == "lazy"
        before = dc.replay_cuda.launches, dc.walk_cuda.launches
        with no_plain_path(what, search=lazy):
            _, traj = diamond.diamond_search_frame(
                cur, ref, blk_dim=row.blk, span=row.span, metric=row.metric,
                early_term=row.early_term, record_trajectory=True,
                volume_mode={"staged": "staged", "lazy": "lazy",
                             "volume": "full"}[row.entry], device=dev)
        if not torch.equal(traj, want_traj):
            fail(f"{what}: trajectory differs from the replay over the golden "
                 f"volume")
        replays = dc.replay_cuda.launches - before[0]
        walks = dc.walk_cuda.launches - before[1]
        if not ((replays, walks) == (0, 1) if lazy
                else replays > 0 and walks == 0):
            fail(f"{what}: me_diamond_replay launched {replays} times, "
                 f"me_diamond_walk {walks}")
        print(f"{what}: MVs, costs or scores and trajectories equal the "
              f"replay over the golden volume; "
              + ("me_diamond_walk launched once, no replay, no golden plane"
                 if lazy else f"me_diamond_replay launched {replays} times, "
                 f"no plain replay"))

    out_dir = os.path.join(work, "matrix")
    t0 = time.perf_counter()
    matrix.run_matrix(1, out_dir, frames_dir=frames_dir, device=dev,
                      on_first=check_row)
    with open(os.path.join(out_dir, "v1.txt")) as f:
        text = f.read()
    rows = dict(re.findall(r"\[ (.+?) \]\nkernel ([\d.]+) ms", text))
    want_tags = [t for t in matrix.TAGS if not t.startswith("config1:")]
    if list(rows) != want_tags:
        fail(f"matrix: rows {list(rows)}, expected {want_tags}")
    if not all(0 < float(v) < float("inf") for v in rows.values()):
        fail(f"matrix: a row is not a positive time: {rows}")
    print(f"matrix: {len(rows)} rows of {len(matrix.TAGS)} (config1 left out: "
          f"no ForemanYF2.yuv), {time.perf_counter() - t0:.1f} s | {card}")

    print("== main path (bench_torch.main())")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_torch.main([])
    line = buf.getvalue().strip().splitlines()[-1]
    print(line)
    result = json.loads(line)
    numbers = [v for v in result.values() if isinstance(v, (int, float))]
    if rc or not all(np.isfinite(numbers)):
        fail(f"bench_torch: exit {rc} or a number that is not finite")
    if not 0 < result["pct_of_roofline"] <= 100:
        fail(f"bench_torch: pct_of_roofline {result['pct_of_roofline']}")
    print(f"bench_torch: {time.perf_counter() - t0:.1f} s")


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
    from motionestimation_tpu_torch.bench import measure
    from motionestimation_tpu_torch.bench.roofline import bound
    from motionestimation_tpu_torch.bench.roofline import lab_bound
    from motionestimation_tpu_torch.bench.roofline import lab_parts
    from motionestimation_tpu_torch.bench.roofline import LAB_OPS
    from motionestimation_tpu_torch.bench.roofline import replay_bound
    from motionestimation_tpu_torch.bench.roofline import replay_reads
    from motionestimation_tpu_torch.bench.roofline import valid_candidates
    from motionestimation_tpu_torch.core import frames as frames_lib
    from motionestimation_tpu_torch.core.config import SearchConfig
    from motionestimation_tpu_torch.kernels import _build
    from motionestimation_tpu_torch.kernels import diamond_cuda as dc
    from motionestimation_tpu_torch.kernels import full_search_cuda as kc
    from motionestimation_tpu_torch.kernels import lab_cuda as lab
    from motionestimation_tpu_torch.kernels import ssim_cuda as sc
    from motionestimation_tpu_torch.pipeline import runner
    from motionestimation_tpu_torch.search import diamond
    from motionestimation_tpu_torch.search import full_search as fs
    from motionestimation_tpu_torch import io_native
    from motionestimation_tpu_torch.parallel import scaling
    from motionestimation_tpu_torch.tools import kern_lab, kernel_turns
    from motionestimation_tpu_torch.tools import record_scaling, verify_card
    from motionestimation_tpu_torch.tools import vpu_peak

    synthetic_pair, cuda_ms = kernel_turns.synthetic_pair, kernel_turns.cuda_ms

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = measure.card()
    props = torch.cuda.get_device_properties(0)
    max_clock_mhz = float(measure.smi("clocks.max.sm").split()[0])
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
    replay_ptxas = replay_resources(built.get("diamond", (0, ""))[1])
    occupancies = [
        (f"me_chunked_search at {label}", kc.chunked_occupancy(blk, span,
                                                               w // blk))
        for label, h, w, blk, span in (CHUNKED_CONFIGS[0], U8_CONFIG,
                                       CONFIGS[2], VOLUME_CONFIGS[2][:5])]
    occupancies += [
        (f"me_phase_search {metric} at {label}",
         kc.phase_occupancy(blk, span, metric, w // blk))
        for label, h, w, blk, span in (U8_CONFIG, CONFIGS[2], WIDE_CONFIG)
        for metric in ("mse", "sad")]
    occupancies += [
        (f"me_wide_search at {label}", kc.wide_occupancy(blk, span, w // blk))
        for label, h, w, blk, span in (CONFIGS[4], WIDE_CONFIG)]
    occupancies += [
        (f"me_ssim_fast_search at {label}",
         sc.ssim_fast_occupancy(blk, span, w // blk))
        for label, h, w, blk, span in SSIM_CONFIGS]
    # The truncated-extent kernels: the whole-frame cells, and the slabs
    # of the 4K 7x7 +-15, 1080p 16x16 +-15 and 4K 32x32 +-7 cells.
    for metric, where, h, w, blk, span in (
        ("sad", "whole frame", 2160, 3840, 7, 15),
        ("mse", "bottom slab", 2160, 3840, 7, 15),
        ("mse", "right slab", 2160, 3840, 7, 15),
        ("mse", "bottom slab", 1080, 1920, 16, 15),
        ("ssim", "whole frame", 2160, 3840, 64, 15),
        ("ssim", "bottom slab", 1080, 1920, 16, 15),
        ("ssim", "bottom slab", 2160, 3840, 32, 7),
    ):
        nby, nbx = -(-h // blk), -(-w // blk)
        grid = {"whole frame": (nby, nbx), "bottom slab": (1, nbx),
                "right slab": (nby, 1)}[where]
        occ = (sc.ssim_occupancy(blk, span, *grid) if metric == "ssim"
               else kc.int_occupancy(blk, span, metric, *grid))
        name = "me_ssim_search" if metric == "ssim" else "me_int_search"
        occupancies.append((f"{name} {metric} at {w}x{h} {blk}x{blk} "
                            f"+-{span} {where} ({grid[0]}x{grid[1]})", occ))
    for what, occ in occupancies:
        print(f"{what}: {occ['registers']} registers and "
              f"{occ['local_bytes']} bytes of local memory (spills) per "
              f"thread, {occ['smem_bytes']} B of shared memory for "
              f"{occ['tbx']} macroblocks per CUDA block, "
              f"{occ['blocks_per_sm']} CUDA blocks ({occ['warps_per_sm']} "
              f"warps) resident per SM")
    # name -> (wrapper, counter): a kernel's launches, and its emit mode's
    # launches (the launches with a volume) apart as "<launcher> (emit)".
    EMIT = measure.EMIT
    counters = measure.counters({
        **measure.WRAPPERS, "me_lab_peak": lab.lab_peak,
        "me_lab_chain": lab.lab_chain, "me_lab_phase": lab.lab_phase,
        "me_lab_diff": lab.lab_diff, "me_lab_padded": lab.lab_padded,
        "me_lab_p3": lab.lab_p3, "me_lab_p5": lab.lab_p5,
        "me_lab_p6": lab.lab_p6, "me_lab_p7": lab.lab_p7})
    mse_kernels = ("me_phase_search", "me_int_search")
    ssim_kernels = ("me_ssim_fast_search", "me_ssim_search")

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def launches(name):
        fn, attr = counters[name]
        return getattr(fn, attr)

    def read_counts(names, what):
        counts = {n: launches(n) for n in names}
        print(f"{what} launches: {counts}")
        if not all(v > 0 for v in counts.values()):
            fail(f"{what}: a kernel never launched: {counts}")
        return counts

    max_err = dict.fromkeys(counters, 0.0)

    def compare(kernel_names, got, want, what, quiet=False):
        """Exact equality of every entry (equal infinities count as equal),
        dtype and shape; records the largest difference. `quiet` prints
        nothing unless they differ."""
        err = max(float(torch.where(a == b, 0.0, (a.double() - b.double())
                                    .abs()).max())
                  if a.shape == b.shape and a.numel() else 0.0
                  for a, b in zip(got, want))
        for name in kernel_names:
            max_err[name] = max(max_err[name], err)
        if err or not quiet:
            print(f"{what}: max |kernel - plain| = {err}")
        if err or not all(a.dtype == b.dtype and torch.equal(a, b)
                          for a, b in zip(got, want)):
            fail(f"{what}: kernel disagrees with its plain version")

    def golden_search(cur, ref, **kw):
        return fs.full_search_frame(torch.from_numpy(cur).to(dev),
                                    torch.from_numpy(ref).to(dev), **kw)

    def time_run_pair(label, cur, ref, config):
        """run_pair's medians over --runs calls after 3 of warm-up, with the
        launches of one call."""
        for _ in range(3):
            runner.run_pair(cur, ref, config)
        reset_counts()
        runner.run_pair(cur, ref, config)
        per_frame = {n: launches(n) for n in counters if launches(n)}
        results = [runner.run_pair(cur, ref, config)
                   for _ in range(args.runs)]
        kernel_ms = statistics.median(r.kernel_ms for r in results)
        total_ms = statistics.median(r.total_ms for r in results)
        row = min(results, key=lambda r: abs(r.kernel_ms - kernel_ms))
        h, w, blk = config.frame_height, config.frame_width, config.blk_dim
        nblocks = -(-h // blk) * -(-w // blk)
        print(f"{label}: timing_row {row.timing_row} | search "
              f"{kernel_ms:.4f} ms, {nblocks / kernel_ms / 1e3:.3f} M "
              f"blocks/s, {1e3 / kernel_ms:.1f} fps (search), "
              f"{1e3 / total_ms:.1f} fps (total {total_ms:.4f} ms) | "
              f"launches/frame {per_frame} | {card}")

    @contextlib.contextmanager
    def counted(expected, what):
        """Every launch count set to 0 before the block; after it, each
        count named in `expected` equals its value and every other is 0."""
        reset_counts()
        yield
        counts = {n: launches(n) for n in counters if launches(n)}
        print(f"{what} launches: {counts}")
        if counts != {n: c for n, c in expected.items() if c}:
            fail(f"{what}: launches {counts}, expected {expected}")

    @contextlib.contextmanager
    def sync_errors():
        """A call that synchronises the host with the card raises inside."""
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as work:
        # -- 2. every fixture through the card route (verify_card) ---------
        print("== every fixture through the card route vs the plain path "
              "and the C reference's outputs (tools/verify_card.py)")
        t_fix = time.perf_counter()
        reset_counts()
        results = verify_card.verify(device=dev)
        failed = {n: d for n, d in results.items() if d}
        if failed:
            fail(f"verify_card: {failed}")
        read_counts(mse_kernels + ssim_kernels,
                    f"fixture runs ({len(results)} fixtures)")
        print(f"fixture phase: {time.perf_counter() - t_fix:.1f} s; frames "
              f"read and stacks written by {io_native.build().name}")

        # -- 3. the main paths at full size, counted -----------------------
        pairs = {}
        for label, h, w, blk, span in CONFIGS + SSIM_CONFIGS[:2]:
            if (h, w) not in pairs:
                pairs[h, w] = synthetic_pair(h, w, args.seed)
                pairs[h, w][0].tofile(os.path.join(work, f"cur_{h}.yuv"))
                pairs[h, w][1].tofile(os.path.join(work, f"ref_{h}.yuv"))
        # Each kernel's launches from the first main path that runs it.
        main_launches = {}
        # The whole-frame paths: each frame is one launch of the
        # truncated-extent kernel, and no interior kernel runs.
        whole = {"sad": {"me_int_search": 1, "me_phase_search": 0},
                 "ssim": {"me_ssim_search": 1, "me_ssim_fast_search": 0}}
        for path, metric, configs, names in (
            ("mse", "mse", CONFIGS[:2], mse_kernels),
            ("ssim", "ssim", SSIM_CONFIGS[:2], ssim_kernels),
            ("chunked mse", "mse", CHUNKED_CONFIGS[:1],
             ("me_chunked_search", "me_int_search")),
            ("wide mse", "mse", CHUNKED_CONFIGS[1:], ("me_wide_search",)),
            *((f"whole-frame {metric}", metric, [(label, h, w, blk, span)],
               tuple(n for n, c in whole[metric].items() if c))
              for label, h, w, blk, span, metric in WHOLE_CONFIGS),
        ):
            print(f"== main path ({path}): cli.main --device cuda at full "
                  f"size")
            out_dir = os.path.join(work, "main_" + path.replace(" ", "_"))
            reset_counts()
            for label, h, w, blk, span in configs:
                run_cli(cli, [
                    os.path.join(work, f"cur_{h}.yuv"),
                    os.path.join(work, f"ref_{h}.yuv"),
                    f"{out_dir}_{h}", str(blk), str(span), str(w), str(h),
                    "--device", "cuda", "--metric", metric, "--timing-row",
                ])
            for name, n in read_counts(names, f"main path ({path})").items():
                main_launches.setdefault(name, n)
            if path.startswith("whole-frame"):
                counts = {n: launches(n) for n in whole[metric]}
                if counts != whole[metric]:
                    fail(f"main path ({path}): launches {counts}, expected "
                         f"{whole[metric]}")
            for label, h, w, blk, span in configs:
                cur, ref = pairs[h, w]
                gold = golden_search(cur, ref, blk_dim=blk, span=span,
                                     metric=metric)
                comp = check_stack(f"{out_dir}_{h}", cur, ref, gold, blk,
                                   span, label, frames_lib)
                print(f"{label}: stack equals the plain golden search's, "
                      f"PSNR {frames_lib.image_psnr(comp, cur):.6f}")

    label, h, w, blk, span = U8_CONFIG
    print(f"== main path (packed-byte chunked mse): full_search_frame_cuda "
          f"at {label}, phase=False, operand_bf16=True")
    cur, ref = pairs[h, w]
    reset_counts()
    got = kc.full_search_frame_cuda(cur, ref, blk_dim=blk, span=span,
                                    phase=False, operand_bf16=True,
                                    device=dev)
    main_launches.update(read_counts(("me_chunked_u8_search",),
                                     "main path (u8)"))
    compare(["me_chunked_u8_search"], got,
            golden_search(cur, ref, blk_dim=blk, span=span),
            f"full_search_frame_cuda {w}x{h} {blk}x{blk} +-{span} "
            f"operand_bf16, every field vs the golden search")

    print("== volume path: full_search_volume_cuda vs the golden volume, "
          "entry for entry")
    reset_counts()
    volumes = [kc.full_search_volume_cuda(*pairs[h, w], blk_dim=blk,
                                          span=span, metric=metric,
                                          device=dev)
               for _, h, w, blk, span, metric in VOLUME_CONFIGS]
    volume_kernels = tuple(n + EMIT for n in (
        "me_phase_search", "me_chunked_search", "me_int_search"))
    counts = read_counts(volume_kernels, "volume path")
    main_launches["me_chunked_search" + EMIT] = counts[
        "me_chunked_search" + EMIT]
    if launches("me_phase_search") != launches("me_phase_search" + EMIT):
        fail("volume path: a search launch without a volume")
    for (label, h, w, blk, span, metric), got in zip(VOLUME_CONFIGS,
                                                      volumes):
        _, want = golden_search(*pairs[h, w], blk_dim=blk, span=span,
                                metric=metric, return_cost_volume=True)
        interior = ("me_phase_search" if kc.phase_supported(blk, span, metric)
                    else "me_chunked_search" if metric == "mse" else None)
        invalid = int((want == 2**31 - 1).sum())
        compare([n + EMIT for n in (interior, "me_int_search") if n], [got],
                [want],
                f"full_search_volume_cuda {label} {tuple(got.shape)} "
                f"({got.numel() * 4 / 1e6:.1f} MB, {invalid} INT32_MAX "
                f"entries)")
    del volumes, want

    # -- the diamond main path ----------------------------------------------
    h, w, blk, span = DIAMOND
    rng = np.random.default_rng(args.seed)
    contents = {"config3": synth(rng, h, w),
                "adversarial": synth(rng, h, w, shift=(14, -14), noise=2),
                "4K": synth(np.random.default_rng(args.seed + 2), 2160,
                            3840)}
    levels = diamond._staged_levels(span)
    golden = {}  # (content, metric) -> (golden field, golden volume)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as work:
        for name, (cur, ref) in contents.items():
            cur.tofile(os.path.join(work, f"cur_{name}.yuv"))
            ref.tofile(os.path.join(work, f"ref_{name}.yuv"))
        for label, content, extra, metric in DIAMOND_RUNS:
            print(f"== main path (diamond {label}): cli.main --device cuda "
                  f"--algorithm diamond {' '.join(extra)} at {w}x{h} "
                  f"{blk}x{blk} +-{span}, {content} content")
            cur, ref = contents[content]
            out_dir = os.path.join(work, "diamond_" + label.replace(" ", "_"))
            reset_counts()
            with no_plain_path(f"diamond {label}"), \
                    replay_without_sync(sync_errors):
                run_cli(cli, [
                    os.path.join(work, f"cur_{content}.yuv"),
                    os.path.join(work, f"ref_{content}.yuv"), out_dir,
                    str(blk), str(span), str(w), str(h), "--device", "cuda",
                    "--algorithm", "diamond", *extra, "--timing-row",
                ])
            names = [n + EMIT for n in (ssim_kernels if metric == "ssim"
                                        else mse_kernels)]
            crossover = "crossover" in extra
            counts = read_counts(names + ["me_diamond_replay"],
                                 f"main path (diamond {label})")
            for n, c in counts.items():
                main_launches.setdefault(n, c)
            # One replay a level: a level is one volume of the interior
            # kernel's emit mode.
            if counts["me_diamond_replay"] != counts[names[0]]:
                fail(f"diamond {label}: {counts['me_diamond_replay']} "
                     f"replays for {counts[names[0]]} level volumes")
            if content == "adversarial" and not crossover and any(
                    c < len(levels) for c in counts.values()):
                fail(f"diamond {label}: no escalation to level {span}")
            if crossover and not all(launches(n) > launches(n + EMIT)
                                     for n in mse_kernels):
                fail(f"diamond {label}: the crossover search never ran")
            # The reference: the canonical replay over the golden volume.
            if (content, metric) not in golden:
                golden[content, metric] = golden_search(
                    cur, ref, blk_dim=blk, span=span, metric=metric,
                    return_cost_volume=True)
            best, volume = golden[content, metric]
            kw = dict(blk_dim=blk, metric=metric, early_term=(
                float(extra[1]) if "--early-term" in extra else None),
                max_steps=diamond.default_max_steps(span),
                frame_height=h, frame_width=w)
            want, want_traj, esc = diamond_reference(
                best, volume, span=span, crossover=crossover, **kw)
            if crossover:
                print(f"  crossover: {int(esc.sum())} of {esc.numel()} "
                      f"blocks escape level {levels[0]}")
                if not esc.any():
                    fail("diamond crossover: no block escaped level 1")
            got = diamond.diamond_search_frame(
                cur, ref, blk_dim=blk, span=span, metric=metric,
                early_term=kw["early_term"],
                escape_policy="crossover" if crossover else "canonical",
                record_trajectory=not crossover, device=dev)
            if not crossover:
                got, got_traj = got
                if not torch.equal(got_traj, want_traj):
                    fail(f"diamond {label}: trajectory differs from the "
                         f"replay over the golden volume")
            for a, b in zip(got, want):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    fail(f"diamond {label}: field differs from the replay "
                         f"over the golden volume")
            comp = check_stack(out_dir, cur, ref, want, blk, span, label,
                               frames_lib)
            moved = int(((want.mv_y != 0) | (want.mv_x != 0)).sum())
            print(f"diamond {label}: MVs, costs"
                  f"{'' if crossover else ', trajectories'} and stack equal "
                  f"the replay over the golden volume; {moved} of "
                  f"{want.mv_y.numel()} blocks moved; PSNR "
                  f"{frames_lib.image_psnr(comp, cur):.6f}")

    # -- the lazy mode's main path -------------------------------------------
    t_lazy = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as work:
        lazy_lines = lazy_phase(work, contents, dev, card, counted,
                                sync_errors, compare, cuda_ms)
    main_launches["me_diamond_walk"] = 1  # each case: `counted` held it
    print(f"me_diamond_walk: {len(LAZY_RUNS)} cases against lazy_plain, "
          f"fields and trajectories bit for bit, max |kernel - plain| = "
          f"{max_err['me_diamond_walk']}; lazy phase "
          f"{time.perf_counter() - t_lazy:.1f} s")

    # -- the GOP main path ----------------------------------------------------
    t_gop = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as work:
        gop = gop_phase(work, args.seed, dev, card, counted, sync_errors,
                        time_run_pair)
        print(f"GOP phase: {time.perf_counter() - t_gop:.1f} s")
        t_sharded = time.perf_counter()
        sharded_ms = sharded_phase(work, gop, pairs, contents["config3"],
                                   dev, card, counted, reset_counts,
                                   lambda: {n: launches(n) for n in counters
                                            if launches(n)}, sync_errors)
        print(f"sharded phase: {time.perf_counter() - t_sharded:.1f} s")
    t_graft = time.perf_counter()
    graft_phase(dev, card, counted)
    print(f"graft phase: {time.perf_counter() - t_graft:.1f} s")

    # -- 4. each kernel against its plain version on the card -------------
    print("== kernels vs their plain versions on the card (exact)")
    t_replay = time.perf_counter()
    n_checks = replay_checks(contents, dev, compare, args.seed)
    print(f"me_diamond_replay: {n_checks} checks against replay_plain, "
          f"fields, trajectories and escape masks bit for bit, max |kernel "
          f"- plain| = {max_err['me_diamond_replay']} "
          f"({time.perf_counter() - t_replay:.1f} s)")

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
    # The phase kernel at every blk, MSE and SAD, with and without its
    # volume, on the whole blocks of a 1080p frame (the volume holds
    # INT32_MAX past its edges), on a tile off the frame's origin, and on
    # constant frames (every cost ties at 0: raster-first must win).
    h, w = 1080, 1920
    for blk, span in PHASE_CHECKS:
        cur_t, halo = operands(h, w, span, args.seed + blk)
        tile = cur_t[: h // blk * blk, : w // blk * blk]
        y0, x0 = 64, 128
        sub = (cur_t[y0 : y0 + 512, x0 : x0 + 768], halo[y0:, x0:])
        flat = torch.full((h, w), 77, dtype=torch.uint8, device=dev)
        flat_halo = torch.nn.functional.pad(flat, (span, span, span, span))
        for metric in ("mse", "sad"):
            kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
                      frame_width=w)
            what = f"me_phase_search {w}x{h} {blk}x{blk} +-{span} {metric}"
            for ops, extra, where in (
                ((tile, halo), {}, ""),
                ((tile, halo), dict(return_volume=True), " with its volume"),
                (sub, dict(y_origin=y0, x_origin=x0, return_volume=True),
                 f", 512x768 tile at ({y0}, {x0}) with its volume"),
                ((flat[: h // blk * blk, : w // blk * blk], flat_halo), {},
                 ", constant frames"),
            ):
                got = kc.phase_search(*ops, **kw, **extra)
                names = ["me_phase_search" + (EMIT if extra else "")]
                compare(names, got, kc.search_plain(*ops, **kw, **extra),
                        what + where)
            if got[0].any():
                fail(f"{what}: constant frames with a cost above 0")
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

    def edge_kernel(metric):
        """(wrapper, plain version, launcher name, metric keyword) of the
        truncated-extent kernel of `metric`."""
        if metric == "ssim":
            return sc.ssim_search, sc.ssim_plain, "me_ssim_search", {}
        return (kc.int_search, kc.search_plain, "me_int_search",
                dict(metric=metric))

    # The truncated-extent kernels over the whole frame at full size, with
    # and without their volumes (the kernels line times the search here).
    for label, h, w, blk, span, metric in WHOLE_CONFIGS:
        fn, plain, name, mkw = edge_kernel(metric)
        cur_t, halo = operands(h, w, span, args.seed)
        kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w,
                  **mkw)
        want = plain(cur_t, halo, return_volume=True, **kw)
        compare([name], fn(cur_t, halo, **kw), want[:2],
                f"{name} {label}, whole frame")
        got = fn(cur_t, halo, return_volume=True, **kw)
        compare([name + EMIT], got, want,
                f"{name} {label}, whole frame, with its volume "
                f"{tuple(got[2].shape)}")
        shapes[name] = (fn, plain, (cur_t, halo), kw,
                        (h, w, blk, span, (h, w), (0, 0)))
        del got, want
    # Every blk 1..33 and three above 32, at each span of EDGE_SPANS, each
    # form with and without its volume: a whole frame with both edges
    # truncated, its bottom and right slabs, a tile off the frame's origin,
    # and constant frames (every valid candidate ties: raster-first wins).
    t_edge, n_edge = time.perf_counter(), 0
    for blk in EDGE_BLKS:
        h, w = edge_frame(blk)
        y0, x0 = h // blk * blk, w // blk * blk
        flat = torch.full((h, w), 77, dtype=torch.uint8, device=dev)
        for span in EDGE_SPANS:
            cur_t, halo = operands(h, w, span, args.seed + blk + span)
            tiles = (
                ("whole frame", (cur_t, halo), {}),
                ("bottom slab", (cur_t[y0:], halo[y0:]), dict(y_origin=y0)),
                ("right slab", (cur_t[:, x0:], halo[:, x0:]),
                 dict(x_origin=x0)),
                (f"tile at ({blk}, {blk})", (cur_t[blk:, blk:],
                                             halo[blk:, blk:]),
                 dict(y_origin=blk, x_origin=blk)),
                ("constant frames", (flat, torch.nn.functional.pad(
                    flat, (span, span, span, span))), {}),
            )
            for metric in ("mse", "sad", "ssim"):
                fn, plain, name, mkw = edge_kernel(metric)
                for where, ops, extra in tiles:
                    if not ops[0].numel():  # blk 1: no slab
                        continue
                    kw = dict(blk_dim=blk, span=span, frame_height=h,
                              frame_width=w, **mkw, **extra)
                    want = plain(*ops, return_volume=True, **kw)
                    what = (f"{name} {metric} {w}x{h} {blk}x{blk} +-{span} "
                            f"{where}")
                    compare([name], fn(*ops, **kw), want[:2], what,
                            quiet=True)
                    compare([name + EMIT], fn(*ops, return_volume=True, **kw),
                            want, what + " with its volume", quiet=True)
                    n_edge += 2
    print(f"me_int_search (mse, sad) and me_ssim_search at blk {EDGE_BLKS}, "
          f"spans {EDGE_SPANS}, whole frames, bottom and right slabs, tiles "
          f"off the origin and constant frames, with and without volumes: "
          f"{n_edge} checks, every one exact, "
          f"{time.perf_counter() - t_edge:.1f} s")

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

    # The fast SSIM kernel at every blk, with and without its volume, on a
    # tile of a 400x300 frame off its origin, at span 0 and span 5.
    h, w = 300, 400
    for blk in range(1, sc.FAST_MAX_BLK + 1):
        y0, x0 = blk, 2 * blk
        nby, nbx = (h - y0) // blk, (w - x0) // blk
        for span in (0, 5):
            cur_t, halo = operands(h, w, span, args.seed + blk)
            sub = (cur_t[y0 : y0 + nby * blk, x0 : x0 + nbx * blk],
                   halo[y0:, x0:])
            kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w,
                      y_origin=y0, x_origin=x0)
            for extra in ({}, dict(return_volume=True)):
                compare(["me_ssim_fast_search" + (EMIT if extra else "")],
                        sc.ssim_fast_search(*sub, **kw, **extra),
                        sc.ssim_plain(*sub, **kw, **extra),
                        f"me_ssim_fast_search {w}x{h} {blk}x{blk} +-{span}, "
                        f"{nbx * blk}x{nby * blk} tile at ({y0}, {x0})"
                        f"{' with its volume' if extra else ''}")

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

    def interior_check(fn, name, h, w, blk, span, seed, what="",
                       **extra):
        """fn on the whole blocks of a (h, w) frame vs search_plain;
        returns (operands, kwargs, bound geometry)."""
        cur_t, halo = operands(h, w, span, seed)
        tile = (cur_t[: h // blk * blk, : w // blk * blk], halo)
        kw = dict(blk_dim=blk, span=span, metric="mse", frame_height=h,
                  frame_width=w, **extra)
        compare([name], fn(*tile, **kw), kc.search_plain(*tile, **kw),
                f"{name} {w}x{h} {blk}x{blk} +-{span}{what}")
        return tile, kw, (h, w, blk, span, tile[0].shape, (0, 0))

    # The chunked kernel: the Jockey config, and span 0 (the centre only).
    for h, w, blk, span in ((2160, 3840, 8, 0), (2160, 3840, 7, 15)):
        tile, kw, geo = interior_check(kc.chunked_search,
                                       "me_chunked_search", h, w, blk, span,
                                       args.seed)
    shapes["me_chunked_search"] = (kc.chunked_search, kc.search_plain, tile,
                                   kw, geo)
    # The packed-byte chunked kernel: 7 pixels a row masks the tail word.
    for h, w, blk, span in ((2160, 3840, 7, 15), (2160, 3840, 8, 12)):
        tile, kw, geo = interior_check(kc.chunked_u8_search,
                                       "me_chunked_u8_search", h, w, blk,
                                       span, args.seed)
    shapes["me_chunked_u8_search"] = (kc.chunked_u8_search, kc.search_plain,
                                      tile, kw, geo)
    # The wide kernel, up to its largest window (blk 32 +-31).
    for h, w, blk, span in ((1080, 1920, 32, 31), (2160, 3840, 32, 15),
                            (1080, 1920, 24, 15)):
        tile, kw, geo = interior_check(kc.wide_search, "me_wide_search", h,
                                       w, blk, span, args.seed)
    shapes["me_wide_search"] = (kc.wide_search, kc.search_plain, tile, kw,
                                geo)
    # The emit modes: cost or score, index and every volume entry,
    # INT32_MAX and -inf included.
    for fn, name, h, w, blk, span in (
        (kc.phase_search, "me_phase_search", 1080, 1920, 16, 15),
        (kc.chunked_search, "me_chunked_search", 1080, 1920, 7, 7),
    ):
        shapes[name + EMIT] = (fn, kc.search_plain) + interior_check(
            fn, name + EMIT, h, w, blk, span, args.seed, " with its volume",
            return_volume=True)
    h, w, blk, span = DIAMOND
    cur_t, halo = operands(h, w, span, args.seed)
    nyf = h // blk
    kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w,
              return_volume=True)
    tile = (cur_t[: nyf * blk], halo)
    slab = (cur_t[nyf * blk:], halo[nyf * blk:])
    for fn, plain, name, ops, extra, where in (
        (sc.ssim_fast_search, sc.ssim_plain, "me_ssim_fast_search", tile, {},
         "interior"),
        (sc.ssim_search, sc.ssim_plain, "me_ssim_search", slab,
         dict(y_origin=nyf * blk), f"bottom slab ({h - nyf * blk} rows)"),
        (kc.int_search, kc.search_plain, "me_int_search", slab,
         dict(y_origin=nyf * blk, metric="mse"),
         f"bottom slab ({h - nyf * blk} rows)"),
    ):
        fkw = dict(kw, **extra)
        got = fn(*ops, **fkw)
        invalid = int((~torch.isfinite(got[2].double())
                       | (got[2].double() == 2**31 - 1)).sum())
        compare([name + EMIT], got, plain(*ops, **fkw),
                f"{name} with its volume {w}x{h} {blk}x{blk} +-{span} "
                f"{where}, {tuple(got[2].shape)}, {invalid} -inf/INT32_MAX "
                f"entries")
        shapes[name + EMIT] = (fn, plain, ops, fkw, (
            h, w, blk, span, tuple(ops[0].shape), (fkw.get("y_origin", 0), 0)))
    cur, ref = contents["config3"]
    got = sc.ssim_volume_cuda(cur, ref, blk_dim=blk, span=span, device=dev)
    want = golden["config3", "ssim"][1]
    compare(["me_ssim_fast_search" + EMIT, "me_ssim_search" + EMIT], [got],
            [want], f"ssim_volume_cuda {w}x{h} {blk}x{blk} +-{span} "
            f"{tuple(got.shape)} vs the golden volume "
            f"({int(torch.isneginf(want).sum())} -inf entries)")

    # -- 5. timing -------------------------------------------------------
    print(f"== timing ({card}), median of {args.runs} runs after warm-up")

    for metric, configs in (("mse", CONFIGS), ("ssim", SSIM_CONFIGS)):
        for label, h, w, blk, span in configs:
            cur, ref = pairs.get((h, w)) or synthetic_pair(h, w, args.seed)
            time_run_pair(label, cur, ref, SearchConfig(
                blk_dim=blk, span=span, metric=metric, frame_width=w,
                frame_height=h))
            cur_t = torch.from_numpy(cur).to(dev)
            halo = torch.nn.functional.pad(torch.from_numpy(ref).to(dev),
                                           (span, span, span, span))
            nyf, nxf = h // blk, w // blk
            kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w)
            if metric == "mse":
                kw["metric"] = "mse"
                fast = kc.interior_search(blk, span, metric)
                edge, plain = kc.int_search, kc.search_plain
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

    # The whole-frame routes: run_pair, then the truncated-extent kernel
    # over the frame, search and emit, beside the plain version.
    for label, h, w, blk, span, metric in WHOLE_CONFIGS:
        cur, ref = pairs[h, w]
        time_run_pair(label, cur, ref, SearchConfig(
            blk_dim=blk, span=span, metric=metric, frame_width=w,
            frame_height=h))
        fn, plain, name, mkw = edge_kernel(metric)
        cur_t = torch.from_numpy(cur).to(dev)
        halo = torch.nn.functional.pad(torch.from_numpy(ref).to(dev),
                                       (span, span, span, span))
        kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w,
                  **mkw)
        geo = (h, w, blk, span, (h, w), (0, 0))
        line = f"  {name} {metric} whole frame"
        for mode, volume in (("search", False), ("emit", True)):
            k_ms = cuda_ms(lambda: fn(cur_t, halo, return_volume=volume,
                                      **kw), 20)
            p_ms = cuda_ms(lambda: plain(cur_t, halo, return_volume=volume,
                                         **kw), 1)
            b_ms = bound(*geo, ssim=metric == "ssim", volume=volume)[0]
            line += (f" | {mode} {k_ms:.4f} ms (plain {p_ms:.2f} ms, bound "
                     f"{b_ms:.6f} ms)")
        print(line + f" | {card}")

    # Kernels in turns on the same work; time_group fails unless those of
    # one metric in a group give the same (cost, idx). K1's M blocks/s at
    # each cell feed the scaling model.
    k1_rate = {}
    for label, h, w, blk, span, entries in kernel_turns.GROUPS:
        print(f"== {', '.join(e[0] for e in entries)} on the same work "
              f"({label} interior), in turns, {kernel_turns.LAUNCHES} "
              f"launches each ({card})")
        times = kernel_turns.time_group(h, w, blk, span, entries, args.seed,
                                        dev)
        geo = (h, w, blk, span, (h // blk * blk, w // blk * blk), (0, 0))
        pixel_cands, _ = valid_candidates(*geo)
        for (name, _, metric, volume), ts in zip(entries, times.values()):
            ms = statistics.mean(ts)
            if name == "K1 me_phase_search":
                k1_rate[label] = (h // blk) * (w // blk) / ms / 1e3
            b_ms = bound(*geo, ssim=metric == "ssim", volume=volume)[0]
            print(f"  {name} {ms:.4f} ms (runs {[round(t, 4) for t in ts]}), "
                  f"{pixel_cands / ms / 1e9:.2f} T pixel-candidates/s | "
                  f"bound {b_ms:.6f} ms | {card}")
    for label, h, w, blk, span, entries in kernel_turns.SLAB_GROUPS:
        print(f"== {', '.join(e[0] for e in entries)} on the same work "
              f"({label}), in turns, {kernel_turns.LAUNCHES} launches each "
              f"({card})")
        times = kernel_turns.time_group(h, w, blk, span, entries, args.seed,
                                        dev, slab=True)
        y0 = h // blk * blk
        geo = (h, w, blk, span, (h - y0, w), (y0, 0))
        for (name, _, metric, volume), ts in zip(entries, times.values()):
            b_ms = bound(*geo, ssim=metric == "ssim", volume=volume)[0]
            print(f"  {name} {statistics.mean(ts):.4f} ms (runs "
                  f"{[round(t, 4) for t in ts]}) | bound {b_ms:.6f} ms | "
                  f"{card}")

    # The scaling model at the rates just measured, its text printed (and
    # written to a temporary file: the committed results/h100/scaling.txt
    # is the tool's own), and its (2, 2) step beside the measured slot mesh.
    headline, north = k1_rate["4K 8x8 +-12"], k1_rate["4K 16x16 +-15"]
    print(f"== the scaling model at K1's {headline:.3f} M blocks/s (4K 8x8 "
          f"+-12) and {north:.3f} (4K 16x16 +-15), pinned h2d "
          f"{gop[3]:.1f} MB/s ({card})")
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        if record_scaling.main([
                "--headline", f"{headline:.3f}", "--north", f"{north:.3f}",
                "--ingest-mb-s", f"{gop[3]:.1f}", "--card", card,
                "--out", os.path.join(tmp, "scaling.txt")]) != 0:
            fail("record_scaling failed")
    m22 = scaling.model_step(frame_height=2160, frame_width=3840, blk_dim=8,
                             span=12, ty=2, tx=2,
                             measured_mblocks_per_s=headline)
    print(f"scaling model, 4K 8x8 +-12 on a (2, 2) mesh of four cards: step "
          f"{m22.step_s * 1e3:.4f} ms (compute {m22.compute_s * 1e3:.4f}, "
          f"halo {m22.halo_s * 1e3:.4f}, stats {m22.stats_s * 1e3:.4f}, "
          f"gather {m22.gather_s * 1e3:.4f}) beside sharded_full_search on "
          f"the (1, 2, 2) slot mesh of this one card: {sharded_ms:.4f} ms a "
          f"frame; the model leaves out the host's issue of each tile's "
          f"launches, ~0.8 ms a 4K tile on one card (PERF.md section 5) | "
          f"{card}")

    label, h, w, blk, span, metric = VOLUME_CONFIGS[0]
    print(f"== the volume at {label} ({card})")
    cur_d, ref_d = (torch.from_numpy(a).to(dev) for a in pairs[h, w])
    vkw = dict(blk_dim=blk, span=span, metric=metric, device=dev)
    kc.full_search_volume_cuda(cur_d, ref_d, **vkw)
    entry_ms = [cuda_ms(lambda: kc.full_search_volume_cuda(cur_d, ref_d,
                                                           **vkw), 1)
                for _ in range(5)]
    cur_t, halo = operands(h, w, span, args.seed)
    tile = cur_t[: h // blk * blk, : w // blk * blk]
    kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
              frame_width=w)
    search_ms = cuda_ms(lambda: kc.phase_search(tile, halo, **kw), 20)
    emit_ms = cuda_ms(lambda: kc.phase_search(tile, halo, return_volume=True,
                                              **kw), 20)
    emit_plain_ms = cuda_ms(lambda: kc.search_plain(tile, halo,
                                                    return_volume=True, **kw),
                            1)
    geo = (h, w, blk, span, tile.shape, (0, 0))
    emit_bound, emit_by = bound(*geo, volume=True)
    volume_mb = (2 * span + 1) ** 2 * tile.numel() // blk ** 2 * 4 / 1e6
    print(f"  full_search_volume_cuda median {statistics.median(entry_ms):.4f}"
          f" ms (runs {[round(t, 4) for t in entry_ms]}) | me_phase_search "
          f"emit {emit_ms:.4f} ms (without the volume {search_ms:.4f} ms; "
          f"plain {emit_plain_ms:.2f} ms; bound {emit_bound:.6f} ms, "
          f"{emit_by}, {volume_mb:.1f} MB written) | {card}")
    label, h, w, blk, span, metric = VOLUME_CONFIGS[2]
    cur_t, halo = operands(h, w, span, args.seed)
    tile = cur_t[: h // blk * blk, : w // blk * blk]
    kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
              frame_width=w)
    kc.chunked_search(tile, halo, return_volume=True, **kw)  # warm-up
    turns = {"search": [], "emit": []}
    for mode in ("search", "emit", "emit", "search"):
        turns[mode].append(cuda_ms(lambda: kc.chunked_search(
            tile, halo, return_volume=mode == "emit", **kw), 20))
    geo = (h, w, blk, span, tuple(tile.shape), (0, 0))
    volume_mb = (2 * span + 1) ** 2 * tile.numel() // blk ** 2 * 4 / 1e6
    print(f"  me_chunked_search at {label} interior {tuple(tile.shape)}: "
          f"emit {statistics.mean(turns['emit']):.4f} ms, search "
          f"{statistics.mean(turns['search']):.4f} ms (in turns, 20 launches "
          f"each: {turns}); emit bound "
          f"{bound(*geo, volume=True)[0]:.6f} ms ({volume_mb:.1f} MB "
          f"written) | {card}")

    h, w, blk, span = DIAMOND
    print(f"== diamond at {w}x{h} {blk}x{blk} +-{span}, the JAX bench's "
          f"config3 and adversarial content, beside full search ({card})")
    for label, content, algorithm, metric, early, policy in (
        ("config3-ref: full search mse", "config3", "full", "mse", None,
         "canonical"),
        ("config3: diamond mse", "config3", "diamond", "mse", None,
         "canonical"),
        ("config3-early: diamond mse early-term 2.0", "config3", "diamond",
         "mse", 2.0, "canonical"),
        ("full search ssim", "config3", "full", "ssim", None, "canonical"),
        ("config3-ssim-staged: diamond ssim", "config3", "diamond", "ssim",
         None, "canonical"),
        ("adversarial: diamond mse", "adversarial", "diamond", "mse", None,
         "canonical"),
        ("adversarial: diamond mse crossover", "adversarial", "diamond",
         "mse", None, "crossover"),
    ):
        time_run_pair(label, *contents[content], SearchConfig(
            blk_dim=blk, span=span, metric=metric, algorithm=algorithm,
            early_term=early, escape_policy=policy, frame_width=w,
            frame_height=h))
    cur_d, ref_d = (torch.from_numpy(a).to(dev) for a in contents["config3"])
    volumes = {}
    for metric, r in (("mse", levels[0]), ("mse", span), ("ssim", levels[0]),
                      ("ssim", span)):
        entry = sc.ssim_volume_cuda if metric == "ssim" else functools.partial(
            kc.full_search_volume_cuda, metric=metric)
        vkw = dict(blk_dim=blk, span=r, device=dev)
        volumes[metric, r] = entry(cur_d, ref_d, **vkw)
        entry_ms = [cuda_ms(lambda: entry(cur_d, ref_d, **vkw), 1)
                    for _ in range(5)]
        print(f"  {entry.__name__ if metric == 'ssim' else 'full_search_volume_cuda'}"
              f" {metric} radius {r}: median {statistics.median(entry_ms):.4f}"
              f" ms (runs {[round(t, 4) for t in entry_ms]}) | {card}")
    for metric in ("mse", "ssim"):
        r = levels[0]
        rkw = dict(blk_dim=blk, span=r, metric=metric, early_term=None,
                   max_steps=diamond.default_max_steps(span),
                   frame_height=h, frame_width=w, track_escape=True)
        vol = volumes[metric, r]
        _, traj, esc = dc.replay_plain(vol, record_trajectory=True, **rkw)
        # Round 0 and every round after one in which some block moved.
        moved = (traj[1:] != traj[:-1]).any(-1).flatten(1).any(1)
        rounds = 1 + int(moved[:-1].sum())
        rkw["record_trajectory"] = False
        plain_ms = [cuda_ms(lambda: dc.replay_plain(vol, **rkw), 1)
                    for _ in range(5)]
        dc.replay_cuda(vol, **rkw)  # warm-up
        # The wrapper's call issues the outputs' allocations and the
        # launch; the kernel's own time is the profiler's device time.
        call_ms = [cuda_ms(lambda: dc.replay_cuda(vol, **rkw), 20)
                   for _ in range(5)]
        kernel_ms = kernel_turns.device_ms(
            lambda: dc.replay_cuda(vol, **rkw), "replay_kernel", dev)
        nby, nbx = vol.shape[1:]
        empty_ms = kernel_turns.device_ms(
            lambda: dc.replay_empty(nby, nbx, dev), "empty_kernel", dev)
        if not (kernel_ms > 0 and empty_ms > 0):
            fail(f"replay alone, {metric}: the profiler recorded no launch "
                 f"of the replay ({kernel_ms}) or the empty kernel "
                 f"({empty_ms}) in three passes")
        att = dc.replay_attributes(metric, nby, nbx)
        ptxas = replay_ptxas.get(("float" if metric == "ssim" else "int",
                                  att["depth"]), "not built in this run")
        reads = replay_reads(traj.cpu().numpy(), span=r)
        bound_ms, bound_by = replay_bound(reads, esc.numel())
        print(f"  replay alone, {metric} level {r}: me_diamond_replay "
              f"{kernel_ms:.4f} ms (device time, mean of a profiled pass "
              f"of 20 launches or more); an empty kernel on its grid "
              f"({nby}x{nbx} blocks) {empty_ms:.4f} ms; replay_cuda call "
              f"median {statistics.median(call_ms):.4f} ms (runs "
              f"{[round(t, 4) for t in call_ms]}, 20 calls each behind a "
              f"sleep), replay_plain median "
              f"{statistics.median(plain_ms):.4f} ms "
              f"(runs {[round(t, 4) for t in plain_ms]}; CUDA events around "
              f"host dispatch); bound {bound_ms:.6f} ms ({bound_by}: "
              f"{reads} distinct volume entries read); {rounds} LDSP rounds, "
              f"{int(esc.sum())} blocks escape; instance: {att['depth']} "
              f"LDSP rounds a trip, {att['registers']} registers, "
              f"{att['local_bytes']} bytes of local memory, ptxas: {ptxas}; "
              f"{att['warps_per_sm']} warps resident per SM | {card}")
        if att["local_bytes"]:
            fail(f"me_diamond_replay {metric}: {att['local_bytes']} bytes "
                 f"of local memory (stack or spills) per thread")
        if metric == "mse":  # the main path's first replay: the kernels line
            replay_line = (kernel_ms, statistics.median(plain_ms),
                           bound_ms, bound_by)
    # The instances of large planes (a round a load, from 65,536 blocks).
    for metric in ("mse", "ssim"):
        att = dc.replay_attributes(metric, 270, 480)
        ptxas = replay_ptxas.get(("float" if metric == "ssim" else "int",
                                  att["depth"]), "not built in this run")
        print(f"  me_diamond_replay {metric} at a 4K 8x8 plane (270x480 "
              f"blocks): {att['depth']} LDSP rounds a trip (0: a round a "
              f"load), {att['threads']} threads a CUDA block, "
              f"{att['registers']} registers, {att['local_bytes']} bytes of "
              f"local memory, ptxas: {ptxas}; {att['warps_per_sm']} warps "
              f"resident per SM | {card}")
        if att["local_bytes"]:
            fail(f"me_diamond_replay {metric} at 270x480: "
                 f"{att['local_bytes']} bytes of local memory per thread")
    del volumes, vol
    cur_t, halo = operands(h, w, span, args.seed)
    nyf = h // blk
    kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w)
    tile = (cur_t[: nyf * blk], halo)
    slab = (cur_t[nyf * blk:], halo[nyf * blk:])
    for fn, ops, extra in ((sc.ssim_fast_search, tile, {}),
                           (sc.ssim_search, slab, dict(y_origin=nyf * blk)),
                           (kc.int_search, slab, dict(y_origin=nyf * blk,
                                                      metric="mse"))):
        fkw = dict(kw, **extra)
        fn(*ops, return_volume=True, **fkw)  # warm-up: loads the instance
        turns = {"search": [], "emit": []}
        for mode in ("search", "emit", "emit", "search"):
            turns[mode].append(cuda_ms(lambda: fn(
                *ops, return_volume=mode == "emit", **fkw), 20))
        geo = (h, w, blk, span, tuple(ops[0].shape), (fkw.get("y_origin", 0),
                                                      0))
        print(f"  {fn.__name__} on {tuple(ops[0].shape)}: emit "
              f"{statistics.mean(turns['emit']):.4f} ms, search "
              f"{statistics.mean(turns['search']):.4f} ms (in turns, 20 "
              f"launches each: {turns}); emit bound "
              f"{bound(*geo, ssim=fn is not kc.int_search, volume=True)[0]:.6f}"
              f" ms | {card}")

    # -- 6. the bench main path ---------------------------------------------
    t_bench = time.perf_counter()
    bench_kernels = [n + e for n in mse_kernels + ssim_kernels
                     for e in ("", EMIT)] + ["me_diamond_replay",
                                             "me_diamond_walk"]
    reset_counts()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as work:
        bench_phase(work, dev, card)
    read_counts(bench_kernels, "main path (bench)")
    print(f"bench phase: {time.perf_counter() - t_bench:.1f} s")

    # -- 7. the speed-of-light tools ----------------------------------------
    print(f"== main path (speed-of-light tools): vpu_peak.main() and "
          f"kern_lab.main({' '.join(LAB_SPECS + NEW_SPECS)}) ({card}; "
          f"{time.perf_counter() - t_start:.1f} s in)")
    t_tools = time.perf_counter()
    reset_counts()
    for tool, tool_argv in ((vpu_peak, []),
                            (kern_lab, LAB_SPECS + NEW_SPECS)):
        out = run_cli(tool, tool_argv)
        if "FAILED" in out:
            fail(f"{tool.__name__}: a variant failed")
    main_launches.update(read_counts(LAB_KERNELS,
                                     "main path (speed-of-light tools)"))
    sms = props.multi_processor_count
    lane_ops_s = sms * 128 * max_clock_mhz * 1e6
    floor = (f"FP32-lane floor {lane_ops_s / 1e12:.2f} T ops/s ({sms} SMs x "
             f"128 lanes x {max_clock_mhz:.0f} MHz)")
    print(floor)
    for what, occ in [
            *((f"me_lab_padded \"{v}\"", lab.lab_occupancy(v))
              for v in lab.PADDED_VARIANTS),
            *((f"lab_key_kernel \"{k}\"", lab.lab_occupancy(k))
              for k in lab.KEY_INSTANCES),
            *((f"me_lab_peak {k} at {c} columns",
               lab.lab_occupancy(k, cols=c, inner=vpu_peak.INNER))
              for k in lab.ROLL_INSTANCES for c in (32, 1024))]:
        print(f"{what}: {occ['registers']} registers and "
              f"{occ['local_bytes']} bytes of local memory (spills) per "
              f"thread, {occ['threads']} threads and {occ['smem_bytes']} B "
              f"of shared memory per CUDA block, {occ['blocks_per_sm']} CUDA "
              f"blocks ({occ['warps_per_sm']} warps) resident per SM")

    def timed(fn):
        """(fn(), device ms of that one call)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def compare_rel(name, got, want, tol, what):
        """Finite values on both sides, every entry within `tol` relative;
        records the largest absolute difference."""
        if (got.shape != want.shape or not torch.isfinite(got).all()
                or not torch.isfinite(want).all()):
            fail(f"{what}: a NaN or an infinity, or shapes that differ")
        diff = (got.double() - want.double()).abs()
        err = float(diff.max())
        rel = float((diff / want.double().abs()).max())
        max_err[name] = max(max_err[name], err)
        print(f"{what}: max |kernel - plain| = {err}, max relative {rel:.3g} "
              f"(tolerance {tol})")
        if rel > tol:
            fail(f"{what}: kernel disagrees with its plain version")

    def rate(ops, ms, what):
        """T elem-ops/s of `ops` in `ms`; fails above the FP32-lane floor,
        which only work the compiler dropped could pass."""
        t = ops / ms / 1e9
        if t * 1e12 > lane_ops_s:
            fail(f"{what}: {t:.3f} T elem-ops/s is above the {floor}")
        return t

    # P1 against its plain version at the tool's shape, on inputs where every
    # step of the chain moves the result (vpu_peak.check_input), at
    # CHECK_OUTER iterations; timed on the tool's own input at OUTER.
    lab_times = {}  # kernel -> (ms, plain ms, bound ms, bound by)
    inner, outer = vpu_peak.INNER, vpu_peak.CHECK_OUTER
    for mix in vpu_peak.MIXES:
        chk = vpu_peak.check_input(mix).to(dev)
        compare_rel("me_lab_peak",
                    lab.lab_peak(chk, mix=mix, inner=inner, outer=outer),
                    lab.peak_plain(chk, mix, inner=inner, outer=outer),
                    vpu_peak.CHECK_TOL[mix],
                    f"me_lab_peak {mix} {tuple(chk.shape)} OUTER {outer}")
    a = vpu_peak.peak_input().to(dev)
    rows, cols = a.shape
    _, plain_ms = timed(lambda: lab.peak_plain(a, "fma", inner=inner,
                                               outer=vpu_peak.OUTER))
    # The lane-ops each mix executes: the tool's count for fma and mix (an
    # FMA, or a sub and an FMA, per op of INNER); for roll only its adds,
    # half the tool's count, which takes a roll + add pair as two.
    def executed(mix, rows):
        return (vpu_peak.roll_adds(rows) if mix == "roll"
                else vpu_peak.peak_ops(rows))

    peak_ops = vpu_peak.peak_ops()
    peak_extra = {}  # the roll's and mix's ms and bound on the kernels line
    for mix in vpu_peak.MIXES:
        ms = cuda_ms(lambda: lab.lab_peak(a, mix=mix, inner=inner,
                                          outer=vpu_peak.OUTER), 10)
        ops = executed(mix, rows)
        t = rate(ops, ms, f"P1 {mix}")
        bound_ms = ops / lane_ops_s * 1e3
        print(f"  P1 {mix} {rows}x{cols}: {ms:.4f} ms, {t:.3f} T "
              f"{'adds' if mix == 'roll' else 'elem-ops'}/s executed, "
              f"{t * 1e12 / lane_ops_s:.1%} of the {floor}; bound "
              f"{bound_ms:.4f} ms; {peak_ops / ms / 1e9:.3f} T elem-ops/s "
              f"by the JAX tool's count"
              f"{f' (plain {plain_ms:.1f} ms)' if mix == 'fma' else ''} | "
              f"{card}")
        if mix == "fma":
            lab_times["me_lab_peak"] = (ms, plain_ms, bound_ms, "operations")
        else:
            peak_extra.update({f"{mix}_ms": ms, f"{mix}_bound_ms": bound_ms})
    fill_ops = vpu_peak.peak_ops(rows=FILL_ROWS)
    for mix in vpu_peak.MIXES:
        t = vpu_peak.measure(mix, rows=FILL_ROWS)
        ms = fill_ops / t / 1e9
        ops = executed(mix, FILL_ROWS)
        te = rate(ops, ms, f"P1 {mix} {FILL_ROWS} rows")
        print(f"  P1 {mix} {FILL_ROWS}x{cols}: {ms:.4f} ms, {te:.3f} T "
              f"{'adds' if mix == 'roll' else 'elem-ops'}/s executed, "
              f"{te * 1e12 / lane_ops_s:.1%} of the floor; bound "
              f"{ops / lane_ops_s * 1e3:.4f} ms; {t:.3f} T elem-ops/s by the "
              f"JAX tool's count | {card}")

    c, e = (t.to(dev) for t in vpu_peak.chain_inputs())
    want, plain_ms = timed(lambda: lab.chain_plain(c, e, ch_g=vpu_peak.CH_G))
    compare(["me_lab_chain"], [lab.lab_chain(c, e, ch_g=vpu_peak.CH_G)],
            [want], f"me_lab_chain [{vpu_peak.CH_G}, {vpu_peak.CH_W}]")
    ms = cuda_ms(lambda: lab.lab_chain(c, e, ch_g=vpu_peak.CH_G), 20)
    chain_ops = vpu_peak.chain_ops()
    lab_times["me_lab_chain"] = (ms, plain_ms, chain_ops / lane_ops_s * 1e3,
                                 "operations")
    t_tool = rate(chain_ops, ms, "P2")
    t = vpu_peak.measure_chain(ch_w=FILL_CH_W)
    fill_ops = vpu_peak.chain_ops(ch_w=FILL_CH_W)
    rate(fill_ops, fill_ops / t / 1e9, f"P2 width {FILL_CH_W}")
    print(f"  P2 chain [{vpu_peak.CH_G}, {vpu_peak.CH_W}]: {ms:.4f} ms, "
          f"{t_tool:.3f} T elem-ops/s, {t_tool * 1e12 / lane_ops_s:.1%} of "
          f"the floor (plain {plain_ms:.1f} ms) | [{vpu_peak.CH_G}, "
          f"{FILL_CH_W}]: {fill_ops / t / 1e9:.4f} ms, {t:.3f} T elem-ops/s, "
          f"{t * 1e12 / lane_ops_s:.1%} of the floor | {card}")
    del a, chk, c, e

    # L2 and L4 against their plain versions (exact) and against K1 on the
    # same frames: decoded cost and index equal.
    cur, ref_p = (torch.from_numpy(x).to(dev)
                  for x in kern_lab.make_inputs(args.seed))
    h, w = cur.shape
    span, blk = kern_lab.SPAN, kern_lab.BLK
    cur_u8 = cur.to(torch.uint8)
    halo_u8 = ref_p[: h + 2 * span, : w + 2 * span].to(torch.uint8)
    geo = (h, w, blk, span, (h, w), (0, 0))
    bytes_bound = bound(*geo)
    turns, lab_plain_ms = {}, {}
    for metric in ("mse", "sad"):
        sad = metric == "sad"
        k1kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
                    frame_width=w)
        k1 = kc.phase_search(cur_u8, halo_u8, **k1kw)
        plains = {"me_lab_phase": timed(lambda: lab.phase_plain(
                      cur, ref_p, sad=sad)),
                  "me_lab_diff": timed(lambda: lab.diff_plain(
                      cur, ref_p, sad=sad))}
        fns = {"K1 me_phase_search": lambda: kc.phase_search(cur_u8, halo_u8,
                                                             **k1kw)}
        for name, variant, run in (
            ("me_lab_phase", "P1" if sad else "P0",
             lambda t, v="P1" if sad else "P0": kern_lab.run_phase(
                 cur, ref_p, variant=v, tile_h=t)),
            ("me_lab_diff", "P4S" if sad else "P4",
             lambda t, sad=sad: kern_lab.run_p4(cur, ref_p, tile_h=t,
                                                sad=sad)),
        ):
            want, plain_ms = plains[name]
            for tile_h in (64, 128):
                got = run(tile_h)
                what = f"{name} \"{variant}\" {w}x{h} tile_h {tile_h}"
                compare([name], got if isinstance(got, tuple) else [got],
                        want if isinstance(want, tuple) else [want], what)
                cost, idx = (got if name == "me_lab_phase"
                             else kern_lab.decode_key(got))
                if not (torch.equal(cost.to(torch.int32), k1[0])
                        and torch.equal(idx, k1[1])):
                    fail(f"{what}: cost or index differs from K1's")
                fns[f"{name} \"{variant}\":{tile_h}"] = (
                    lambda run=run, tile_h=tile_h: run(tile_h))
            lab_plain_ms.setdefault(name, plain_ms)
            print(f"{name} \"{variant}\": decoded cost and index equal K1's "
                  f"({metric}) at both tile_h")
        for fn in fns.values():
            fn()  # warm-up
        times = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            times[name].append(cuda_ms(fns[name], 20))
        pixel_cands, _ = valid_candidates(*geo)
        for name, ts in times.items():
            ms = statistics.mean(ts)
            turns[name, metric] = ms
            print(f"  {metric} {name} {ms:.4f} ms (runs "
                  f"{[round(t, 4) for t in ts]}), {pixel_cands / ms / 1e9:.2f} "
                  f"T pixel-candidates/s | {card}")
    print(f"  the search's bound by bench/roofline.bound "
          f"{bytes_bound[0]:.6f} ms ({bytes_bound[1]}; int8 data-sheet rate; "
          f"L2's own below, by lab_bound); FP32-lane floor {2 * pixel_cands / lane_ops_s * 1e3:.4f}"
          f" ms (2 lane-ops per pixel-candidate) | {card}")
    lab_times["me_lab_phase"] = (turns["me_lab_phase \"P0\":128", "mse"],
                                 lab_plain_ms["me_lab_phase"],
                                 *lab_bound("P0", h, w, sms, max_clock_mhz))
    lab_times["me_lab_diff"] = (
        turns["me_lab_diff \"P4\":128", "mse"], lab_plain_ms["me_lab_diff"],
        *lab_bound("P4", h, w, sms, max_clock_mhz))

    # L1, L3, L5-L7: every variant exactly against its plain version, and
    # against K1 as NEW_LAB says.
    k1 = {metric: kc.phase_search(cur_u8, halo_u8, blk_dim=blk, span=span,
                                  metric=metric, frame_height=h,
                                  frame_width=w)
          for metric in ("mse", "sad")}
    plain_fns = {
        "nop": lambda: lab.nop_plain(cur, ref_p),
        "padded mse": lambda: lab.padded_plain(cur, ref_p),
        "padded sad": lambda: lab.padded_plain(cur, ref_p, sad=True),
        "padded bf16": lambda: lab.padded_plain(cur, ref_p, rounding=True),
        "raw": lambda: lab.raw_plain(cur, ref_p, tile_h=128),
        "diff mse": lambda: lab.diff_plain(cur, ref_p),
        "diff sad": lambda: lab.diff_plain(cur, ref_p, sad=True),
        "nochain": lambda: lab.nochain_plain(cur, ref_p),
        "nofold": lambda: lab.nofold_plain(cur, ref_p),
    }
    plains = {}  # plain name -> (output, ms)
    inner = slice(-(-span // blk), (h - blk - span) // blk + 1)
    fns = {"K1 me_phase_search": lambda: kc.phase_search(
               cur_u8, halo_u8, blk_dim=blk, span=span, metric="mse",
               frame_height=h, frame_width=w),
           "me_lab_diff \"P4\":128": lambda: kern_lab.run_p4(cur, ref_p,
                                                            tile_h=128)}
    for variant, name, plain, metric in NEW_LAB:
        if plain not in plains:
            plains[plain] = timed(plain_fns[plain])
        want = plains[plain][0]
        run, decode = kern_lab.variant_fn(f"{variant}:128")
        got = run(cur, ref_p)
        what = f"{name} \"{variant}\" {w}x{h} tile_h 128"
        compare([name], got if isinstance(got, tuple) else [got],
                want if isinstance(want, tuple) else [want], what)
        if metric:
            cost, idx = decode(got)
            cost, idx = cost.to(torch.int32), idx
            want_cost, want_idx = k1[metric][0], k1[metric][1]
            where = "every block"
            if name == "me_lab_padded":  # unmasked: the inner blocks only
                cost, idx, want_cost, want_idx = (
                    t[inner, inner] for t in (cost, idx, want_cost, want_idx))
                where = f"the {cost.numel()} blocks whose window is inside"
            if not (torch.equal(cost, want_cost)
                    and torch.equal(idx, want_idx)):
                fail(f"{what}: cost or index differs from K1's ({metric})")
            print(f"  decoded cost and index equal K1's ({metric}) on "
                  f"{where}")
        fns[f"{name} \"{variant}\":128"] = (
            lambda run=run: run(cur, ref_p))
    # Every variant at tile_h 64 too: it changes only "L1"'s function.
    for variant, name, plain, _ in NEW_LAB:
        want = (lab.raw_plain(cur, ref_p, tile_h=64) if plain == "raw"
                else plains[plain][0])
        compare([name], kern_lab.variant_fn(f"{variant}:64")[0](cur, ref_p),
                want, f"{name} \"{variant}\" {w}x{h} tile_h 64")
    for fn in fns.values():
        fn()  # warm-up
    times = {n: [] for n in fns}
    for n in [*fns, *reversed(fns)]:
        times[n].append(cuda_ms(fns[n], 20))
    print(f"  L1, L3, L5-L7 in turns with K1 and L4 (mse, 20 launches each) "
          f"| {card}")
    for n, ts in times.items():
        print(f"  {n} {statistics.mean(ts):.4f} ms (runs "
              f"{[round(t, 4) for t in ts]}) | {card}")
    for plain, (_, ms) in plains.items():
        print(f"  plain {plain} {ms:.2f} ms | {card}")
    # Every lab variant's bound (bench/roofline.lab_bound): the
    # larger of their arithmetic (LAB_OPS) at the rate of the lanes that
    # issue it and their float32 operands read once (cur, the [h + 24,
    # w + 24] window) and outputs written once, at 3.35 TB/s. L2's "P0",
    # "P1" and L4's "P4", "P4S" at both tile_h from the L2/L4 turns, the
    # rest at 128.
    variant_ms = {(name, v, 128): statistics.mean(times[f"{name} \"{v}\":128"])
                  for v, name, *_ in NEW_LAB}
    for tile_h in (128, 64):
        for name, v, metric in (("me_lab_phase", "P0", "mse"),
                                ("me_lab_phase", "P1", "sad"),
                                ("me_lab_diff", "P4", "mse"),
                                ("me_lab_diff", "P4S", "sad")):
            variant_ms[name, v, tile_h] = turns[
                f"{name} \"{v}\":{tile_h}", metric]
    for (name, v, tile_h), ms in variant_ms.items():
        ops, lanes = LAB_OPS[v]
        ops_ms, bytes_ms = lab_parts(v, h, w, sms, max_clock_mhz)
        bound_ms, bound_by = lab_bound(v, h, w, sms, max_clock_mhz)
        print(f"  {name} \"{v}\"{'' if tile_h == 128 else ' tile_h 64'}: "
              f"{ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: {ops} "
              f"instructions a block-candidate on {lanes} lanes an SM, "
              f"{ops_ms:.6f} ms, or {bytes_ms:.6f} ms of bytes), "
              f"{bound_ms / ms:.1%} of it | {card}")
    for variant, name, plain, _ in NEW_LAB:
        if name not in lab_times:  # each kernel's first variant
            lab_times[name] = (
                variant_ms[name, variant, 128], plains[plain][1],
                *lab_bound(variant, h, w, sms, max_clock_mhz))
    # The key kernel on small frames with edges, garbage halos, ties and
    # the wrapping key.
    t_keys = time.perf_counter()
    n_keys = key_checks(dev, compare)
    print(f"lab_key_kernel: {n_keys} checks of its sixteen variants against "
          f"their plain versions (frames {KEY_CHECKS} as (h, w, tile_h), "
          f"contents {kern_lab.CHECK_CONTENTS}, halo {kern_lab.HALO_FILL}; "
          f"\"P3B\" the zero halo), all equal "
          f"({time.perf_counter() - t_keys:.1f} s)")
    del cur, ref_p, cur_u8, halo_u8, plains, k1
    print(f"speed-of-light tools phase: "
          f"{time.perf_counter() - t_tools:.1f} s")

    # -- 8. the kernels line ----------------------------------------------
    kernels = []
    for name, (fn, plain, fargs, fkw, geo) in shapes.items():
        base = name.removesuffix(EMIT)
        ms = cuda_ms(lambda: fn(*fargs, **fkw), 50)
        plain_ms = cuda_ms(lambda: plain(*fargs, **fkw), 2)
        bound_ms, bound_by = bound(*geo, ssim=base in ssim_kernels,
                                   volume=name.endswith(EMIT))
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
            "name": name, "route": "cuda", "source": SOURCE[base],
            "replaces": REPLACES[base], "launches": main_launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    for name, (ms, plain_ms, bound_ms, bound_by) in [
            ("me_diamond_replay", replay_line),
            ("me_diamond_walk", lazy_lines[LAZY_RUNS[0][0]]),
            *lab_times.items()]:
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": main_launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            **(peak_extra if name == "me_lab_peak" else {}),
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
