"""Ablation lab for the full-search kernel: the port of the JAX repo's
`tools/kern_lab.py`, its two endpoint schemes on the card.

Interior-only 2048x2048 8x8 +-12 work on float32 planes (random pixels,
the reference zero-padded by the span), timed per variant:

  P0   - exact SSD by the cross term (Qcur - X) + (Qref - X) (L2)
  P1   - exact SAD on the same kernel (L2)
  P4   - SSD by the diff form sum (c - e)^2, as a packed int32 key
         cost * 625 + flat - 2^31, INT32_MAX where invalid (L4)
  P4S  - SAD as the same key (L4)

Variant spec: NAME[:tile_h], tile_h the pixel rows one CUDA block covers
(the TPU stripe height; default 128): a multiple of 8 dividing H. The JAX
tool's other variants (NOP, L0, L1, M1, M2, M3 of L1; P3* of L3; P5*, P6*,
P7* of L5-L7) are not ported yet (ROADMAP Queue 2) and report FAILED, as
the JAX tool reports a variant that fails.

Usage: python -m motionestimation_tpu_torch.tools.kern_lab P0 P1 P4:64 P4S:128

Each line: the median of REPS timed runs of CHAIN launches, CUDA events
around them, per launch; the first call's host time (kernel build and load
included) as "compile"; and a checksum of the outputs at block starts.
"""
from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from motionestimation_tpu_torch.core.device import resolve_device
from motionestimation_tpu_torch.kernels import lab_cuda as lab
from motionestimation_tpu_torch.kernels.lab_cuda import (  # noqa: F401
    BIG, BLK, I32_MAX, K, KEY_BIAS, SPAN,
)

H = W = 2048
CHAIN = 8  # launches per timed run
REPS = 3
DEFAULT_SPECS = ("P0", "P1", "P4", "P4S")
# Variant-name prefixes of the JAX tool's kernels that are not ported yet.
_UNPORTED = {"P3": "L3 (make_p3_kernel)", "P5": "L5 (make_p5_kernel)",
             "P6": "L6 (make_p6_kernel)", "P7": "L7 (make_p7_kernel)"}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def make_inputs(seed: int = 0, *, height: int = H, width: int = W):
    """(cur, ref_p) as float32 numpy arrays, as the JAX tool builds them:
    random pixels from default_rng(seed), the reference at [12:12+H,
    12:12+W] of a zero [H + 24, round_up(W + 24, 128)] halo."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (height, width)).astype(np.float32)
    refr = rng.integers(0, 256, (height, width)).astype(np.float32)
    ref_p = np.zeros((height + _round_up(2 * SPAN, 8),
                      _round_up(width + 2 * SPAN, 128)), np.float32)
    ref_p[SPAN : SPAN + height, SPAN : SPAN + width] = refr
    return cur, ref_p


def run_phase(cur, ref_p, *, variant: str, tile_h: int = 128):
    """L2: (float32 cost, int32 idx) per block; SAD for variant "P1", SSD
    by the cross term otherwise, as in the JAX tool."""
    return lab.lab_phase(cur, ref_p, tile_h=tile_h, sad=variant == "P1")


def run_p4(cur, ref_p, *, tile_h: int = 128, sad: bool = False):
    """L4: the int32 packed key per block."""
    return lab.lab_diff(cur, ref_p, tile_h=tile_h, sad=sad)


def decode_key(key: torch.Tensor):
    """(float32 cost, int32 flat index) from L4's key: key + 2^31 =
    cost * 625 + flat, read as unsigned."""
    u = key.to(torch.int64) - KEY_BIAS
    return (u // (K * K)).to(torch.float32), (u % (K * K)).to(torch.int32)


def checksum(cost: torch.Tensor, idx: torch.Tensor) -> float:
    """sum(cost) + sum(idx) over the block starts, in float64."""
    return float(cost.double().sum() + idx.double().sum())


def variant_fn(spec: str):
    """(run, decode) for a variant spec: run(cur, ref_p) launches the
    kernel once, decode(output) gives (cost, idx). Raises
    NotImplementedError for the JAX tool's variants not ported yet."""
    parts = spec.split(":")
    v = parts[0]
    tile_h = int(parts[1]) if len(parts) > 1 else 128
    for prefix, kernel in _UNPORTED.items():
        if v.startswith(prefix):
            raise NotImplementedError(
                f"{v}: kern_lab's {kernel} is not ported yet (ROADMAP "
                f"Queue 2)")
    if v.startswith("P4"):
        return (lambda cur, ref_p: run_p4(cur, ref_p, tile_h=tile_h,
                                          sad=v == "P4S"), decode_key)
    if v.startswith("P"):
        return (lambda cur, ref_p: run_phase(cur, ref_p, variant=v,
                                             tile_h=tile_h), tuple)
    raise NotImplementedError(
        f"{v}: kern_lab's L1 (make_kernel) is not ported yet (ROADMAP "
        f"Queue 2)")


def main(argv=None) -> int:
    specs = (sys.argv[1:] if argv is None else argv) or list(DEFAULT_SPECS)
    inputs = make_inputs()
    operands = None
    for spec in specs:
        try:
            fn, decode = variant_fn(spec)
            if operands is None:
                dev = resolve_device()
                operands = tuple(torch.from_numpy(x).to(dev) for x in inputs)
                print(f"# {torch.cuda.get_device_name(dev)}, {W}x{H} "
                      f"{BLK}x{BLK} +-{SPAN}, CUDA events over {CHAIN} "
                      f"launches, median of {REPS}")
            t0 = time.perf_counter()
            chk = checksum(*decode(fn(*operands)))
            comp = time.perf_counter() - t0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            ts = []
            for _ in range(REPS):
                start.record()
                for _ in range(CHAIN):
                    fn(*operands)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / CHAIN)
            ms = statistics.median(ts)
            print(f"{spec:14s} {ms:9.3f} ms  (compile {comp:5.1f}s, "
                  f"chk {chk:.8g})")
        except Exception as e:  # the tool reports a failing variant, goes on
            print(f"{spec:14s} FAILED: {type(e).__name__}: "
                  f"{str(e).splitlines()[0][:120]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
