"""Elementwise peak of the card's FP32 lanes: the port of the JAX repo's
`tools/vpu_peak.py`.

The full-search chain is elementwise work (a subtract and a multiply-add
per term), so its speed of light is the sustained elementwise rate of the
CUDA cores' FP32 lanes, not the tensor cores' headline. Mixes:

  fma   - s = fmaf(a, s, 1) chains (one FMA = one elem-op)
  mix   - d = s - a; s = fmaf(d, d, s) (the full-search term mix)
  roll  - s[c] + s[(c + 1) % cols] (the sliding-sum mix: a warp shuffle
          plus a hand-off between warps through shared memory)
  chain - the phase kernel's inner loop in isolation: per dy, 8 terms
          d = c - e; acc += d*d, then the minimum over 25 dy (P2)

Usage: python -m motionestimation_tpu_torch.tools.vpu_peak [fma mix roll chain]

Prints T elem-ops/s for each mix, counting ops as the JAX tool does. Each
time is taken with CUDA events around CHAIN back-to-back launches on one
stream (the median of `reps` such runs, after one warm-up call that also
builds the kernels), never with a host clock. The module constants are the
JAX tool's; `rows` (of `measure`) and `ch_w` (of `measure_chain`) can be
raised to fill the card.
"""
from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from motionestimation_tpu_torch.core.device import resolve_device
from motionestimation_tpu_torch.kernels import lab_cuda as lab

ROWS, COLS = 64, 1024   # the TPU tool's 256 KB float32 tile
INNER = 64              # ops per iteration
OUTER = 4096            # iterations
CHAIN = 4               # launches per timed run
CH_G, CH_BLK, CH_K, CH_W = 8, lab.CHAIN_BLK, lab.CHAIN_K, 2048
MIXES = tuple(lab.MIXES)


# The correctness check's inputs (not the tool's): at CHECK_OUTER
# iterations every step of each mix moves the result by far more than
# CHECK_TOL (relative; the kernel fuses multiply and add, torch does not),
# and every value stays finite. fma: a^16 per iteration still shows and
# the fixed point 1/(1 - a) is reached slowly; mix: x + (x - a)^2 grows
# doubly exponentially, so a stays small; roll: each step doubles.
CHECK_OUTER = 8
CHECK_RANGE = {"fma": (0.8, 0.99), "mix": (0.001, 0.005), "roll": (0.8, 0.99)}
CHECK_TOL = {"fma": 1e-4, "mix": 1e-4, "roll": 1e-5}


def peak_input(rows: int = ROWS, cols: int = COLS) -> torch.Tensor:
    """The tool's `a` on the CPU: uniform in (0.1, 0.9) x 1e-6 from
    default_rng(0), so the fma chain stays finite."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.1, 0.9, (rows, cols)).astype(np.float32)
    return torch.from_numpy(a * np.float32(1e-6))


def check_input(mix: str, rows: int = ROWS, cols: int = COLS) -> torch.Tensor:
    """`a` for checking a mix at CHECK_OUTER iterations, on the CPU: uniform
    in CHECK_RANGE[mix] from default_rng(0). The tool's own `a` settles the
    fma streams after one step and overflows mix and roll, so it would pass
    a kernel that skips steps."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(
        rng.uniform(*CHECK_RANGE[mix], (rows, cols)).astype(np.float32))


def chain_inputs(ch_w: int = CH_W):
    """The tool's (c, e) on the CPU: integer pixels from default_rng(0)."""
    rng = np.random.default_rng(0)
    c = rng.integers(0, 256, (CH_BLK * CH_G, ch_w)).astype(np.float32)
    e = rng.integers(0, 256, ((CH_BLK + CH_K - 1) * CH_G, ch_w)).astype(
        np.float32)
    return torch.from_numpy(c), torch.from_numpy(e)


def peak_ops(rows: int = ROWS) -> int:
    """Elem-ops of one P1 call, as the JAX tool counts them (an FMA, or a
    sub + FMA pair counted per op of INNER, or a roll + add pair)."""
    return rows * COLS * INNER * OUTER


def chain_ops(ch_w: int = CH_W) -> int:
    """Elem-ops of one P2 call: sub + FMA per term."""
    return 2 * CH_K * CH_BLK * CH_G * ch_w * lab.CHAIN_REPS


def run(a, *, mix: str, outer: int = OUTER, chain: int = CHAIN) -> torch.Tensor:
    """`chain` P1 calls on `a` back to back; returns the last output."""
    for _ in range(chain):
        out = lab.lab_peak(a, mix=mix, inner=INNER, outer=outer)
    return out


def run_chain(c, e, *, chain: int = CHAIN) -> torch.Tensor:
    """`chain` P2 calls back to back; returns the last output."""
    for _ in range(chain):
        out = lab.lab_chain(c, e, ch_g=CH_G)
    return out


def _per_call_s(fn, reps: int) -> float:
    """Median device seconds per launch: CUDA events around CHAIN calls,
    `reps` times, after one warm-up call."""
    fn(1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(reps):
        start.record()
        fn(CHAIN)
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / 1e3 / CHAIN)
    return statistics.median(ts)


def measure(mix: str, reps: int = 3, *, rows: int = ROWS) -> float:
    """Sustained T elem-ops/s of one mix on the card (an FMA = 1 elem-op)."""
    a = peak_input(rows).to(resolve_device())
    dt = _per_call_s(lambda n: run(a, mix=mix, chain=n), reps)
    return peak_ops(rows) / dt / 1e12


def measure_chain(reps: int = 3, *, ch_w: int = CH_W) -> float:
    """Sustained T elem-ops/s of the isolated chain on the card (sub + FMA
    = 2 ops per term): the phase kernel's achievable ceiling."""
    dev = resolve_device()
    c, e = (t.to(dev) for t in chain_inputs(ch_w))
    dt = _per_call_s(lambda n: run_chain(c, e, chain=n), reps)
    return chain_ops(ch_w) / dt / 1e12


def main(argv=None) -> int:
    mixes = (sys.argv[1:] if argv is None else argv) or [*MIXES, "chain"]
    print(f"# {torch.cuda.get_device_name(resolve_device())}")
    for mix in mixes:
        t = measure_chain() if mix == "chain" else measure(mix)
        print(f"{mix:5s} {t:7.3f} T elem-ops/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
