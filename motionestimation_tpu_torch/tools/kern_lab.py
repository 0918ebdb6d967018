"""Ablation lab for the full-search kernel: the port of the JAX repo's
`tools/kern_lab.py`, every one of its variants on the card.

Interior-only 2048x2048 8x8 +-12 work on float32 planes (random pixels,
the reference zero-padded by the span), timed per variant:

  NOP  - the start pair (3e8, 312) only, after staging (L1)
  L0   - exact SSD (Qcur - X) + (Qref - X) over all 625 offsets of the
         zero-padded reference, unmasked, through a product scratch (L1)
  L1   - L0 without the block sum: X is the raw product at the stripe's
         pixel row R (a deliberate ablation) (L1)
  M1   - L0 with each product split into bfloat16 hi and lo parts (exact)
  M2   - SAD over bfloat16 |c - e| (exact) (L1)
  M3   - L0 with each product rounded to bfloat16 (L1)
  P0   - exact SSD by the cross term (Qcur - X) + (Qref - X) (L2)
  P1   - exact SAD on the same kernel (L2); any other "P..." name not
         below is P0
  P3   - SSD by the cross term (Qcur + Qref) - 2X as L4's key (L3);
         P3S SAD; P3A and P3B the `nochain` / `nofold` ablations; any
         other "P3..." name is P3
  P4   - SSD by the diff form sum (c - e)^2, as a packed int32 key
         cost * 625 + flat - 2^31, INT32_MAX where invalid (L4); P4S SAD
  P5   - the diff form as L4's key (L5); "S" in the name: SAD; "B":
         bfloat16 planes (P5S, P5B, P5SB)
  P6   - SSD by the cross term (Qcur - X) + (Qref - X) as L4's key (L6);
         "B" in the name: bfloat16 planes (P6B). L6 has no SAD: P6S is SSD
  P7   - the diff form over bfloat16 planes as L4's key (L7); "S" in the
         name: SAD (P7S)

Variant spec: NAME[:tile_h[:chunk]], tile_h the pixel rows one CUDA block
covers (the TPU stripe height; default 128): a multiple of 8 dividing H.
chunk (default 5) schedules only the TPU's L1 kernel and changes no result;
it is accepted and must be positive for L1's variants, and is otherwise
unused. Names route as the JAX tool's `main` routes them; an unknown name
that reaches L1 prints FAILED with ValueError, as the JAX tool does.

Usage: python -m motionestimation_tpu_torch.tools.kern_lab NOP L0 P3:64 P6B

Each line: the median of REPS timed runs of CHAIN launches, CUDA events
around them, per launch; the first call's host time (kernel build and load
included) as "compile"; and a checksum of the outputs at block starts.
"""
from __future__ import annotations

import functools
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
DEFAULT_SPECS = ("NOP", "L0", "L1", "M1", "M2")  # the JAX tool's default


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


def run_variant(cur, ref_p, *, variant: str, tile_h: int = 128,
                chunk: int = 5):
    """L1: (float32 cost, int32 idx) per block. `chunk` only schedules the
    TPU kernel; like the JAX tool's `range(0, K, chunk)` it must be
    positive."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return lab.lab_padded(cur, ref_p, tile_h=tile_h, variant=variant)


def run_p3(cur, ref_p, *, tile_h: int = 128, sad: bool = False,
           ablate: str | None = None):
    """L3: the int32 key per block (P3B: the `nofold` minimum)."""
    return lab.lab_p3(cur, ref_p, tile_h=tile_h, sad=sad, ablate=ablate)


def run_p5(cur, ref_p, *, tile_h: int = 128, sad: bool = False,
           bf16: bool = False):
    """L5: the int32 key per block."""
    return lab.lab_p5(cur, ref_p, tile_h=tile_h, sad=sad, bf16=bf16)


def run_p6(cur, ref_p, *, tile_h: int = 128, bf16: bool = False):
    """L6: the int32 key per block."""
    return lab.lab_p6(cur, ref_p, tile_h=tile_h, bf16=bf16)


def run_p7(cur, ref_p, *, tile_h: int = 128, sad: bool = False):
    """L7: the int32 key per block."""
    return lab.lab_p7(cur, ref_p, tile_h=tile_h, sad=sad)


def decode_key(key: torch.Tensor):
    """(float32 cost, int32 flat index) from L4's key: key + 2^31 =
    cost * 625 + flat, read as unsigned."""
    u = key.to(torch.int64) - KEY_BIAS
    return (u // (K * K)).to(torch.float32), (u % (K * K)).to(torch.int32)


def checksum(cost: torch.Tensor, idx: torch.Tensor) -> float:
    """sum(cost) + sum(idx) over the block starts, in float64."""
    return float(cost.double().sum() + idx.double().sum())


def variant_fn(spec: str):
    """(run, decode) for a variant spec NAME[:tile_h[:chunk]], routed as
    the JAX tool's `main` routes it: run(cur, ref_p) launches the kernel
    once, decode(output) gives (cost, idx). An unknown name reaches L1 and
    raises ValueError, as the JAX tool's `make_kernel` does."""
    parts = spec.split(":")
    v = parts[0]
    tile_h = int(parts[1]) if len(parts) > 1 else 128
    chunk = int(parts[2]) if len(parts) > 2 else 5
    if v.startswith("P6"):
        run = functools.partial(run_p6, bf16="B" in v)
    elif v.startswith("P7"):
        run = functools.partial(run_p7, sad="S" in v)
    elif v.startswith("P5"):
        run = functools.partial(run_p5, sad="S" in v, bf16="B" in v)
    elif v.startswith("P4"):
        run = functools.partial(run_p4, sad=v == "P4S")
    elif v.startswith("P3"):
        run = functools.partial(run_p3, sad=v == "P3S", ablate=(
            "nochain" if v == "P3A" else "nofold" if v == "P3B" else None))
    elif v.startswith("P"):
        return (lambda cur, ref_p: run_phase(cur, ref_p, variant=v,
                                             tile_h=tile_h), tuple)
    else:
        lab.check_padded_variant(v)  # before any device is touched
        return (lambda cur, ref_p: run_variant(cur, ref_p, variant=v,
                                               tile_h=tile_h, chunk=chunk),
                tuple)
    return (lambda cur, ref_p: run(cur, ref_p, tile_h=tile_h), decode_key)


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
