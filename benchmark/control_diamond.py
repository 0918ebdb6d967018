"""The control of the diamond cells: the plain diamond
(`yardstick/diamond.py`) put in the program's place one precision below
what the configuration states (int16 costs for the int32 SSD). It has to
come out as not correct.

    python3 -m benchmark.control_diamond --workload NAME --seeds 11 12 13 \
        [--seconds S]

The cell's driver runs with the control as the entry, for a short window
at the cell's own load. One line a seed: the checks' readings.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark.control import Field
from benchmark.drivers import diamond_stream
from benchmark.run import load_cell
from benchmark.yardstick import diamond


def entry(cfg):
    """A stream entry computing the plain diamond with int16 costs."""
    def search(cur, ref, **_):
        out = diamond.diamond_search(cur, ref, blk=cfg["blk_dim"],
                                     span=cfg["span"], metric=cfg["metric"],
                                     dtype=torch.int16)
        return Field(out.mv_y, out.mv_x, out.cost, out.score)

    return search


def readings(cell, seed: int, seconds: float, device=None) -> dict:
    """{check: value} of the control on one seed."""
    checks = diamond_stream.run(cell, seed=seed, seconds=seconds,
                                trace=False, started=time.perf_counter(),
                                device=device,
                                entry=entry(cell.config)).checks
    return {c.name: c.value for c in checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": readings(cell, seed, args.seconds)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
