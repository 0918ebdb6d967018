"""The control: the plain reference put in the program's place, one
precision below what the configuration states (int16 costs for the int32
SSD and SAD, bfloat16 arithmetic for the float32 SSIM). It has to come
out as not correct; its readings set the upper end of each limit.

    python3 -m benchmark.control --workload NAME --seeds 11 12 13 \
        [--seconds S]

A stream cell runs its driver with the control as the entry, for a short
window at the cell's own load. One line a seed: the checks' readings.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import torch

from benchmark.drivers import stream
from benchmark.run import load_cell
from benchmark.yardstick import reference


class Field(NamedTuple):
    mv_y: torch.Tensor
    mv_x: torch.Tensor
    best_cost_i32: torch.Tensor
    score: torch.Tensor


def entry(cfg):
    """A stream entry computing the reference one precision below."""
    blk, span, metric = cfg["blk_dim"], cfg["span"], cfg["metric"]

    def search(cur, ref, **_):
        if metric == "ssim":
            return Field(*reference.ssim_search(cur, ref, blk=blk, span=span,
                                                dtype=torch.bfloat16))
        my, mx, cost = reference.full_search(cur, ref, blk=blk, span=span,
                                             metric=metric,
                                             dtype=torch.int16)
        h, w = cur.shape
        score = torch.from_numpy(reference.mean_score(
            cost.cpu().numpy(), h, w, blk)).to(cost.device)
        return Field(my, mx, cost, score)

    return search


def readings(cell, seed: int, seconds: float, device=None) -> dict:
    """{check: value} of the control on one seed."""
    checks = stream.run(cell, seed=seed, seconds=seconds, trace=False,
                        started=time.perf_counter(), device=device,
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
