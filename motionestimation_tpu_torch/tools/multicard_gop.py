"""Time the sharded GOP across cards, one process a card, beside `run_gop`
on one card.

Over the GOP of chip_smoke.py's GOP phase (33 frames at 3840x2160, the JAX
bench's headline GOP: a random frame, then each the previous moved by (1,
-2) plus noise in [-3, 3], from --seed), 8x8 +-12 MSE:

* `run_gop` on card 0 in this process: a warm-up, then --runs timed runs
  (resume=False), pairs/s;
* `run_gop_sharded` on a --mesh of --ranks processes joined by NCCL, one
  card a rank (`ingest.distributed_init`, `make_mesh`'s default devices),
  pipelined and per pair: a warm-up, then --runs timed runs each, the wall
  on rank 0 from a barrier before the call to one after it; every dump
  of the last run equal to `run_gop`'s, key for key;
* with --split, one pipelined chunk of 8 pairs (`sharded_gop_pipelined`
  and its gather to rank 0) split on rank 0 into its phases
  (`sharded_gop_pipelined`'s `phase` hook: the first frame's halo, and
  per pair the halo's issue, the search and the halo's wait; the stats;
  the gather), each by CUDA events on the compute stream with the host's
  ms beside it, and beside them the host ms of what run_gop_sharded does
  around the step on its main thread: the chunk's ingest (this rank's
  rows of 9 frames from disk to the card) and rank 0's readback and 8
  dumps; --runs times after a warm-up;
* with --model-rate M (M blocks/s of one card at 4K 8x8 +-12), the
  scaling model's pipelined-GOP efficiency for the mesh beside the
  measured one (pipelined pairs/s over --ranks times `run_gop`'s).

The card's name and power limit stand beside every number. The last line
is one JSON object of the numbers. Only public entry points are timed, so
a copy of this file dropped into another tree of the port times that
tree (run it from the tree's root; --split and --model-rate need this
tree's `parallel/`).

    python -m motionestimation_tpu_torch.tools.multicard_gop \
        --frames DIR [--ranks 4] [--mesh 1 2 2] [--runs 3] [--split] \
        [--model-rate M]

DIR receives the frames (written once, reused) and the dumps.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

H, W, BLK, SPAN, FRAMES = 2160, 3840, 8, 12, 33
CHUNK = 8


def card() -> str:
    """The first card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def frame_paths(frames_dir: str, seed: int) -> list[str]:
    """The GOP's frame files in `frames_dir`, written where missing."""
    paths = [os.path.join(frames_dir, f"gop_{i:03d}.yuv")
             for i in range(FRAMES)]
    if all(os.path.exists(p) for p in paths):
        return paths
    os.makedirs(frames_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, (H, W), dtype=np.uint8)
    for p in paths:
        prev = np.clip(np.roll(prev, (1, -2), (0, 1)).astype(np.int32)
                       + rng.integers(-3, 4, (H, W)), 0, 255).astype(np.uint8)
        prev.tofile(p)
    return paths


def config():
    from motionestimation_tpu_torch.core.config import SearchConfig

    return SearchConfig(blk_dim=BLK, span=SPAN, frame_width=W,
                        frame_height=H)


def best_pairs_s(fn, runs: int) -> tuple[float, list[float]]:
    """(best pairs/s, every run's) of `fn()` -> seconds, after a warm-up."""
    fn()
    rates = [(FRAMES - 1) / fn() for _ in range(runs)]
    return max(rates), rates


class PhaseTimer:
    """`phase(name)` brackets a block with CUDA events on the current
    stream and the host clock, summed by name."""

    def __init__(self):
        self.marks = []  # (name, start event, end event, host seconds)

    @contextlib.contextmanager
    def phase(self, name):
        import torch

        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        yield
        host = time.perf_counter() - t0
        end.record()
        self.marks.append((name, start, end, host))

    def split(self) -> dict[str, tuple[float, float]]:
        """name -> (device ms, host ms), summed; call after a sync."""
        out: dict[str, list[float]] = {}
        for name, start, end, host in self.marks:
            dev_ms, host_ms = out.setdefault(name, [0.0, 0.0])
            out[name] = [dev_ms + start.elapsed_time(end),
                         host_ms + host * 1e3]
        return {k: (v[0], v[1]) for k, v in out.items()}


def split_chunk(mesh, paths, runs: int, lead: bool, at: str) -> list[dict]:
    """One pipelined chunk of CHUNK pairs, split into its phases on this
    rank, --runs times after a warm-up; printed on rank 0."""
    import torch
    import torch.distributed as dist

    from motionestimation_tpu_torch.core import frames as frames_lib
    from motionestimation_tpu_torch.parallel import ingest, sharded
    from motionestimation_tpu_torch.pipeline import runner

    hp, wp = sharded.padded_dims_for_mesh(H, W, BLK, mesh)
    lo, hi = ingest.local_row_range(mesh, hp)
    r0, r1 = min(lo, H), min(hi, H)
    nby, nbx = -(-H // BLK), -(-W // BLK)
    kw = dict(mesh=mesh, blk_dim=BLK, span=SPAN, metric="mse",
              frame_height=H, frame_width=W)
    dump_dir = os.path.join(os.path.dirname(paths[0]), "split_dumps")
    os.makedirs(dump_dir, exist_ok=True)
    splits = []
    for rep in range(runs + 1):
        # The chunk's ingest on the host clock: this rank's rows of its
        # CHUNK + 1 frames read as run_gop_sharded reads them, padded,
        # stacked and copied to the card (`put_frame_batch`, where
        # run_gop_sharded stages through a pinned pool).
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stack = np.stack([np.pad(frames_lib.load_yuv_rows(p, H, W, r0, r1),
                                 ((0, (hi - lo) - (r1 - r0)), (0, wp - W)))
                          for p in paths[: CHUNK + 1]])
        shards = ingest.put_frame_batch(stack, mesh)
        torch.cuda.synchronize()
        ingest_ms = (time.perf_counter() - t0) * 1e3
        timer = PhaseTimer()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        with timer.phase("chunk"):
            local = sharded.sharded_gop_pipelined(shards, phase=timer.phase,
                                                  **kw)
            with timer.phase("gather"):
                res = sharded.gather(local, dst=0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        # Rank 0's readback and dumps as run_gop_sharded writes them.
        t0 = time.perf_counter()
        if res is not None:
            host = [t.cpu().numpy() for t in (
                res.mv_y[:, :nby, :nbx], res.mv_x[:, :nby, :nbx],
                res.best_cost[:, :nby, :nbx], res.sum_sq, res.frame_max)]
            for i in range(CHUNK):
                runner._dump(dump_dir, i, paths, config(), BLK * BLK,
                             host[0][i], host[1][i], host[2][i],
                             int(host[3][i]), int(host[4][i]))
        dump_ms = (time.perf_counter() - t0) * 1e3
        if rep == 0:
            continue
        split = timer.split()
        splits.append({k: [round(v[0], 4), round(v[1], 4)]
                       for k, v in split.items()} | {
            "wall_ms": round(wall, 4), "ingest_ms": round(ingest_ms, 4),
            "dump_ms": round(dump_ms, 4)})
        if lead:
            parts = ", ".join(f"{k} {v[0]:.4f} ({v[1]:.4f})"
                              for k, v in split.items() if k != "chunk")
            print(f"split of one pipelined chunk of {CHUNK} pairs on rank 0, "
                  f"run {rep}: device ms (host ms): {parts}; whole chunk "
                  f"{split['chunk'][0]:.4f} ({split['chunk'][1]:.4f}), wall "
                  f"to the sync {wall:.4f}; host ms outside the step: "
                  f"ingest {ingest_ms:.4f} (this rank's rows of {CHUNK + 1} "
                  f"frames from disk to the card), readback and {CHUNK} dumps "
                  f"{dump_ms:.4f} | {at}", flush=True)
    return splits


def worker(args) -> int:
    """One rank: the sharded GOP's timed runs (and the split)."""
    import torch
    import torch.distributed as dist

    from motionestimation_tpu_torch.parallel import ingest, make_mesh
    from motionestimation_tpu_torch.pipeline import runner

    rank, at = args.worker, args.card
    ingest.distributed_init(f"localhost:{args.port}", args.ranks, rank,
                            backend="nccl")
    mesh = make_mesh(*args.mesh)
    lead = rank == 0
    paths = frame_paths(args.frames, args.seed)
    result = {}
    for label, pipelined in (("pipelined", True), ("per pair", False)):
        out_dir = os.path.join(args.frames, "sharded_" + label.replace(
            " ", "_"))

        def once():
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            runner.run_gop_sharded(paths, config(), mesh=mesh,
                                   output_dir=out_dir, resume=False,
                                   pipelined=pipelined)
            torch.cuda.synchronize()
            dist.barrier()
            return time.perf_counter() - t0

        best, rates = best_pairs_s(once, args.runs)
        result[label] = {"best": best, "runs": rates}
        if lead:
            print(f"run_gop_sharded {label} on a {tuple(args.mesh)} mesh, "
                  f"{args.ranks} ranks on NCCL (one card each), over "
                  f"{FRAMES - 1} pairs: best of {args.runs} {best:.2f} "
                  f"pairs/s (runs {[round(r, 2) for r in rates]}, "
                  f"resume=False, after one warm-up) | {at}", flush=True)
    if args.split:
        result["split"] = split_chunk(mesh, paths, args.runs, lead, at)
    dist.barrier()
    dist.destroy_process_group()
    if lead:
        print("WORKER_RESULT " + json.dumps(result), flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def same_dumps(got_dir: str, want_dir: str) -> int:
    """The number of dumps in `got_dir`, each equal to `want_dir`'s on every
    key (dtype included); raises on a difference."""
    names = sorted(os.listdir(want_dir))
    if sorted(os.listdir(got_dir)) != names:
        raise AssertionError(f"{got_dir}: dumps differ from {want_dir}'s")
    for name in names:
        a = np.load(os.path.join(got_dir, name))
        b = np.load(os.path.join(want_dir, name))
        if sorted(a.files) != sorted(b.files) or not all(
                a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                for k in b.files):
            raise AssertionError(f"{got_dir}/{name} differs from run_gop's")
    return len(names)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", required=True)
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--mesh", type=int, nargs=3, default=[1, 2, 2])
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--split", action="store_true")
    p.add_argument("--model-rate", type=float, default=None)
    p.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", default=None, help=argparse.SUPPRESS)
    p.add_argument("--card", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker is not None:
        return worker(args)

    import torch

    from motionestimation_tpu_torch.pipeline import runner

    if torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"needs {args.ranks} cards, one a rank; have "
                         f"{torch.cuda.device_count()}")
    at = card()
    paths = frame_paths(args.frames, args.seed)
    single_dir = os.path.join(args.frames, "single")

    def single():
        t0 = time.perf_counter()
        runner.run_gop(paths, config(), output_dir=single_dir,
                       device="cuda:0", resume=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    single_best, single_runs = best_pairs_s(single, args.runs)
    print(f"run_gop on one card over {FRAMES - 1} pairs ({W}x{H} {BLK}x{BLK} "
          f"+-{SPAN} mse): best of {args.runs} {single_best:.2f} pairs/s (runs "
          f"{[round(r, 2) for r in single_runs]}, resume=False, after one "
          f"warm-up) | {at}", flush=True)
    torch.cuda.empty_cache()

    port = str(_free_port())
    cmd = [sys.executable, "-m", "motionestimation_tpu_torch.tools."
           "multicard_gop", "--frames", args.frames, "--ranks",
           str(args.ranks), "--mesh", *map(str, args.mesh), "--runs",
           str(args.runs), "--seed", str(args.seed), "--port", port,
           "--card", at] + (["--split"] if args.split else [])
    procs = [subprocess.Popen(cmd + ["--worker", str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(args.ranks)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=900)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            print(out)
            raise SystemExit(f"rank {r} failed (exit {proc.returncode})")
    lines = outs[0].splitlines()
    result = json.loads(next(ln for ln in lines
                             if ln.startswith("WORKER_RESULT "))[14:])
    for ln in lines:
        if not ln.startswith("WORKER_RESULT "):
            print(ln)
    for label in ("pipelined", "per pair"):
        n = same_dumps(os.path.join(args.frames, "sharded_" + label.replace(
            " ", "_")), single_dir)
        print(f"run_gop_sharded {label}: {n} dumps equal run_gop's on every "
              f"key")
    ranks = args.ranks
    measured = result["pipelined"]["best"] / (ranks * single_best)
    print(f"measured efficiency, pipelined: {measured:.4f} (best pipelined "
          f"pairs/s over {ranks} x run_gop's on one card) | {at}")
    summary = {"card": at, "mesh": args.mesh, "ranks": ranks,
               "run_gop": {"best": single_best, "runs": single_runs},
               **result, "efficiency_pipelined": measured}
    if args.model_rate is not None:
        from motionestimation_tpu_torch.parallel import scaling

        _, ty, tx = args.mesh
        model = scaling.spatial_gop_overlap_efficiency(
            frame_height=H, frame_width=W, blk_dim=BLK, span=SPAN,
            meshes=[(ty, tx)],
            measured_mblocks_per_s=args.model_rate)[ty * tx]
        summary["model_efficiency"] = model
        print(f"scaling model, pipelined GOP on ({ty}, {tx}) at "
              f"{args.model_rate} M blocks/s: efficiency {model:.4f} (kernel-"
              f"bound; host issue left out) | {at}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
