"""Driver "diamond_stream": the "stream" driver's closed loop of frame
pairs through one whole-frame search call (`stream.Loop` and
`stream.window`, imported), for a diamond search. It differs in what the
pairs are held to and in what a traced run hands the readers:

* the frames are `yardstick.textured`'s, with the mix's `texture` (a
  diamond walks far over a texture, and stops at once on the pixel noise
  of `yardstick.content`);
* the sampled pairs are held against the plain diamond
  (`yardstick/diamond.py`), not against an exhaustive search;
* a traced run hands the per-layer readers the diamond's bound
  (`yardstick/diamond_roofline.py`) of the pairs it traced, in its
  counters: `bound_ms_traced`, their sum in ms, over `bound_pairs` pairs.
  The pool repeats every `pool_frames` pairs, so each pool pair is
  searched by the reference once, after the window.
"""
from __future__ import annotations

import math
import sys
import time

import torch

from benchmark.drivers.stream import Loop, window
from benchmark.outcome import Check, Outcome, Reservoir, load_entry, note
from benchmark.yardstick import diamond, diamond_roofline, textured


class Reference:
    """The plain diamond of the pool's pairs on `dev`, each searched once:
    pair p searches pool frame (p + 1) mod n against frame p mod n, as the
    loop does."""

    def __init__(self, cfg, pool, dev):
        self.cfg, self.pool, self.dev = cfg, pool, dev
        self._found: dict = {}
        self._bounds: dict = {}

    def result(self, p: int) -> diamond.Diamond:
        n = self.pool.shape[0]
        if p % n not in self._found:
            cfg = self.cfg
            out = diamond.diamond_search(
                self.pool[(p + 1) % n].to(self.dev),
                self.pool[p % n].to(self.dev), blk=cfg["blk_dim"],
                span=cfg["span"], metric=cfg["metric"])
            self._found[p % n] = diamond.Diamond(*(t.cpu() for t in out))
        return self._found[p % n]

    def fields(self, p: int) -> torch.Tensor:
        """int32 [fields, nby, nbx]: the configuration's fields, the score's
        float32 bits as int32."""
        r = self.result(p)
        have = {"mv_y": r.mv_y, "mv_x": r.mv_x, "best_cost_i32": r.cost,
                "score": r.score.view(torch.int32)}
        return torch.stack([have[k] for k in self.cfg["fields"]])

    def bound_ms(self, p: int) -> float:
        """The diamond's bound of pair p, in ms."""
        q = p % self.pool.shape[0]
        if q not in self._bounds:
            cfg = self.cfg
            self._bounds[q] = diamond_roofline.bound_ms(
                self.result(q).trajectory.numpy(), span=cfg["span"],
                blk_dim=cfg["blk_dim"], frame_height=cfg["frame_height"],
                frame_width=cfg["frame_width"])
        return self._bounds[q]


def blocks_differing(reference: Reference, sample) -> int:
    """Blocks of the sampled pairs where any field read back differs from
    the reference's."""
    return sum(int((torch.from_numpy(got) != reference.fields(p)).any(0)
                   .sum()) for p, got in sorted(sample.items.items()))


def run(cell, *, seed: int, seconds: float, trace: bool, started: float,
        device=None, entry=None) -> Outcome:
    """One run of a diamond stream cell; `entry` replaces the
    configuration's (the control, and the faults of the harness's tests)."""
    cfg, mix = cell.config, cell.mix
    dev = torch.device(device or "cuda:0")
    cuda = dev.type == "cuda"
    note(started, f"torch imported, device {dev}")
    h, w, blk = cfg["frame_height"], cfg["frame_width"], cfg["blk_dim"]
    grid = (-(-h // blk), -(-w // blk))
    frames = textured.gop_frames(seed, mix["pool_frames"], h, w,
                                 shift=mix["shift"], noise=mix["noise"],
                                 texture=mix["texture"], device=dev)
    pool = torch.empty(frames.shape, dtype=torch.uint8, pin_memory=cuda)
    pool.copy_(frames)
    del frames
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    note(started, f"{mix['pool_frames']} frames made and pinned")
    loop = Loop(entry or load_entry(cfg["entry"]),
                dict(cfg["entry_kwargs"], device=dev), cfg["fields"], pool,
                dev, mix["chunk_pairs"], grid, trace)
    loop.warm(mix["warm_chunks"])
    note(started, f"{mix['warm_chunks']} chunks warmed up")
    sample = Reservoir(mix["sample_pairs"], seed)
    plan = (mix["trace_skip_chunks"], mix["trace_chunks"]) if trace else None
    first = loop.pairs
    t0, end, lat, pairs, tr = window(loop, seconds, sample, plan)
    setup_s = t0 - started
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    counters = {"search_host_s": loop.search_s,
                "search_calls": loop.search_calls}
    del loop
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    lat.sort()
    p95 = lat[math.ceil(0.95 * len(lat)) - 1]
    values = {"pairs_per_s": pairs / (end - t0), "pair_ms_p95": p95 * 1e3,
              "setup_s": setup_s}
    t = time.perf_counter()
    reference = Reference(cfg, pool, dev)
    bad = blocks_differing(reference, sample)
    print(f"reference: {len(sample.items)} pairs compared in "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
    if tr is not None:
        skip, chunk = mix["trace_skip_chunks"], mix["chunk_pairs"]
        traced = range(first + skip * chunk,
                       first + (skip + mix["trace_chunks"]) * chunk)
        counters.update(bound_ms_traced=sum(map(reference.bound_ms, traced)),
                        bound_pairs=len(traced))
    checks = [Check("blocks_differing", bad, 0),
              Check("pairs_unchecked", mix["sample_pairs"] - len(sample.items),
                    0)]
    return Outcome(attempted=pairs, failed=0, values=values,
                   memory_peak_bytes=int(peak), checks=checks,
                   counters=counters, trace=tr,
                   busy_s=tr.busy_s if tr else None,
                   window_s=tr.window_s if tr else None)
