"""Driver "stream": frame pairs in a closed loop through one whole-frame
search call of the program, as a decoder hands frames to it.

Set-up makes the mix's pool of frames on the card from the seed
(`yardstick.content`), holds them in pinned host memory, and warms the
loop up on the cell's own shapes. Then, for `seconds`:

* each pair copies one new frame from the pool to the card on the
  harness's copy stream, with one event a frame that the compute stream
  waits on, so the copy overlaps the previous search; the previous frame
  stays on the card as the reference;
* the configuration's entry searches (cur = new frame, ref = previous);
  the fields the configuration names are packed into the chunk's output;
* every `chunk_pairs` pairs, the chunk's outputs go back in one
  non-blocking copy into pinned memory; the next chunk is dispatched
  before the host waits on the last one.

A pair's time runs from the enqueue of its frame's copy to the moment the
host sees its chunk in host memory. After the window, a sample of the
window's pairs drawn from the seed is searched again by the plain
reference and compared block for block.
"""
from __future__ import annotations

import math
import sys
import time

import torch

from benchmark.outcome import (Check, Outcome, Reservoir, load_entry, note,
                               spans)
from benchmark.yardstick import content, reference
from benchmark.yardstick.trace import WINDOW, Trace


def _as_i32(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t.to(torch.int32)


class Loop:
    """The pair loop on one device: a ring of frame slots on the card, two
    chunk output buffers on the card and in pinned host memory."""

    def __init__(self, entry, kwargs, fields, pool, dev, chunk, grid, trace):
        self.entry, self.kwargs, self.fields = entry, kwargs, fields
        self.frames = list(pool.unbind(0))
        self.dev, self.chunk = dev, chunk
        self.cuda = dev.type == "cuda"
        _, h, w = pool.shape
        self.slots = 2 * chunk + 2
        self.ring = torch.empty((self.slots, h, w), dtype=torch.uint8,
                                device=dev)
        shape = (2, chunk, len(fields), *grid)
        self.out_dev = torch.empty(shape, dtype=torch.int32, device=dev)
        self.out_host = torch.empty(shape, dtype=torch.int32,
                                    pin_memory=self.cuda)
        self.copier = torch.cuda.Stream(dev) if self.cuda else None
        self.free = [None] * self.slots   # slot -> event: last read done
        self.done = [None, None]          # buffer -> event: chunk on host
        self.pairs = 0                    # pairs dispatched so far
        self.enqueued = {}                # pair -> host time of its copy
        self.span = spans(trace)
        self.timing = False               # sum the search calls' host time
        self.search_s, self.search_calls = 0.0, 0
        self._copy(0)

    def _copy(self, k: int) -> None:
        """Stream frame k (pool frame k mod pool size) into its slot; the
        compute stream waits for it."""
        s = k % self.slots
        src = self.frames[k % len(self.frames)]
        if not self.cuda:
            self.ring[s].copy_(src)
            return
        with torch.cuda.stream(self.copier):
            if self.free[s] is not None:
                self.copier.wait_event(self.free[s])
            self.ring[s].copy_(src, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.copier)
        torch.cuda.current_stream(self.dev).wait_event(ready)

    def dispatch(self):
        """Enqueue one chunk; returns (buffer, its pair indices)."""
        buf = (self.pairs // self.chunk) % 2
        pairs, outs = [], []
        for _ in range(self.chunk):
            p = self.pairs
            self.pairs += 1
            pairs.append(p)
            with self.span("h2d_issue"):
                self.enqueued[p] = time.perf_counter()
                self._copy(p + 1)
            with self.span("search"):
                t0 = time.perf_counter()
                f = self.entry(self.ring[(p + 1) % self.slots],
                               self.ring[p % self.slots], **self.kwargs)
                if self.timing:
                    self.search_s += time.perf_counter() - t0
                    self.search_calls += 1
            outs.extend(_as_i32(getattr(f, k)) for k in self.fields)
        with self.span("pack"):
            torch.stack(outs, out=self.out_dev[buf].flatten(0, 1))
        with self.span("readback_issue"):
            self.out_host[buf].copy_(self.out_dev[buf], non_blocking=self.cuda)
            if self.cuda:
                self.done[buf] = torch.cuda.Event()
                self.done[buf].record()
                for p in pairs:   # frame p's last reader is pair p
                    self.free[p % self.slots] = self.done[buf]
        return buf, pairs

    def finish(self, chunk, latencies=None, sample=None) -> float:
        """Wait until a chunk is in host memory; record its pairs' times
        and offer them to the sample. Returns the host time it was seen."""
        buf, pairs = chunk
        with self.span("wait_chunk"):
            if self.cuda:
                self.done[buf].synchronize()
        seen = time.perf_counter()
        for j, p in enumerate(pairs):
            t = self.enqueued.pop(p)
            if latencies is not None:
                latencies.append(seen - t)
            if sample is not None:
                sample.offer(p, lambda j=j: self.out_host[buf, j].numpy().copy())
        return seen

    def warm(self, chunks: int) -> None:
        pending = self.dispatch()
        for _ in range(chunks - 1):
            nxt = self.dispatch()
            self.finish(pending)
            pending = nxt
        self.finish(pending)
        if self.cuda:
            torch.cuda.synchronize(self.dev)


def _profiler(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def window(loop: Loop, seconds: float, sample, trace_plan=None):
    """The measured window: (first enqueue time, time the last chunk was
    seen, latencies, pairs, trace). `trace_plan` (skip, chunks): profile
    the `chunks` chunks dispatched after the first `skip`, the window
    lasting until they are done. The last of them is read back before the
    profile closes, with no chunk dispatched behind it, so every search
    call traced has all its work on the card inside the profile."""
    latencies = []
    prof = rf = trace = None
    started = loop.pairs
    t0 = time.perf_counter()
    pending = loop.dispatch()
    n = 1
    while True:
        if trace_plan and n == trace_plan[0] and prof is None:
            prof = _profiler(loop.cuda)
            prof.__enter__()
            rf = torch.profiler.record_function(WINDOW)
            rf.__enter__()
            loop.timing = True
        closing = prof is not None and trace is None and n == sum(trace_plan)
        tracing_left = trace_plan is not None and trace is None
        more = time.perf_counter() - t0 < seconds or tracing_left
        nxt = loop.dispatch() if more and not closing else None
        n += nxt is not None
        end = loop.finish(pending, latencies, sample)
        if closing:
            rf.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            loop.timing = False
            trace = Trace.record(prof)
            if time.perf_counter() - t0 < seconds:
                nxt = loop.dispatch()
                n += 1
        if nxt is None:
            break
        pending = nxt
    return t0, end, latencies, loop.pairs - started, trace


def _reference_fields(cfg, cur, ref):
    blk, span, metric = cfg["blk_dim"], cfg["span"], cfg["metric"]
    if metric == "ssim":
        my, mx, idx, score = reference.ssim_search(cur, ref, blk=blk,
                                                   span=span)
        return {"mv_y": my, "mv_x": mx, "best_cost_i32": idx,
                "score": score.view(torch.int32)}
    my, mx, cost = reference.full_search(cur, ref, blk=blk, span=span,
                                         metric=metric)
    h, w = cur.shape
    score = torch.from_numpy(reference.mean_score(
        cost.cpu().numpy(), h, w, blk)).view(torch.int32)
    return {"mv_y": my, "mv_x": mx, "best_cost_i32": cost, "score": score}


def blocks_differing(cfg, pool, sample, dev) -> int:
    """Blocks of the sampled pairs where any field read back differs from
    the reference's."""
    n = pool.shape[0]
    bad = 0
    for p, got in sorted(sample.items.items()):
        cur = pool[(p + 1) % n].to(dev)
        ref = pool[p % n].to(dev)
        want = _reference_fields(cfg, cur, ref)
        want = torch.stack([want[k].cpu().to(torch.int32)
                            for k in cfg["fields"]])
        bad += int((torch.from_numpy(got) != want).any(0).sum())
    return bad


def run(cell, *, seed: int, seconds: float, trace: bool, started: float,
        device=None, entry=None) -> Outcome:
    """One run of a stream cell; `entry` replaces the configuration's
    (the control, and the faults of the harness's tests)."""
    cfg, mix = cell.config, cell.mix
    dev = torch.device(device or "cuda:0")
    cuda = dev.type == "cuda"
    note(started, f"torch imported, device {dev}")
    h, w, blk = cfg["frame_height"], cfg["frame_width"], cfg["blk_dim"]
    grid = (-(-h // blk), -(-w // blk))
    frames = content.gop_frames(seed, mix["pool_frames"], h, w,
                                shift=mix["shift"], noise=mix["noise"],
                                device=dev)
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
    bad = blocks_differing(cfg, pool, sample, dev)
    print(f"reference: {len(sample.items)} pairs compared in "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
    checks = [Check("blocks_differing", bad, 0),
              Check("pairs_unchecked", mix["sample_pairs"] - len(sample.items),
                    0)]
    return Outcome(attempted=pairs, failed=0, values=values,
                   memory_peak_bytes=int(peak), checks=checks,
                   counters=counters, trace=tr,
                   busy_s=tr.busy_s if tr else None,
                   window_s=tr.window_s if tr else None)
