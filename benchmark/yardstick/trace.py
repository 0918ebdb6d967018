"""Reading `torch.profiler`'s trace of a traced window.

A traced run wraps a steady part of its window in `torch.profiler.profile`
(CPU and CUDA activities) and in a `record_function(WINDOW)` span; the
harness's own spans around its calls into the program are
`record_function` spans too. `Trace.record` exports the profile as a
Chrome trace and keeps what the metrics read:

* the card's operations (kernels, copies, memsets) with their
  correlation ids, clipped to the window;
* each launch on the host (a CUDA runtime or driver call) by correlation id,
  so an operation can be placed inside the host span that launched it;
* the harness's spans and the host's operations, to name what the host
  was doing while the card sat idle.

The busy time is the union of the card's operation intervals, so
overlapping streams count once.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def union(intervals):
    """Sorted, merged [(start, end)] of `intervals`."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    """The events of one traced window; times in seconds of the trace's
    clock."""

    def __init__(self, events: list[dict]):
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name") == WINDOW]
        if not spans:
            raise ValueError(f"no {WINDOW!r} span in the trace")
        w = spans[0]
        self.start = w["ts"] * 1e-6
        self.end = (w["ts"] + w["dur"]) * 1e-6
        self.main_tid = w.get("tid")
        self.device = []   # (start, end, name, correlation, category)
        self.launch = {}   # correlation -> (host ts, tid)
        self.host = []     # (start, end, name, cat, tid)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            a = e["ts"] * 1e-6
            b = a + e.get("dur", 0) * 1e-6
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                a, b = max(a, self.start), min(b, self.end)
                if b > a:
                    self.device.append((a, b, e.get("name", "?"), corr, cat))
            if cat in LAUNCH_CATS and corr is not None:
                self.launch[corr] = (a, e.get("tid"))
            if cat in HOST_CATS and e.get("name") != WINDOW:
                self.host.append((a, b, e.get("name", "?"), cat,
                                  e.get("tid")))
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]
        self._longest = max((b - a for a, b, *_ in self.host), default=0.0)

    @classmethod
    def record(cls, prof) -> "Trace":
        """The trace of a finished `torch.profiler.profile`, through a
        temporary file that is removed again."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self):
        return union((a, b) for a, b, *_ in self.device)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_pct(self) -> float | None:
        """The share of the window in which no operation ran on the card,
        in %; None without any operation."""
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def spans(self, name: str):
        """[(start, end, tid)] of the harness spans called `name`."""
        return [(a, b, tid) for a, b, n, cat, tid in self.host
                if cat == "user_annotation" and n == name]

    def launched_in(self, name: str):
        """The card's operations whose launch lies inside a span `name` of
        the same host thread: [(start, end, op name, category)]."""
        spans = self.spans(name)
        out = []
        for a, b, op, corr, cat in self.device:
            at = self.launch.get(corr)
            if at is None:
                continue
            ts, tid = at
            if any(s <= ts <= e and t == tid for s, e, t in spans):
                out.append((a, b, op, cat))
        return out

    def top_device_ops(self, n: int = 10):
        """[[op name, seconds]] of the n operations that took the most
        time on the card in the window, summed by name."""
        total: dict[str, float] = defaultdict(float)
        for a, b, op, *_ in self.device:
            total[op] += b - a
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def _doing(self, t: float) -> str:
        """What the window's host thread was doing at `t`: the innermost
        harness span and the innermost operation or call around it."""
        span = op = None
        i = bisect.bisect_right(self._host_starts, t)
        for a, b, name, cat, tid in reversed(self.host[:i]):
            if a < t - self._longest:
                break
            if tid != self.main_tid or b < t:
                continue
            if cat == "user_annotation":
                span = span or name
            else:
                op = op or name
            if span and op:
                break
        if span and op:
            return f"{span}: {op}"
        return span or op or "(outside any span or operation)"

    def idle_gaps(self, n: int = 10):
        """[[host activity, seconds]]: the card's idle time in the window,
        each gap named by what the host thread was doing at its middle,
        summed by name, the n largest."""
        total: dict[str, float] = defaultdict(float)
        edge = self.start
        for a, b in self.busy_intervals() + [(self.end, self.end)]:
            if a > edge:
                total[self._doing((edge + a) / 2)] += a - edge
            edge = max(edge, b)
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]
