"""What a driver hands back to the harness, and the pieces drivers share."""
from __future__ import annotations

import contextlib
import importlib
import sys
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Check:
    """One number compared with the reference, beside its limit: the run is
    correct while every value stays at or below its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """A run's readings. `values`: the end-to-end metrics the driver
    measured, by name; `counters`: counts and host times the per-layer
    metrics read; `trace`: the traced window (`yardstick.trace.Trace`) of
    the first card, None in an untraced run; `busy_s` and `window_s`:
    averaged over the cards used, from their traces."""
    attempted: int
    failed: int
    values: dict
    memory_peak_bytes: int
    checks: list
    counters: dict = field(default_factory=dict)
    trace: object = None
    busy_s: float | None = None
    window_s: float | None = None


class Reservoir:
    """A uniform sample of `k` items of a stream of unknown length, drawn
    from `seed` (reservoir sampling): `offer(key, take)` calls `take()`
    only for an item that enters the sample."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(int(seed))
        self.seen = 0
        self.items: dict = {}
        self._slots: list = []

    def offer(self, key, take) -> None:
        if self.seen < self.k:
            self._slots.append(key)
            self.items[key] = take()
        else:
            r = int(self.rng.integers(0, self.seen + 1))
            if r < self.k:
                del self.items[self._slots[r]]
                self._slots[r] = key
                self.items[key] = take()
        self.seen += 1


def load_entry(path: str):
    """The function named "package.module:function"."""
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


def spans(on: bool):
    """`record_function` where the run is traced, else a no-op context."""
    if on:
        import torch

        return torch.profiler.record_function
    return lambda name: contextlib.nullcontext()


def note(started: float, what: str) -> None:
    """A set-up step on standard error, with the seconds since `started`."""
    print(f"setup: {what} at {time.perf_counter() - started:.3f} s",
          file=sys.stderr, flush=True)
