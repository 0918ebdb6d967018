"""How the bench and chip_smoke.py measure, on the card: a pass of
back-to-back calls, one profiler pass, the kernels' launch counts, the
pinned h2d link rate, the disk read rate, and the card's name and power
limit.

The profiler pass reads the card's activity from `torch.profiler` (CUPTI).
The search kernels and diamond's replay and walk, launched through ctypes
from kernels/csrc, appear there by their C++ names, all in namespace `me`
(`me::warp_search_kernel`, `me::edge::edge_search_kernel`,
`me::diamond::replay_kernel`, `me::diamond::walk::walk_kernel`); every
other device event is PyTorch's.
"""
from __future__ import annotations

import dataclasses
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from motionestimation_tpu_torch.core import frames as frames_lib
from motionestimation_tpu_torch.kernels import diamond_cuda as dc
from motionestimation_tpu_torch.kernels import full_search_cuda as kc
from motionestimation_tpu_torch.kernels import ssim_cuda as sc

EMIT = " (emit)"
# Launcher name -> wrapper: the search kernels (K1-K7) and diamond's
# replay and walk.
WRAPPERS = {
    "me_phase_search": kc.phase_search,
    "me_int_search": kc.int_search,
    "me_ssim_fast_search": sc.ssim_fast_search,
    "me_ssim_search": sc.ssim_search,
    "me_chunked_search": kc.chunked_search,
    "me_chunked_u8_search": kc.chunked_u8_search,
    "me_wide_search": kc.wide_search,
    "me_diamond_replay": dc.replay_cuda,
    "me_diamond_walk": dc.walk_cuda,
}
# Host ops that are the profiler's own or the pass's closing wait, left out
# of the ranking of host work, and how many of the rest a profile names.
_NOT_THE_PROGRAM = ("Activity Buffer Request", "cudaDeviceSynchronize")
TOP_HOST_OPS = 5


def smi(query: str) -> str:
    """The first card's `nvidia-smi --query-gpu=<query>
    --format=csv,noheader`."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return smi("name,power.limit")


def counters(wrappers=None) -> dict[str, tuple[object, str]]:
    """Name -> (wrapper, counter attribute) for each kernel (the search
    kernels unless `wrappers` names others): its launches, and its emit
    mode's (the launches that write a volume) apart as "<name> (emit)"."""
    out = {}
    for name, fn in (WRAPPERS if wrappers is None else wrappers).items():
        out[name] = (fn, "launches")
        if hasattr(fn, "volume_launches"):
            out[name + EMIT] = (fn, "volume_launches")
    return out


def launch_counts() -> dict[str, int]:
    """Each search kernel's launches so far, from its wrapper's counter."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in counters().items()}


def pass_ms(calls) -> float:
    """The calls (zero-argument functions) back to back between CUDA
    events, in ms per call: the host's issue included wherever the card
    waits for it."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for call in calls:
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(calls)


@dataclasses.dataclass
class Profile:
    """One profiled pass of n calls, per call: the search kernels by C++
    name (launches per call, mean device ms per launch) and their device ms
    in all, the kernel records the profiler lacked, the operations on the
    card, the launches by wrapper, the card's busy ms (the union of its
    activity) and its idle share of the profiled pass's window, the host
    ops' self CPU time in all and the ops with the most of it.

    The profiler slows the host's issue, so `idle` describes a slower pass
    than a timed one; `idle_of(call_ms)` is the idle share of a timed call
    that does the same work on the card."""

    kernel_ms: float
    kernels: dict[str, tuple[int, float]]
    lost: int
    device_ops: float
    launches: dict[str, float]
    busy_ms: float
    idle: float
    host_ms: float
    host_ops: list[tuple[str, float]]  # (name, self CPU ms)

    def idle_of(self, call_ms: float) -> float:
        """The card's idle share of a timed call of `call_ms`: 1 - the busy
        ms the profile saw per call over the call's ms (below 0 where the
        profiled pass kept the card busier than the timed one took)."""
        return 1.0 - self.busy_ms / call_ms

    def describe(self, call_ms: float | None = None) -> str:
        names = ", ".join(f"{k} {c} x {ms:.4f} ms"
                          for k, (c, ms) in self.kernels.items()) or "none"
        rest = idle = ""
        if call_ms is not None:
            rest = f"; the call minus kernels {call_ms - self.kernel_ms:.4f} ms"
            idle = (f"{self.idle_of(call_ms):.1%} of the timed pass (1 - "
                    f"busy / call ms), ")
        lost = (f" ({self.lost} kernel records missing from the profiler's "
                f"CUDA activity: each kernel's ms is the mean of those it "
                f"has)" if self.lost else "")
        ops = ", ".join(f"{name} {ms:.4f}" for name, ms in self.host_ops)
        return (f"kernels {self.kernel_ms:.4f} ms per call [{names}]{lost}"
                f"{rest}; launches per call {self.launches}; "
                f"{self.device_ops:g} operations on the card per call; card "
                f"busy {self.busy_ms:.4f} ms per call, idle {idle}"
                f"{self.idle:.1%} of the profiled pass; host ops "
                f"{self.host_ms:.4f} ms self CPU per call (profiled), the "
                f"most: {ops}")


def _short(name: str) -> str:
    """A kernel's C++ name without `void ` and its parameter list."""
    name = name.removeprefix("void ")
    return name[: name.index(">(") + 1] if ">(" in name else name


def _union_ns(intervals) -> float:
    busy, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def host_self_ms(raw) -> dict[str, float]:
    """Self CPU ms by op name from the profiler's raw events: each CPU
    event's duration less those of the events nested in it on its thread,
    as `key_averages` counts self time, without building its event tree."""
    by_thread: dict[int, list] = {}
    for e in raw:
        if e.device_type() == DeviceType.CPU:
            by_thread.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.duration_ns(), e.name()))
    total: dict[str, float] = {}
    for events in by_thread.values():
        events.sort()
        stack = []  # [end, self ns, name] of the open ancestors
        for start, neg_dur, name in events:
            while stack and stack[-1][0] <= start:
                end, own, done = stack.pop()
                total[done] = total.get(done, 0.0) + own / 1e6
            if stack:
                stack[-1][1] += neg_dur
            stack.append([start - neg_dur, -neg_dur, name])
        for end, own, done in stack:
            total[done] = total.get(done, 0.0) + own / 1e6
    return total


def profile_pass(call, n: int, device: torch.device) -> Profile:
    """n calls of `call` under `torch.profiler` (CPU and CUDA activity),
    ending in a synchronize, read per call from the profiler's raw events
    (n calls of the same work). Busy: the union of the card's activity;
    the idle share is 1 - busy over the window from the first event to the
    last. Host ops: self CPU time
    (`host_self_ms`), the profiler's own bookkeeping and the closing
    synchronize left out. Launch counts are differences of the counters,
    which it leaves as they are."""
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize(device)
    after = launch_counts()
    raw = prof.profiler.kineto_results.events()
    on_card = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
               for e in raw if e.device_type() == DeviceType.CUDA]
    records: dict[str, list[float]] = {}
    for start, end, name in on_card:
        if name.startswith("void me::"):
            records.setdefault(_short(name), []).append((end - start) / 1e6)
    # Every call of a pass does the same work, so a kernel launches a whole
    # number of times per call; the profiler's activity may lack a record.
    kernels = {k: (max(1, round(len(ms) / n)), sum(ms) / len(ms))
               for k, ms in records.items()}
    first = min(e.start_ns() for e in raw)
    last = max(e.start_ns() + e.duration_ns() for e in raw)
    busy = _union_ns((a, b) for a, b, _ in on_card)
    host = sorted(((name, ms / n) for name, ms in host_self_ms(raw).items()
                   if name not in _NOT_THE_PROGRAM), key=lambda op: -op[1])
    return Profile(
        kernel_ms=sum(c * ms for c, ms in kernels.values()),
        kernels=kernels,
        lost=sum(kernels[k][0] * n - len(ms) for k, ms in records.items()),
        device_ops=len(on_card) / n,
        launches={k: (after[k] - before[k]) / n for k in after
                  if after[k] != before[k]},
        busy_ms=busy / 1e6 / n,
        idle=1.0 - busy / (last - first) if last > first else 0.0,
        host_ms=sum(ms for _, ms in host),
        host_ops=host[:TOP_HOST_OPS],
    )


def disk_rate(paths, h: int, w: int, reader=None) -> float:
    """MB/s of reads of the files (h x w luma frames) into one recycled
    buffer by `reader(path, buf)`, by default `load_yuv_into` (the native
    reader)."""
    reader = reader or frames_lib.load_yuv_into
    buf = np.empty((h, w), np.uint8)
    t0 = time.perf_counter()
    for path in paths:
        reader(path, buf)
    return len(paths) * h * w / 1e6 / (time.perf_counter() - t0)


def h2d_rate(frames, device: torch.device, *, check: bool = False) -> float:
    """MB/s of pinned h2d on a copy stream alone: the frames (uint8 numpy
    arrays) copied into pinned buffers first (untimed), then to the card
    back to back on a copy stream between CUDA events. With `check`, raises
    ValueError where a frame arrived changed."""
    pinned = [torch.from_numpy(np.ascontiguousarray(f)).pin_memory()
              for f in frames]
    staged = [torch.empty(p.shape, dtype=p.dtype, device=device)
              for p in pinned]
    copy = torch.cuda.Stream(device)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(copy):
        start.record(copy)
        for src, dst in zip(pinned, staged):
            dst.copy_(src, non_blocking=True)
        end.record(copy)
    end.synchronize()
    if check:
        for i, (src, dst) in enumerate(zip(pinned, staged)):
            if not torch.equal(dst.cpu(), src):
                raise ValueError(f"pinned h2d: frame {i} arrived changed")
    nbytes = sum(p.numel() for p in pinned)
    return nbytes / 1e6 / (start.elapsed_time(end) / 1e3)
