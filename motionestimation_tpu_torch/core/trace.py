"""Spans of the port's steps on the profiler's clock.

`span(name)` records a user annotation, the event
`torch.profiler.record_function` records, while a profiler is recording
(`torch.profiler.profile`, the CLI's `--profile DIR`, a traced benchmark
window), so the span lands in that trace beside the host calls and card
operations it covers. Otherwise it is one shared null context: an
unrecorded `record_function` still costs a dispatcher call a span.

While recording, the span enters torch's user-scope record directly
(`torch._C._autograd._record_function_with_args_enter`, the binding of the
record `record_function` opens) and not through `record_function`'s
operator dispatch: on an NVIDIA H100's host that dispatch added 0.1-0.6
ms to a search call of four to seven spans, enough to leave the card
idle in a traced window.

The spans, in `kernels/full_search_cuda.py`, `kernels/ssim_cuda.py`,
`kernels/diamond_cuda.py`, `kernels/_build.py` and `search/diamond.py`:

* `me.search`: one whole-frame search call (full search, SSIM, diamond);
* `me.operands`: its operands on the device, uint8, the reference's halo;
* `me.launch`: a kernel's output tensors and its ctypes launch, or the
  launch of a staged diamond level's CUDA graph;
* `me.edges`: the truncated bottom row and right column, and the merge;
* `me.decode`: MVs and scores from the block grids;
* `me.kernel_load`: a kernel library built or opened;
* `me.level`: one staged diamond level, its volume and its replay;
* `me.escape_wait`: the host's wait on a staged level's escape mask.

Counters are attributes of the functions that count: a kernel wrapper's
`launches`, `diamond_search_frame.calls`, `_diamond_staged.levels`.
"""
from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch._C import _autograd

_OFF = contextlib.nullcontext()


class _Span:
    """One recorded user annotation, ended on exit, exception or not."""

    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.record = _autograd._record_function_with_args_enter(self.name)
        return self

    def __exit__(self, *exc):
        _autograd._record_function_with_args_exit(self.record)


def span(name: str):
    """A context recording `name` in the open profile, if one records."""
    if _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF
