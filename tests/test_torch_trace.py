"""The program's spans (`core.trace`) on the CPU: a shared null context and
no `record_function` with no profiler recording; under `torch.profiler`
the frame searches' `me.search` around `me.operands`, `me.edges` and
`me.decode`, read back through the benchmark's trace reader; the fields
unchanged by the profiler; `_build.load`'s seconds and span."""
import contextlib

import numpy as np
import pytest
import torch

from benchmark.yardstick.trace import WINDOW, Trace
from motionestimation_tpu_torch.core import trace
from motionestimation_tpu_torch.kernels import _build
from motionestimation_tpu_torch.kernels import full_search_cuda as fsc
from motionestimation_tpu_torch.kernels import ssim_cuda

H, W, BLK, SPAN = 40, 54, 7, 3   # 40 % 7 and 54 % 7: truncated blocks
# SAD at blk 7 has no interior kernel: the int kernel takes the whole
# frame, with no edge slabs to merge.
INNER = {"mse": ("me.operands", "me.edges", "me.decode"),
         "sad": ("me.operands", "me.decode"),
         "ssim": ("me.operands", "me.edges", "me.decode")}


def _frames(seed=3):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (H, W), dtype=np.uint8)
    cur = np.roll(ref, (1, -2), (0, 1))
    return torch.from_numpy(cur), torch.from_numpy(ref)


SEARCHES = {
    "mse": lambda cur, ref: fsc.full_search_frame_cuda(
        cur, ref, blk_dim=BLK, span=SPAN, metric="mse", device="cpu"),
    "sad": lambda cur, ref: fsc.full_search_frame_cuda(
        cur, ref, blk_dim=BLK, span=SPAN, metric="sad", device="cpu"),
    "ssim": lambda cur, ref: ssim_cuda.ssim_search_frame_cuda(
        cur, ref, blk_dim=BLK, span=SPAN, device="cpu"),
}


def _profiled(fn, calls=1):
    """[results], Trace of `calls` calls of `fn` under a CPU profile."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = [fn() for _ in range(calls)]
    return out, Trace.record(prof)


def _fields_equal(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("mv_y", "mv_x")) and torch.equal(
        a.best_cost_i32.view(torch.int32), b.best_cost_i32.view(torch.int32)
    ) and torch.equal(a.score.view(torch.int32), b.score.view(torch.int32))


def test_no_profiler_gives_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = trace.span("me.search"), trace.span("me.launch")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:   # nests, and shares no state
        pass


def _count_records(monkeypatch):
    """[names] of every span entered, through `record_function` or the
    user-scope binding it wraps."""
    entered = []
    enter = torch._C._autograd._record_function_with_args_enter

    def counted(name, *args):
        entered.append(name)
        return enter(name, *args)

    def record(name, args=None):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch._C._autograd,
                        "_record_function_with_args_enter", counted)
    monkeypatch.setattr(torch.profiler, "record_function", record)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", record)
    return entered


@pytest.mark.parametrize("metric", sorted(SEARCHES))
def test_no_record_function_without_a_profiler(metric, monkeypatch):
    entered = _count_records(monkeypatch)
    cur, ref = _frames()
    SEARCHES[metric](cur, ref)
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        SEARCHES[metric](cur, ref)
    assert entered.count("me.search") == 1


def test_span_records_under_the_profiler():
    def step():
        with trace.span("me.test"):
            return torch.zeros(3).sum()

    def fails():
        with trace.span("me.fails"):
            raise KeyError("inside")

    def caught():
        with pytest.raises(KeyError):
            fails()

    _, tr = _profiled(step, calls=2)
    assert len(tr.spans("me.test")) == 2
    _, tr = _profiled(caught)
    assert len(tr.spans("me.fails")) == 1   # ended by the exception
    assert not torch.autograd.profiler._is_profiler_enabled


def _inside(inner, outer):
    a, b, tid = inner
    return any(s <= a and b <= e and t == tid for s, e, t in outer)


@pytest.mark.parametrize("metric", sorted(SEARCHES))
def test_search_spans_nest(metric):
    cur, ref = _frames()
    _, tr = _profiled(lambda: SEARCHES[metric](cur, ref), calls=2)
    calls = tr.spans("me.search")
    assert len(calls) == 2
    for name in INNER[metric]:
        spans = tr.spans(name)
        assert len(spans) == 2, name
        assert all(_inside(s, calls) for s in spans), name
    for a, b, tid in calls:   # in order inside each call
        starts = [next(s for s, e, t in tr.spans(n) if a <= s <= b)
                  for n in INNER[metric]]
        assert starts == sorted(starts)
    # The plain versions launch nothing on the card.
    assert tr.spans("me.launch") == []
    if "me.edges" not in INNER[metric]:
        assert tr.spans("me.edges") == []


def test_no_edges_span_on_whole_blocks():
    cur, ref = (t[:35, :49] for t in _frames())   # 35 = 5 * 7, 49 = 7 * 7
    _, tr = _profiled(lambda: fsc.full_search_frame_cuda(
        cur, ref, blk_dim=BLK, span=SPAN, device="cpu"))
    assert len(tr.spans("me.search")) == 1
    assert tr.spans("me.edges") == []
    assert len(tr.spans("me.decode")) == 1


@pytest.mark.parametrize("metric", sorted(SEARCHES))
def test_fields_bit_identical_under_the_profiler(metric):
    cur, ref = _frames(seed=11)
    plain = SEARCHES[metric](cur, ref)
    (traced,), _ = _profiled(lambda: SEARCHES[metric](cur, ref))
    assert _fields_equal(plain, traced)


def test_kernel_load_counts_the_open_only(tmp_path, monkeypatch):
    lib = tmp_path / "libfake.so"
    lib.write_bytes(b"")
    opened = []
    monkeypatch.setattr(_build, "library_path", lambda name: lib)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: opened.append(path) or object())
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "load_s", 0.0)
    (first,), tr = _profiled(lambda: _build.load("fake"))
    after = _build.load_s
    assert opened == [str(lib)] and after > 0
    assert len(tr.spans("me.kernel_load")) == 1
    (again,), tr = _profiled(lambda: _build.load("fake"))
    assert again is first and opened == [str(lib)]
    assert _build.load_s == after
    assert tr.spans("me.kernel_load") == []
