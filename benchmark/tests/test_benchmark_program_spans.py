"""The readers of the program's spans (`me.search`, `me.launch`, ...) and
of its kernel-load counter, on a made-up trace: two search calls, one
with its launch inside `me.edges`, glue operations beside the launches,
and an operation launched outside any search."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.yardstick.trace import WINDOW, Trace

READERS = ("search.glue_host_ms", "search.glue_device_ops",
           "search.glue_device_ms", "kernels.launch_host_ms")
BUILD = "motionestimation_tpu_torch.kernels._build"


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def _span(name, ts, dur):
    return _ev(name, "user_annotation", ts, dur)


def _launch(ts, corr):
    return _ev("cudaLaunchKernel", "cuda_runtime", ts, 1, correlation=corr)


def _events(program=True):
    """Times in us. Call 1 (105..295): a pad launched in `me.operands`, K1
    in `me.launch` (140..170) inside `me.edges`, two decode operations
    and an `aten::clamp` on the host in `me.decode`. Call 2 (405..595): a
    copy, then K1 in `me.launch` (450..470). Then a pack outside."""
    spans = [
        _span(WINDOW, 0, 1000),
        _span("search", 100, 200),
        _span("me.search", 105, 190),
        _span("me.operands", 110, 20),
        _span("me.edges", 135, 50),
        _span("me.launch", 140, 30),
        _span("me.decode", 200, 90),
        _span("search", 400, 200),
        _span("me.search", 405, 190),
        _span("me.launch", 450, 20),
        _span("pack", 690, 20),
    ]
    if not program:
        spans = [s for s in spans if not s["name"].startswith("me.")]
    return spans + [
        _launch(115, 1), _launch(150, 2), _launch(210, 3), _launch(220, 4),
        _ev("aten::clamp", "cpu_op", 230, 40),
        _launch(420, 5), _launch(455, 6), _launch(700, 7),
        _ev("pad", "kernel", 200, 10, correlation=1),
        _ev("k1", "kernel", 210, 390, correlation=2),
        _ev("decode", "kernel", 600, 5, correlation=3),
        _ev("memset", "gpu_memset", 605, 2, correlation=4),
        _ev("copy", "gpu_memcpy", 620, 10, correlation=5),
        _ev("k1", "kernel", 630, 270, correlation=6),
        _ev("pack", "kernel", 900, 10, correlation=7),
    ]


def _record(events):
    return SimpleNamespace(trace=None if events is None else Trace(events),
                           counters={}, cell=None)


def _read(name, record):
    return run.metric_reader(name)(record)


def test_each_reader_on_the_made_up_trace():
    rec = _record(_events())
    # Glue: call 1's 190 us less its launch's 30, call 2's 190 less 20.
    assert _read("search.glue_host_ms", rec) == pytest.approx(0.165)
    # pad, decode, memset (call 1) and copy (call 2): 4 over 2 calls.
    assert _read("search.glue_device_ops", rec) == pytest.approx(2.0)
    # 10 + 5 + 2 + 10 us of card time over 2 calls.
    assert _read("search.glue_device_ms", rec) == pytest.approx(0.0135)
    # 30 + 20 us inside `me.launch` over 2 calls.
    assert _read("kernels.launch_host_ms", rec) == pytest.approx(0.025)


def test_glue_and_launched_operations_make_the_search_operations():
    rec = _record(_events())
    launched = len(rec.trace.launched_in("me.launch")) / len(
        rec.trace.spans("me.search"))
    total = _read("search.device_ops", rec)
    assert total == pytest.approx(3.0)
    assert _read("search.glue_device_ops", rec) + launched == total


def test_idle_gaps_are_named_by_the_program_span():
    gaps = dict(_record(_events()).trace.idle_gaps())
    # The card idles 0..200 us: its middle, 100, is in the harness's span
    # before `me.search` opens.
    assert gaps["search"] == pytest.approx(200e-6)
    tr = Trace([_span(WINDOW, 0, 100), _span("search", 0, 100),
                _span("me.search", 5, 90), _span("me.decode", 30, 50),
                _ev("aten::clamp", "cpu_op", 35, 20),
                _launch(60, 1), _ev("k", "kernel", 80, 20, correlation=1)])
    assert dict(tr.idle_gaps()) == {"me.decode: aten::clamp":
                                    pytest.approx(80e-6)}


def test_launches_outside_a_search_are_not_glue():
    events = _events() + [_span("me.launch", 695, 10)]
    rec = _record(events)
    assert _read("search.glue_device_ops", rec) == pytest.approx(2.0)
    assert _read("kernels.launch_host_ms", rec) == pytest.approx(0.025)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name):
    assert _read(name, _record(None)) is None
    assert _read(name, _record(_events(program=False))) is None
    unlaunched = [e for e in _events() if e["cat"] != "cuda_runtime"]
    if "device" in name:   # no card operation placed in a span
        assert _read(name, _record(unlaunched)) is None
    no_launch = [e for e in _events() if e["name"] != "me.launch"]
    if name == "kernels.launch_host_ms":
        assert _read(name, _record(no_launch)) is None


def test_kernel_load_seconds(monkeypatch):
    build = SimpleNamespace(load_s=2.5)
    monkeypatch.setitem(sys.modules, BUILD, build)
    assert _read("setup.kernel_load_s", _record(None)) == 2.5
    build.load_s = 0.0   # no library loaded
    assert _read("setup.kernel_load_s", _record(None)) is None
    del build.load_s     # a program with no counter
    assert _read("setup.kernel_load_s", _record(None)) is None
    monkeypatch.delitem(sys.modules, BUILD)
    assert _read("setup.kernel_load_s", _record(None)) is None
