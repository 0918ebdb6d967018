"""Whole runs on the CPU at small sizes, the card's look skipped: the
result line's keys, the program's plain versions coming out correct, the
control and each fault the cells can have coming out not correct, and the
modules a run holds."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import control, run

ROOT = run.HERE.parent
STREAMS = ["uhd-8x8-r31-mse.stream8", "uhd-7x7-r15-ssim.stream8"]


def small(name: str):
    """The cell at a size a test can hold: 44x56 frames (blk 8 leaves a
    truncated block row), a short pool and window."""
    cell = run.load_cell(name)
    cell.config.update(frame_height=44, frame_width=56, blk_dim=8, span=3)
    cell.config["entry_kwargs"].update(blk_dim=8, span=3)
    cell.mix.update(pool_frames=4, warm_chunks=1, sample_pairs=6,
                    trace_skip_chunks=1, trace_chunks=1)
    return cell


def execute(cell, trace=False, entry=None, seconds=0.3):
    code, line = run.execute(cell, seed=2**31 + 9, seconds=seconds,
                             trace=trace, started=time.perf_counter(),
                             device_info={"platform": "cpu"}, device="cpu",
                             entry=entry)
    assert code == 0
    return line


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(name, trace):
    cell = small(name)
    line = execute(cell, trace)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert all(c["value"] == 0 == c["limit"] for c in line["checks"].values())
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in wanted}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert keys[5] == "breakdown"
    else:
        assert set(line["metrics"]) == {m["name"] for m in wanted}
    json.dumps(line)


@pytest.mark.parametrize("name", STREAMS)
def test_control_is_not_correct(name):
    cell = small(name)
    got = control.readings(cell, seed=3, seconds=0.3, device="cpu")
    assert got["blocks_differing"] > 0


def _stream_faults():
    def unchanged(entry):
        first = []

        def f(cur, ref, **kw):
            first.append(first[0] if first else entry(cur, ref, **kw))
            return first[-1]
        return f

    def half_left_out(entry):
        last = []

        def f(cur, ref, **kw):
            last.append(entry(cur, ref, **kw) if len(last) % 2 == 0
                        else last[-1])
            return last[-1]
        return f

    def altered(entry):
        def f(cur, ref, **kw):
            out = entry(cur, ref, **kw)
            mv_x = out.mv_x.clone()
            mv_x[0, 0] += 1
            return out._replace(mv_x=mv_x)
        return f

    return {"unchanged": unchanged, "half_left_out": half_left_out,
            "altered": altered}


@pytest.mark.parametrize("fault", sorted(_stream_faults()))
@pytest.mark.parametrize("name", STREAMS)
def test_stream_fault_is_not_correct(name, fault):
    cell = small(name)
    real = run.driver("stream").load_entry(cell.config["entry"])
    line = execute(cell, entry=_stream_faults()[fault](real))
    assert line["correct"] is False
    assert line["checks"]["blocks_differing"]["value"] > 0


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("motionestimation_tpu_torch.x", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "motionestimation_tpu", sys)
    assert run.forbidden_modules() == ["jax", "motionestimation_tpu"]


def test_a_metric_that_loads_jax_leaves_no_result(tmp_path, monkeypatch,
                                                  capsys):
    """A per-layer metric's reader is loaded while the result is built; one
    that imports a module named jax (a stub here) leaves a traced run with
    no result."""
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    home = tmp_path / "home"
    shutil.copytree(run.HERE / "metrics", home / "metrics")
    (home / "metrics" / "loads_jax.py").write_text(
        "import jax\n\n\ndef read(run):\n    return 1.0\n")
    cell = small(STREAMS[0])
    cell.home = home
    cell.per_layer.append({"name": "loads_jax", "unit": "%"})
    for name in [k for k in sys.modules if k.partition(".")[0] == "jax"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    try:
        code, line = run.execute(cell, seed=5, seconds=0.2, trace=True,
                                 started=time.perf_counter(),
                                 device_info={"platform": "cpu"},
                                 device="cpu")
    finally:
        for name in [k for k in sys.modules
                     if k.partition(".")[0] == "jax"]:
            del sys.modules[name]
    assert code != 0 and line is None
    assert "jax" in capsys.readouterr().err


def test_traced_chunks_are_read_back_inside_the_profile(monkeypatch):
    """The profile holds the chunks dispatched while it is open, every one
    of them read back before it closes, none dispatched behind the last."""
    from benchmark.drivers import stream

    events = []

    class Loop:
        cuda, timing, pairs = False, False, 0

        def dispatch(self):
            self.pairs += 1
            events.append(("dispatch", self.pairs))
            return self.pairs

        def finish(self, chunk, latencies=None, sample=None):
            events.append(("finish", chunk))
            return time.perf_counter()

    class Profile:
        def __enter__(self):
            events.append(("open",))

        def __exit__(self, *exc):
            events.append(("close",))

    monkeypatch.setattr(stream, "_profiler", lambda cuda: Profile())
    monkeypatch.setattr(stream.Trace, "record",
                        classmethod(lambda cls, prof: "trace"))
    *_, pairs, trace = stream.window(Loop(), 0.0, None, (3, 4))
    assert trace == "trace"
    inside = events[events.index(("open",)) + 1:events.index(("close",))]
    dispatched = [c for what, c in inside if what == "dispatch"]
    finished = [c for what, c in inside if what == "finish"]
    assert dispatched == [4, 5, 6, 7]
    assert set(dispatched) <= set(finished) and finished[-1] == 7
    assert pairs == 7 and events[-1] == ("close",)


def test_a_run_holds_no_forbidden_module():
    """Every module of the harness, the drivers and the control imported
    and a traced cell run in a fresh process: no jax, jaxlib, flax or
    motionestimation_tpu in sys.modules."""
    code = (
        "import importlib, pkgutil, sys, time, benchmark, benchmark.drivers\n"
        "import benchmark.yardstick, benchmark.control\n"
        "for p in (benchmark, benchmark.drivers, benchmark.yardstick):\n"
        "    for m in pkgutil.iter_modules(p.__path__):\n"
        "        if m.name not in ('tests', '__main__'):\n"
        "            importlib.import_module(p.__name__ + '.' + m.name)\n"
        "from benchmark import run\n"
        "from benchmark.tests.test_benchmark_runs import small\n"
        "cell = small('uhd-8x8-r31-mse.stream8')\n"
        "run.execute(cell, seed=1, seconds=0.2, trace=True,\n"
        "            started=time.perf_counter(), device_info={},\n"
        "            device='cpu')\n"
        "for name in [m['name'] for m in cell.per_layer]:\n"
        "    run.metric_reader(name)\n"
        "print(run.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without CUDA a run exits with another code than 0 and prints
    nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark", "--workload",
                          STREAMS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
