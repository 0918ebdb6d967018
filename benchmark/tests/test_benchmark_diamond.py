"""The diamond cell on the CPU at a small size, its traced pairs' bound,
and the readers of the program's diamond spans and counters: the
program's plain versions come out correct, the control (the plain diamond
with int16 costs) and each fault a stream can have come out not correct,
and a run holds no JAX."""
from __future__ import annotations

import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import control_diamond, run
from benchmark.drivers import diamond_stream
from benchmark.tests.test_benchmark_program_spans import _ev, _launch, _span
from benchmark.tests.test_benchmark_runs import _stream_faults
from benchmark.yardstick import diamond, diamond_roofline, textured
from benchmark.yardstick.trace import WINDOW, Trace

ROOT = run.HERE.parent
CELL = "uhd-32x32-r31-diamond.adversarial"
DIAMOND = "motionestimation_tpu_torch.search.diamond"


def small(name: str = CELL):
    """The cell at a size a test can hold: 44x62 frames (blk 8 leaves a
    truncated block row and column), span 15 with a pan of (9, -10), past
    the first staged level's radius; a short pool and window."""
    cell = run.load_cell(name)
    cell.config.update(frame_height=44, frame_width=62, blk_dim=8, span=15)
    cell.config["entry_kwargs"].update(blk_dim=8, span=15)
    cell.mix.update(pool_frames=3, shift=[9, -10], warm_chunks=1,
                    sample_pairs=4, trace_skip_chunks=1, trace_chunks=1)
    return cell


def execute(cell, trace=False, entry=None, seconds=0.2):
    code, line = run.execute(cell, seed=2**31 + 11, seconds=seconds,
                             trace=trace, started=time.perf_counter(),
                             device_info={"platform": "cpu"}, device="cpu",
                             entry=entry)
    assert code == 0
    return line


@pytest.mark.parametrize("trace", [False, True])
def test_the_plain_versions_are_correct(trace):
    cell = small()
    line = execute(cell, trace)
    assert line["correct"] is True and line["failed"] == 0
    assert all(c["value"] == 0 == c["limit"] for c in line["checks"].values())
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if trace:
        # On the CPU the card readers find nothing; the program's counters
        # and host spans are there.
        assert line["metrics"]["diamond.levels_per_call"]["value"] == 2.0
        assert line["metrics"]["diamond.escape_wait_host_ms"]["value"] > 0
    else:
        assert set(line["metrics"]) == names


def test_control_is_not_correct():
    got = control_diamond.readings(small(), seed=3, seconds=0.2,
                                   device="cpu")
    assert got["blocks_differing"] > 0


@pytest.mark.parametrize("fault", sorted(_stream_faults()))
def test_stream_fault_is_not_correct(fault):
    cell = small()
    real = diamond_stream.load_entry(cell.config["entry"])
    line = execute(cell, entry=_stream_faults()[fault](real))
    assert line["correct"] is False
    assert line["checks"]["blocks_differing"]["value"] > 0


def test_traced_run_hands_over_the_traced_pairs_bound():
    """The bound handed over is the sum over the 8 traced pairs, 16 to 23
    (one warm-up chunk and one skipped chunk before them), of each pair's
    bound from the reference's trajectories."""
    cell = small()
    out = diamond_stream.run(cell, seed=5, seconds=0.1, trace=True,
                             started=time.perf_counter(), device="cpu")
    chunk = cell.mix["chunk_pairs"]
    cfg = cell.config
    h, w = cfg["frame_height"], cfg["frame_width"]
    pool = textured.gop_frames(5, 3, h, w, shift=(9, -10), noise=2,
                               texture=4)
    want = 0.0
    for p in range(2 * chunk, 3 * chunk):
        traj = diamond.diamond_search(pool[(p + 1) % 3], pool[p % 3], blk=8,
                                      span=15).trajectory.numpy()
        want += diamond_roofline.bound_ms(traj, span=15, blk_dim=8,
                                          frame_height=h, frame_width=w)
    assert out.counters["bound_pairs"] == chunk
    assert out.counters["bound_ms_traced"] == pytest.approx(want, rel=1e-12)


def test_textured_frames_pan():
    """Frame k + 1 is frame k moved by the shift, within the noise."""
    f = textured.gop_frames(2**31 + 3, 3, 40, 48, shift=(5, -6), noise=2,
                            texture=4)
    again = textured.gop_frames(2**31 + 3, 3, 40, 48, shift=(5, -6),
                                noise=2, texture=4)
    assert torch.equal(f, again)
    moved = torch.roll(f[1], (5, -6), (0, 1)).int()
    assert (f[2].int() - moved).abs().max() <= 2
    # Squares of 4: a texture, not pixel noise.
    grey = f[0].float()
    assert (grey[:, 0::4] - grey[:, 1::4]).abs().mean() < 4


def test_walk_evals_hand_count():
    """One 8x8 block at (0, 0) of a 24x24 frame, span 4, its walk (0, 0)
    -> (2, 0), then still. The block cannot move up or left. Round 0's
    LDSP around (0, 0): (0, 0), (0, 2), (1, 1), (2, 0) valid. Round 1's
    around (2, 0): (2, 2), (3, 1), (4, 0) new; (0, 0), (1, 1), (2, 0)
    known; (1, -1), (2, -2), (3, -1) invalid. The SDSP around (2, 0): (1,
    0), (2, 1), (3, 0) new; (2, -1) invalid. 4 + 3 + 3 = 10 distinct
    evaluations of 64 pixels, bound by the frames' bytes. In a frame of
    one block, nothing but (0, 0) is valid."""
    traj = np.zeros((3, 1, 1, 2), np.int32)
    traj[1:, 0, 0] = (2, 0)
    assert diamond_roofline.walk_evals(traj, span=4, blk_dim=8,
                                       frame_height=24,
                                       frame_width=24) == (10, 640)
    assert diamond_roofline.walk_evals(
        np.zeros((2, 1, 1, 2), np.int32), span=4, blk_dim=8,
        frame_height=8, frame_width=8) == (1, 64)
    assert diamond_roofline.bound_ms(
        traj, span=4, blk_dim=8, frame_height=24, frame_width=24
    ) == pytest.approx((2 * 24 * 24 + 12) / 3.35e12 * 1e3)


def _events(program=True):
    """Times in us. One search call (100..300): `me.search` 105..295, a
    level 110..150 launching a volume kernel (card 200..260) and a replay
    (260..270), an escape wait 150..170, a level 170..200 launching a
    kernel (card 300..340); a pack outside (card 400..410)."""
    spans = [_span(WINDOW, 0, 1000), _span("search", 100, 200),
             _span("me.search", 105, 190), _span("me.level", 110, 40),
             _span("me.escape_wait", 150, 20), _span("me.level", 170, 30),
             _span("pack", 390, 10)]
    if not program:
        spans = [s for s in spans if not s["name"].startswith("me.")]
    return spans + [
        _launch(115, 1), _launch(120, 2), _launch(175, 3), _launch(395, 4),
        _ev("volume", "kernel", 200, 60, correlation=1),
        _ev("replay", "kernel", 260, 10, correlation=2),
        _ev("volume", "kernel", 300, 40, correlation=3),
        _ev("pack", "kernel", 400, 10, correlation=4),
    ]


def _record(events, counters=None):
    return SimpleNamespace(trace=None if events is None else Trace(events),
                           counters=counters or {}, cell=None)


def test_readers_on_a_made_up_trace():
    rec = _record(_events(), {"bound_ms_traced": 0.011, "bound_pairs": 1})
    read = {n: run.metric_reader(n) for n in (
        "diamond.escape_wait_host_ms", "diamond.level_device_ms",
        "kernels.diamond_roofline_pct")}
    assert read["diamond.escape_wait_host_ms"](rec) == pytest.approx(0.020)
    assert read["diamond.level_device_ms"](rec) == pytest.approx(0.110)
    # 0.011 ms over the 110 us of kernels launched in the search span.
    assert read["kernels.diamond_roofline_pct"](rec) == pytest.approx(10.0)
    for name, reader in read.items():   # the parent: no spans, no bound
        assert reader(_record(None)) is None, name
        assert reader(_record(_events(program=False))) is None, name
    assert read["kernels.diamond_roofline_pct"](_record(_events())) is None


def test_levels_per_call_reads_the_program_counters(monkeypatch):
    reader = run.metric_reader("diamond.levels_per_call")
    fake = SimpleNamespace(
        diamond_search_frame=SimpleNamespace(calls=4),
        _diamond_staged=SimpleNamespace(levels=12))
    monkeypatch.setitem(sys.modules, DIAMOND, fake)
    assert reader(_record(None)) == 3.0
    fake.diamond_search_frame.calls = 0
    assert reader(_record(None)) is None
    # The parent: no counters.
    monkeypatch.setitem(sys.modules, DIAMOND, SimpleNamespace(
        diamond_search_frame=lambda: None, _diamond_staged=lambda: None))
    assert reader(_record(None)) is None


def test_a_diamond_run_holds_no_forbidden_module():
    """The diamond driver, its control and a traced run of the cell, with
    its readers, in a fresh process: no jax, jaxlib, flax or
    motionestimation_tpu in sys.modules."""
    code = (
        "import time\n"
        "import benchmark.control_diamond\n"
        "from benchmark import run\n"
        "from benchmark.tests.test_benchmark_diamond import small\n"
        "cell = small()\n"
        "code, line = run.execute(cell, seed=1, seconds=0.1, trace=True,\n"
        "    started=time.perf_counter(), device_info={}, device='cpu')\n"
        "assert code == 0 and line['correct']\n"
        "for name in [m['name'] for m in cell.per_layer]:\n"
        "    run.metric_reader(name)\n"
        "print(run.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
