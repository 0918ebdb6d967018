"""BENCHMARK.json against the benchmark's contract, every file it names
found by name, and a cell added as new files and entries alone."""
from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path

from benchmark import run

SPEC = json.loads(run.SPEC.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_names_and_units():
    assert set(SPEC) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [item["name"] for item in SPEC[part]]
        assert len(names) == len(set(names))
        for item in SPEC[part]:
            assert set(item) - {"workloads"} == KEYS[part], item["name"]
            assert NAME.match(item["name"]), item["name"]
            if "unit" in item:
                assert UNIT.match(item["unit"])
                assert item["better"] in ("lower", "higher")
    for text in ([c["source"] for c in SPEC["configs"]]
                 + [c["why"] for c in SPEC["configs"] + SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(run.SPEC.read_bytes()) <= 64 * 1024


def test_metrics_cover_every_cell():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        for cell in m.get("workloads", cells):
            assert run._applies(e2e[m["moves"]], cell)
    for cell in cells:
        mine = [m["name"] for m in SPEC["end_to_end"] if run._applies(m, cell)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(run._applies(m, cell) for m in SPEC["per_layer"])


def test_cells_and_run_length():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    assert {w["config"] for w in SPEC["workloads"]} == configs
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    # A full check with the most cells later PRs may add fits its time.
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_file_found_by_name():
    for w in SPEC["workloads"]:
        cell = run.load_cell(w["name"])
        assert cell.chips == w["chips"] == cell.config["chips"]
        assert run.driver(cell.mix["driver"]).run
        for m in cell.per_layer:
            assert callable(run.metric_reader(m["name"]))
    for c in SPEC["configs"]:
        path = run.SPEC.parent / c["file"]
        assert path.is_relative_to(run.HERE)
        config = json.loads(path.read_text())
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert config["reduced"] == c["reduced"] == []


def test_command_and_paths():
    assert SPEC["paths"] == [run.HERE.name]
    assert SPEC["command"][:3] == ["python3", "-m", run.HERE.name]


def test_new_cell_from_new_files_alone(tmp_path):
    """A configuration, a mix, a metric and a cell added as files and
    entries, no file edited: the copy finds and runs them."""
    home = tmp_path / run.HERE.name
    shutil.copytree(run.HERE, home, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads(run.SPEC.read_text())
    config = json.loads((run.HERE / "configs" / "uhd-8x8-r31-mse.json")
                        .read_text())
    config.update(name="tiny-8x8-r3-sad", frame_height=40, frame_width=56,
                  span=3, metric="sad",
                  entry_kwargs={"blk_dim": 8, "span": 3, "metric": "sad"})
    (home / "configs" / "tiny-8x8-r3-sad.json").write_text(json.dumps(config))
    mix = json.loads((run.HERE / "mixes" / "stream8.json").read_text())
    mix.update(pool_frames=4, chunk_pairs=2, warm_chunks=1, sample_pairs=3,
               trace_skip_chunks=1, trace_chunks=1)
    (home / "mixes" / "stream2.json").write_text(json.dumps(mix))
    (home / "metrics" / "search.calls.py").write_text(
        "def read(run):\n    return run.counters.get('search_calls')\n")
    spec["configs"].append({"name": "tiny-8x8-r3-sad", "source": "a test",
                            "file": "benchmark/configs/tiny-8x8-r3-sad.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny.stream2",
                              "config": "tiny-8x8-r3-sad",
                              "traffic": "stream2", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"][:2]:
        m["workloads"].append("tiny.stream2")
    spec["per_layer"].append({"name": "search.calls", "unit": "calls",
                              "better": "lower", "source": "host_clock",
                              "layer": "frame search", "moves": "pairs_per_s",
                              "workloads": ["tiny.stream2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = run.load_cell("tiny.stream2", tmp_path / "BENCHMARK.json")
    assert cell.mix["chunk_pairs"] == 2 and cell.config["metric"] == "sad"
    code, line = run.execute(cell, seed=7, seconds=0.2, trace=True,
                             started=time.perf_counter(),
                             device_info={"platform": "cpu"}, device="cpu")
    assert code == 0 and line["correct"]
    assert line["metrics"]["search.calls"]["value"] >= 1
    code, line = run.execute(cell, seed=7, seconds=0.2, trace=False,
                             started=time.perf_counter(),
                             device_info={"platform": "cpu"}, device="cpu")
    assert set(line["metrics"]) == {"pairs_per_s", "pair_ms_p95", "setup_s"}


def test_file_names():
    """Every file of the benchmark is named from a name's characters and
    "/"."""
    for path in Path(run.HERE).rglob("*"):
        if "__pycache__" not in path.parts:
            rel = str(path.relative_to(run.HERE.parent))
            assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", rel), rel
