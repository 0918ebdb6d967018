"""The benchmark's harness: one run of one cell.

    python3 -m benchmark --workload NAME --seed N --seconds S --trace 0|1

Everything a cell needs is found by name, starting from BENCHMARK.json at
the root of the checkout:

* the cell (`workloads`) names its configuration and its traffic mix;
* the configuration (`configs`) names its file, under `configs/`, which
  gives the frame and search sizes, the program's entry and its arguments;
* the mix is `mixes/<traffic>.json`, which names its driver,
  `drivers/<driver>.py`, and holds the driver's parameters;
* each per-layer metric is read by `metrics/<name>.py`, whose `read(run)`
  returns a number or None (nothing to read: the metric is left out).

With `--trace 0` the result's metrics are the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics, read from a profiled part of the
window. The last line of standard output is one JSON object; the numbers
compared with the reference stand beside their limits as the last lines of
standard error and under the result's last key, "checks".
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
SPEC = HERE.parent / "BENCHMARK.json"
# Top-level module names the process printing a result may not hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "motionestimation_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list
    home: Path = HERE   # the benchmark's folder: mixes/, metrics/


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _by_name(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in {SPEC.name}")


def load_cell(name: str, spec_path: Path = SPEC) -> Cell:
    """The cell `name` of BENCHMARK.json, its configuration and mix read."""
    spec = json.loads(Path(spec_path).read_text())
    root = Path(spec_path).resolve().parent
    home = root / HERE.name
    wl = _by_name(spec["workloads"], name, "workload")
    conf = _by_name(spec["configs"], wl["config"], "configuration")
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((home / "mixes" / f"{wl['traffic']}.json").read_text())
    return Cell(name=name, chips=wl["chips"], config=config, mix=mix,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
                home=home)


def driver(name: str):
    """The driver module `drivers/<name>.py`."""
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str, home: Path = HERE):
    """`read` of the per-layer metric file `metrics/<name>.py`."""
    path = home / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class RunRecord:
    """What a per-layer metric reads: the cell and the driver's outcome."""
    cell: Cell
    outcome: object

    @property
    def trace(self):
        return self.outcome.trace

    @property
    def counters(self) -> dict:
        return self.outcome.counters


def forbidden_modules() -> list[str]:
    """The FORBIDDEN top-level names held in sys.modules, compared whole."""
    held = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(held.intersection(FORBIDDEN))


def result(cell: Cell, out, trace: bool, device: dict) -> dict:
    """The result line's object."""
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    record = RunRecord(cell, out)
    for m in wanted:
        value = (metric_reader(m["name"], cell.home)(record) if trace
                 else out.values.get(m["name"]))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device, memory_peak_bytes=out.memory_peak_bytes)
    line = {"correct": all(c.ok for c in out.checks),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=out.busy_s, window_s=out.window_s)
        if out.trace is not None:
            line["breakdown"] = {"device_ops": out.trace.top_device_ops(),
                                 "idle_gaps": out.trace.idle_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line


def execute(cell: Cell, *, seed: int, seconds: float, trace: bool,
            started: float, device_info: dict, device=None, entry=None):
    """Drive the cell and build its result: (exit code, result or None).
    The modules held are looked at once the result, the per-layer metrics'
    readers included, is built. `device`/`entry` stand in for the card and
    the program in tests."""
    out = driver(cell.mix["driver"]).run(
        cell, seed=seed, seconds=seconds, trace=trace, started=started,
        device=device, entry=entry)
    line = result(cell, out, trace, device_info)
    held = forbidden_modules()
    if held:
        print(f"modules the benchmark may not load were loaded: "
              f"{', '.join(held)}", file=sys.stderr)
        return 3, None
    return 0, line


def main(argv=None, started: float | None = None) -> int:
    started = time.perf_counter() if started is None else started
    p = argparse.ArgumentParser(description="One run of a benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); {have} "
              f"available", file=sys.stderr)
        return 2
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips}
    code, line = execute(cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), started=started,
                         device_info=info)
    if line is None:
        return code
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return code
