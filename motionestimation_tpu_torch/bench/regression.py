"""Version-over-version benchmark regression harness.

The port's own copy of `motionestimation_tpu.bench.regression` (pure
Python; nothing is imported from there). It replicates the reference's
only automated test (its src/gpu/run.sh:66-96): each benchmark run writes
one machine-parsable row per sequence —

    total h2d kernel d2h psnr        (ms, ms, ms, ms, dB; main_mse.cu:255)

— to `v{N}.txt` under a results directory, and version N is compared
against version N-1 with the reference's epsilons: any timing column worse
by more than 0.1 ms, or PSNR lower by more than 0.5 dB, is flagged as a
regression (run.sh:79-80,89-92).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

TIMING_EPSILON_MS = 0.1  # run.sh:79
PSNR_EPSILON_DB = 0.5  # run.sh:80
COLUMNS = ("totalTime", "h2d", "kernel", "d2h", "PSNR")  # run.sh:77


@dataclasses.dataclass(frozen=True)
class Regression:
    sequence: str
    column: str
    current: float
    previous: float

    def __str__(self):
        return (
            f"Worse for {self.column}\tcurrent: {self.current}\t"
            f"previous: {self.previous}\t({self.sequence})"
        )


def results_path(results_dir: str | os.PathLike, version: int) -> str:
    return os.path.join(os.fspath(results_dir), f"v{version}.txt")


def write_results(
    results_dir: str | os.PathLike,
    version: int,
    header: str,
    rows: Sequence[tuple[str, Sequence[float]]],
) -> str:
    """Write `v{version}.txt`: header line, blank line, one 5-column row
    per (sequence, values) in order — the reference's file layout
    (run.sh:48, printf at main_mse.cu:255)."""
    os.makedirs(results_dir, exist_ok=True)
    path = results_path(results_dir, version)
    with open(path, "w") as f:
        f.write(header + "\n\n")
        for _, vals in rows:
            f.write(" ".join(f"{v:.6f}" for v in vals) + "\n")
    return path


def read_rows(
    results_dir: str | os.PathLike, version: int, n: int
) -> list[list[float]]:
    """Last n rows of v{version}.txt (tail -n3 analogue, run.sh:96)."""
    with open(results_path(results_dir, version)) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    rows = [ln for ln in lines if not ln.startswith("[")]
    return [[float(t) for t in ln.split()] for ln in rows[-n:]]


def compare_rows(
    sequences: Sequence[str],
    current: Sequence[Sequence[float]],
    previous: Sequence[Sequence[float]],
) -> list[Regression]:
    """Reference epsilon comparison: timings (cols 0-3) regress when
    current > previous + 0.1 ms; PSNR (col 4) regresses when
    current < previous - 0.5 dB (run.sh:89-92)."""
    found = []
    for seq, cur, prev in zip(sequences, current, previous):
        for i, col in enumerate(COLUMNS):
            if i <= 3 and cur[i] > prev[i] + TIMING_EPSILON_MS:
                found.append(Regression(seq, col, cur[i], prev[i]))
            elif i == 4 and cur[i] < prev[i] - PSNR_EPSILON_DB:
                found.append(Regression(seq, col, cur[i], prev[i]))
    return found


def compare_versions(
    results_dir: str | os.PathLike,
    version: int,
    sequences: Sequence[str],
) -> list[Regression]:
    """Compare v{version} against v{version-1}; empty when version == 1
    or the previous file is missing (run.sh:68-73)."""
    if version <= 1:
        return []
    prev_path = results_path(results_dir, version - 1)
    if not os.path.exists(prev_path):
        return []
    n = len(sequences)
    return compare_rows(
        sequences,
        read_rows(results_dir, version, n),
        read_rows(results_dir, version - 1, n),
    )
