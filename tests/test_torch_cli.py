"""The port's CLI (`--device cpu`) against the compiled C reference's
outputs: all 9 MSE fixtures must give a byte-identical 5-frame stack and the
same `PSNR: %.6f`, `Output file dimensions` and rounded `PSNR` lines as the
fixture's stdout.txt; the 4 SSIM fixtures (`--metric ssim`) the same stack
and `Original Score` / `Compensated Score` line, and no `PSNR` line. Path
lines and the `Computation time` value differ by nature and are not
compared.
"""
import os

import numpy as np
import pytest
import torch

from conftest import FixtureCase, mse_cases, ssim_cases
from motionestimation_tpu_torch import cli

# The tests run in several worker processes on shared cores; one torch
# thread per worker keeps them from oversubscribing the machine.
torch.set_num_threads(1)


def _frame_paths(case: FixtureCase, tmp_path):
    """The fixture's own cur/ref files, or Foreman's F4/F1 written from
    planes 1 and 0 of its stacked output."""
    cur = os.path.join(case.dir, case.meta["cur"])
    ref = os.path.join(case.dir, case.meta["ref"])
    if os.path.exists(cur) and os.path.exists(ref):
        return cur, ref
    stack = case.golden_stack
    stack[1].tofile(tmp_path / "cur.yuv")
    stack[0].tofile(tmp_path / "ref.yuv")
    return str(tmp_path / "cur.yuv"), str(tmp_path / "ref.yuv")


def _compared_lines(stdout: str):
    return [
        line for line in stdout.splitlines()
        if line.startswith(("PSNR:", "Original Score:",
                            "Output file dimensions", "  BlkDim",
                            "  ExtraSpan", "  FrameWidth", "  FrameHeight"))
    ]


@pytest.mark.parametrize("name", mse_cases())
def test_cli_cpu_byte_exact(name, tmp_path, capsys):
    case = FixtureCase(name)
    cur, ref = _frame_paths(case, tmp_path)
    out = tmp_path / "out"
    rc = cli.main([
        cur, ref, str(out), str(case.blk_dim), str(case.span),
        str(case.width), str(case.height), "--device", "cpu", "--timing-row",
    ])
    assert rc == 0
    stdout = capsys.readouterr().out
    assert _compared_lines(stdout) == _compared_lines(case.stdout)
    assert any(line.startswith("Computation time: ") for line in stdout.splitlines())
    timing = stdout.splitlines()[-1].split()
    assert len(timing) == 5 and timing[-1] == "%.4f" % case.golden_psnr()
    got = np.fromfile(out / f"output_{case.blk_dim}_{case.span}.yuv", np.uint8)
    assert got.tobytes() == case.golden_stack.tobytes()


@pytest.mark.parametrize("name", ssim_cases())
def test_cli_cpu_ssim_byte_exact(name, tmp_path, capsys):
    case = FixtureCase(name)
    cur, ref = _frame_paths(case, tmp_path)
    out = tmp_path / "out"
    rc = cli.main([
        cur, ref, str(out), str(case.blk_dim), str(case.span),
        str(case.width), str(case.height), "--device", "cpu",
        "--metric", "ssim",
    ])
    assert rc == 0
    stdout = capsys.readouterr().out
    assert _compared_lines(stdout) == _compared_lines(case.stdout)
    assert any(line.startswith("Original Score: ") for line in stdout.splitlines())
    assert not any(line.startswith(("PSNR", "Computation time"))
                   for line in stdout.splitlines())
    got = np.fromfile(out / f"output_{case.blk_dim}_{case.span}.yuv", np.uint8)
    assert got.tobytes() == case.golden_stack.tobytes()


@pytest.mark.parametrize(
    "extra,match",
    [
        pytest.param(["--algorithm", "diamond"], "diamond", id="extra1-diamond"),
        pytest.param(["--gop", "a.yuv", "b.yuv"], "GOP", id="extra2-GOP"),
        pytest.param(["--debug-block", "0", "0"], "cost volume",
                     id="extra3-cost volume"),
        pytest.param(["--profile", "trace"], "bench", id="extra4-bench"),
    ],
)
def test_cli_later_slices_raise(extra, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(["c.yuv", "r.yuv", str(tmp_path), "--device", "cpu", *extra])
