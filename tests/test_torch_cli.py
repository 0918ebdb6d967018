"""The port's CLI (`--device cpu`) against the compiled C reference's
outputs: all 9 MSE fixtures must give a byte-identical 5-frame stack and the
same `PSNR: %.6f`, `Output file dimensions` and rounded `PSNR` lines as the
fixture's stdout.txt; the 4 SSIM fixtures (`--metric ssim`) the same stack
and `Original Score` / `Compensated Score` line, and no `PSNR` line. Path
lines and the `Computation time` value differ by nature and are not
compared. `--debug-block` must print the JAX CLI's `[debug]` lines, and the
routes through the chunked and wide kernels (7x7, 24x24) its stack.
`--algorithm diamond --early-term 40` on Foreman 16x16 +-7 must write the
stack and `PSNR:` line of a host rebuild from JAX `diamond_search_np`, and
diamond with `--escape-policy crossover` or `--metric ssim` the JAX CLI's
stack and score lines.
"""
import os

import numpy as np
import pytest
import torch

from conftest import FixtureCase, mse_cases, ssim_cases
from motionestimation_tpu import cli as jax_cli
from motionestimation_tpu.core import frames as jax_frames
from motionestimation_tpu.search import diamond as jax_diamond
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
        pytest.param(["--gop", "a.yuv", "b.yuv"], '"GOP pipeline"',
                     id="extra2-GOP"),
        pytest.param(["--profile", "trace"], '"Main-path bench and tracing"',
                     id="extra4-bench"),
    ],
)
def test_cli_later_slices_raise(extra, match, tmp_path):
    """The message names a ROADMAP.md Queue 1 item by its title, and that
    title is there."""
    with pytest.raises(NotImplementedError, match=match):
        cli.main(["c.yuv", "r.yuv", str(tmp_path), "--device", "cpu", *extra])
    roadmap = os.path.join(os.path.dirname(__file__), os.pardir, "ROADMAP.md")
    with open(roadmap, encoding="utf-8") as f:
        assert "**" + match.strip('"') in f.read()


def _debug_lines(stdout: str):
    return [line for line in stdout.splitlines() if line.startswith("[debug]")]


@pytest.mark.parametrize(
    "name,metric,by,bx",
    [("foreman_mse_8_12", "mse", 0, 3), ("foreman_ssim_16_7", "ssim", 2, 5)],
)
def test_cli_debug_block_matches_jax(name, metric, by, bx, tmp_path, capsys):
    """`--debug-block` (once a raise naming the cost volume) prints the JAX
    CLI's `[debug]` lines on Foreman: the probe block's cost surface, with
    its sentinels where the window leaves the frame, and the winner."""
    case = FixtureCase(name)
    cur, ref = _frame_paths(case, tmp_path)
    argv = [cur, ref, str(tmp_path / "out"), str(case.blk_dim),
            str(case.span), str(case.width), str(case.height), "--metric",
            metric, "--no-output", "--debug-block", str(by), str(bx)]
    assert jax_cli.main(argv + ["--backend", "xla"]) == 0
    want = _debug_lines(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = _debug_lines(capsys.readouterr().out)
    assert len(want) == 2 * case.span + 3
    assert got == want


@pytest.mark.parametrize("blk,span,h,w", [(7, 5, 40, 51), (24, 4, 60, 80)])
def test_cli_chunked_routes_match_jax(blk, span, h, w, tmp_path, capsys):
    """The routes through the chunked (7x7) and wide (24x24) kernels, with
    truncated edges: the same stack and PSNR lines as the JAX CLI."""
    rng = np.random.default_rng(blk)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = np.roll(ref, (2, -3), (0, 1))
    ref.tofile(tmp_path / "ref.yuv")
    cur.tofile(tmp_path / "cur.yuv")
    out = {}
    for tag, main, extra in (("jax", jax_cli.main, ["--backend", "xla"]),
                             ("port", cli.main, ["--device", "cpu"])):
        assert main([str(tmp_path / "cur.yuv"), str(tmp_path / "ref.yuv"),
                     str(tmp_path / tag), str(blk), str(span), str(w), str(h),
                     *extra]) == 0
        psnr = [line for line in capsys.readouterr().out.splitlines()
                if line.startswith("PSNR")]
        stack = np.fromfile(tmp_path / tag / f"output_{blk}_{span}.yuv",
                            np.uint8)
        out[tag] = psnr, stack.tobytes()
    assert out["port"] == out["jax"]


def test_cli_diamond_early_term_foreman(tmp_path, capsys):
    """`--algorithm diamond --early-term 40` on Foreman F4 -> F1, 16x16
    +-7: the stack and `PSNR:` lines equal a host rebuild from JAX
    `diamond_search_np` with the same threshold, as tests/test_cli.py
    holds the JAX CLI."""
    case = FixtureCase("foreman_mse_16_7")
    cur_p, ref_p = _frame_paths(case, tmp_path)
    assert cli.main([cur_p, ref_p, str(tmp_path / "out"), "16", "7", "352",
                     "288", "--device", "cpu", "--algorithm", "diamond",
                     "--early-term", "40"]) == 0
    stdout = capsys.readouterr().out
    cur = jax_frames.load_yuv(cur_p, 288, 352)
    ref = jax_frames.load_yuv(ref_p, 288, 352)
    mv_y, mv_x, _, _ = jax_diamond.diamond_search_np(
        cur, ref, blk_dim=16, span=7, early_term=40.0)
    comp = jax_frames.compensate_frame_np(ref, mv_y, mv_x, 16)
    psnr = jax_frames.image_psnr(comp, cur.astype(np.int32))
    assert f"PSNR: {psnr:.6f}" in stdout.splitlines()
    assert f"PSNR: {psnr:.0f} " in stdout.splitlines()
    stack = jax_frames.stack_output(ref, cur, comp).astype(np.uint8)
    got = np.fromfile(tmp_path / "out" / "output_16_7.yuv", np.uint8)
    assert got.tobytes() == stack.tobytes()
    full_mv = jax_diamond.diamond_search_np(cur, ref, blk_dim=16, span=7)
    assert not (np.array_equal(mv_y, full_mv[0])
                and np.array_equal(mv_x, full_mv[1])), (
        "the threshold must change the field")


def _smooth_pair(seed, h, w, shift):
    """Low-frequency content moved by `shift` plus noise +-2, as
    tests/test_diamond.py makes it."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float64)
    ref = np.clip(np.kron(small, np.ones((8, 8)))[:h, :w]
                  + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
    cur = np.clip(np.roll(ref, shift, (0, 1)).astype(np.int32)
                  + rng.integers(-2, 3, (h, w)), 0, 255).astype(np.uint8)
    return cur, ref


@pytest.mark.parametrize("frames,blk,span,extra", [
    # adversarial shift past the first level: the crossover merges the
    # full-search optimum into the escaped blocks.
    pytest.param((64, 96, (13, -13)), 8, 15, ["--escape-policy", "crossover"],
                 id="crossover"),
    pytest.param("foreman", 16, 7, ["--metric", "ssim"], id="ssim"),
])
def test_cli_diamond_matches_jax(frames, blk, span, extra, tmp_path, capsys):
    if frames == "foreman":
        cur_p, ref_p = _frame_paths(FixtureCase("foreman_ssim_16_7"),
                                    tmp_path)
        h, w = 288, 352
    else:
        h, w, shift = frames
        cur, ref = _smooth_pair(4, h, w, shift)
        cur_p, ref_p = str(tmp_path / "cur.yuv"), str(tmp_path / "ref.yuv")
        cur.tofile(cur_p)
        ref.tofile(ref_p)
    out = {}
    for tag, main, device in (("jax", jax_cli.main, ["--backend", "xla"]),
                              ("port", cli.main, ["--device", "cpu"])):
        assert main([cur_p, ref_p, str(tmp_path / tag), str(blk), str(span),
                     str(w), str(h), "--algorithm", "diamond", *extra,
                     *device]) == 0
        lines = _compared_lines(capsys.readouterr().out)
        stack = np.fromfile(tmp_path / tag / f"output_{blk}_{span}.yuv",
                            np.uint8)
        out[tag] = lines, stack.tobytes()
    assert out["port"] == out["jax"]
