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
stack and score lines. `--gop` must write the JAX CLI's npz dumps, skip
them on a second call and print the `GOP:` line; `--profile DIR` must
write a trace there and leave stdout as it is.
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


def _gop_frames(tmp_path):
    """Foreman F1, F4, F1 as three files (planes 0 and 1 of a fixture)."""
    stack = FixtureCase("foreman_mse_16_7").golden_stack
    paths = []
    for i, plane in enumerate((stack[0], stack[1], stack[0])):
        plane.tofile(tmp_path / f"gop{i}.yuv")
        paths.append(str(tmp_path / f"gop{i}.yuv"))
    return paths


def _gop_argv(paths, out, *extra):
    return [paths[0], paths[0], str(out), "16", "7", "352", "288", *extra,
            "--gop", *paths]


def test_cli_gop_matches_jax(tmp_path):
    """`--gop F1 F4 F1` at 16x16 +-7: the same npz dumps as the JAX CLI's
    `--backend xla --gop`, key for key."""
    paths = _gop_frames(tmp_path)
    assert jax_cli.main(_gop_argv(paths, tmp_path / "jax", "--backend",
                                  "xla")) == 0
    assert cli.main(_gop_argv(paths, tmp_path / "port", "--device",
                              "cpu")) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "mv_00000.npz", "mv_00001.npz"]
    for name in names:
        got = np.load(tmp_path / "port" / name)
        want = np.load(tmp_path / "jax" / name)
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_cli_gop_prints_the_gop_line(tmp_path, capsys):
    """After the config echo, one `GOP: N frame pairs -> DIR` line and no
    pair output."""
    paths = _gop_frames(tmp_path)
    out = tmp_path / "out"
    assert cli.main(_gop_argv(paths, out, "--device", "cpu")) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == f"GOP: 2 frame pairs -> {out}"
    assert lines[-2] == "]"
    assert not any(line.startswith("PSNR") for line in lines)
    assert sorted(os.listdir(out)) == ["mv_00000.npz", "mv_00001.npz"]


def test_cli_gop_second_call_rewrites_nothing(tmp_path, capsys):
    """Resume: a second identical call finds every dump and rewrites none,
    and still reports every pair."""
    paths = _gop_frames(tmp_path)
    argv = _gop_argv(paths, tmp_path / "out", "--device", "cpu")
    assert cli.main(argv) == 0
    dumps = sorted((tmp_path / "out").iterdir())
    mtimes = [p.stat().st_mtime_ns for p in dumps]
    capsys.readouterr()
    assert cli.main(argv) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "GOP: 2 frame pairs -> ")
    assert [p.stat().st_mtime_ns for p in dumps] == mtimes


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    """`--profile DIR` records the pair run with torch.profiler and writes
    a non-empty Chrome trace into DIR; stdout is unchanged (SSIM prints no
    timing line)."""
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    cur = np.roll(ref, (1, -2), (0, 1))
    ref.tofile(tmp_path / "ref.yuv")
    cur.tofile(tmp_path / "cur.yuv")
    argv = [str(tmp_path / "cur.yuv"), str(tmp_path / "ref.yuv"),
            str(tmp_path / "out"), "8", "2", "64", "48", "--metric", "ssim",
            "--device", "cpu"]
    assert cli.main(argv) == 0
    plain = capsys.readouterr().out
    assert cli.main(argv + ["--profile", str(tmp_path / "trace")]) == 0
    assert capsys.readouterr().out == plain
    traces = os.listdir(tmp_path / "trace")
    assert traces
    assert all(os.path.getsize(tmp_path / "trace" / t) > 0 for t in traces)


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
