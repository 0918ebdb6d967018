"""The port's benchmark harness (`motionestimation_tpu_torch.bench`,
`bench_torch.py`) against the JAX package's `motionestimation_tpu.bench`,
on the CPU.

* Every case of tests/test_bench_regression.py, run on both packages'
  `regression` and `matrix.compare_rows`; the port's comparisons equal the
  JAX ones on the same rows.
* The matrix: its tags are the JAX matrix's, letter for letter and in
  order; its frames equal the JAX rows' frames (the four `_synth` pairs in
  the JAX order and the first GOP frame); config1 is left out, with its
  line, without ForemanYF2.yuv; each row's call on a 64x96 crop of its
  frames gives the MVs and costs (SSIM scores within 1e-6) of the JAX
  function that the JAX row calls, run as the JAX tests run it; the GOP
  rows' `run_gop` writes JAX `run_gop`'s dumps.
* The per-sequence main: `_synthetic_4k` does not depend on
  PYTHONHASHSEED and equals the JAX one under the port's seed; `main` at
  8x8 +-12 on Foreman writes PSNR 31.816000 and the JAX main's header,
  row count and PSNR column.
* The options: --frames-dir has no default; the per-sequence rows and the
  matrix keep their version series in separate directories.
* `bench/roofline.bound` at the headline cell; the timed pass's idle share.

Tests whose names end in `_cuda` need the card and skip without one:
`python -m pytest --noconftest tests/test_torch_bench.py -k cuda`.
"""
import ast
import hashlib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from motionestimation_tpu.bench import __main__ as jax_main
from motionestimation_tpu.bench import matrix as jax_matrix
from motionestimation_tpu.bench import regression as jax_regression
from motionestimation_tpu.kernels import full_search_pallas as jax_kernels
from motionestimation_tpu.kernels import ssim_pallas as jax_ssim
from motionestimation_tpu.core.config import SearchConfig as JaxSearchConfig
from motionestimation_tpu.pipeline import runner as jax_runner
from motionestimation_tpu.search import diamond as jax_diamond
from motionestimation_tpu_torch import bench as port_bench
from motionestimation_tpu_torch.bench import __main__ as port_main
from motionestimation_tpu_torch.bench import matrix, measure
from motionestimation_tpu_torch.bench import regression as port_regression
from motionestimation_tpu_torch.bench.roofline import bound
from motionestimation_tpu_torch.core.config import SearchConfig
from motionestimation_tpu_torch.kernels.full_search_cuda import (
    full_search_frame_cuda,
)
from motionestimation_tpu_torch.pipeline import runner

# The tests run in several worker processes on shared cores; one torch
# thread per worker keeps them from oversubscribing the machine.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREMAN = os.path.join(ROOT, "tests", "fixtures", "foreman_mse_8_12",
                       "output.yuv")
SCORE_ATOL = 1e-6
CROP = (64, 96)
PACKAGES = {
    "jax": (jax_regression, jax_matrix.compare_rows),
    "torch": (port_regression, matrix.compare_rows),
}


def _write_foreman(directory):
    """ForemanYF4/YF1.yuv from planes 1 and 0 of a fixture's stack."""
    planes = np.fromfile(FOREMAN, np.uint8).reshape(5, 288, 352)
    planes[1].tofile(os.path.join(directory, "ForemanYF4.yuv"))
    planes[0].tofile(os.path.join(directory, "ForemanYF1.yuv"))
    return str(directory)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    return _write_foreman(tmp_path_factory.mktemp("frames"))


@pytest.fixture(scope="module")
def frames(frames_dir):
    return matrix.matrix_frames(frames_dir)


# --- the regression rule, on both packages ----------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_roundtrip_and_compare(tmp_path, pkg):
    reg, _ = PACKAGES[pkg]
    rows_v1 = [
        ("Foreman", (0.9, 0.1, 0.79, 0.01, 31.82)),
        ("Jockey", (71.5, 6.4, 64.58, 0.50, 27.32)),
    ]
    reg.write_results(tmp_path, 1, "[ Version= 1 ]", rows_v1)
    # v2: kernel slower by 0.2ms on Jockey, PSNR drop 0.6 on Foreman.
    rows_v2 = [
        ("Foreman", (0.9, 0.1, 0.79, 0.01, 31.20)),
        ("Jockey", (71.6, 6.4, 64.78, 0.50, 27.32)),
    ]
    reg.write_results(tmp_path, 2, "[ Version= 2 ]", rows_v2)
    regs = reg.compare_versions(tmp_path, 2, ["Foreman", "Jockey"])
    found = {(r.sequence, r.column) for r in regs}
    assert ("Foreman", "PSNR") in found
    assert ("Jockey", "kernel") in found
    # within-epsilon deltas are not flagged
    assert ("Foreman", "kernel") not in found
    assert ("Jockey", "h2d") not in found


@pytest.mark.parametrize("pkg", PACKAGES)
def test_epsilon_boundaries(tmp_path, pkg):
    reg, _ = PACKAGES[pkg]
    reg.write_results(tmp_path, 1, "[h]", [("S", (10.0, 1.0, 5.0, 0.5, 30.0))])
    # exactly +0.1 ms and -0.5 dB are inside tolerance (strict comparisons)
    reg.write_results(tmp_path, 2, "[h]", [("S", (10.1, 1.1, 5.1, 0.6, 29.5))])
    assert reg.compare_versions(tmp_path, 2, ["S"]) == []
    reg.write_results(tmp_path, 3, "[h]",
                      [("S", (10.21, 1.1, 5.1, 0.6, 28.99))])
    regs = reg.compare_versions(tmp_path, 3, ["S"])
    assert {(r.column) for r in regs} == {"totalTime", "PSNR"}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_matrix_gop_row_gated_transport_normalized(pkg):
    """A ~20% pipeline regression is flagged via the pct-of-link-bound row
    even under 2x link drift, while drift alone (raw ms doubling, pct
    stable) is not."""
    _, compare_rows = PACKAGES[pkg]
    prev = {
        "kernel-row": "10.0",
        "gop-e2e: raw": "250.0",
        "gop-e2e-pct: gated": "90.0",
    }
    # Link 2x slower AND pipeline 20% worse: raw ms 2.4x, pct -18 pts.
    rows = [
        ("kernel-row", 10.0),
        ("gop-e2e: raw", 600.0),
        ("gop-e2e-pct: gated", 72.0),
    ]
    lines, regs = compare_rows(rows, prev)
    assert regs == 1
    assert any(line.startswith("REGRESSION: gop-e2e-pct") for line in lines)
    assert any(line.startswith("info: gop-e2e:") for line in lines)
    # Pure link drift: raw ms doubles, pct wiggles within the band.
    rows = [
        ("kernel-row", 10.0),
        ("gop-e2e: raw", 500.0),
        ("gop-e2e-pct: gated", 86.0),
    ]
    lines, regs = compare_rows(rows, prev)
    assert regs == 0
    # Kernel rows keep the reference's absolute 0.1 ms rule.
    lines, regs = compare_rows([("kernel-row", 10.11)], prev)
    assert regs == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_version_one_has_no_baseline(tmp_path, pkg):
    reg, _ = PACKAGES[pkg]
    reg.write_results(tmp_path, 1, "[h]", [("S", (1, 1, 1, 1, 30.0))])
    assert reg.compare_versions(tmp_path, 1, ["S"]) == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_read_rows_skips_header(tmp_path, pkg):
    reg, _ = PACKAGES[pkg]
    reg.write_results(
        tmp_path, 1, "[ Version= 1, BlkDim= 8 ]",
        [("A", (0.1, 0.2, 0.3, 0.4, 31.0)), ("B", (1, 2, 3, 4, 27.0))],
    )
    rows = reg.read_rows(tmp_path, 1, 2)
    assert np.allclose(rows[0], [0.1, 0.2, 0.3, 0.4, 31.0])
    assert np.allclose(rows[1], [1, 2, 3, 4, 27.0])


def test_regression_module_matches_jax(tmp_path):
    """Same constants, names, file bytes and verdicts on random rows."""
    for name in ("TIMING_EPSILON_MS", "PSNR_EPSILON_DB", "COLUMNS"):
        assert getattr(port_regression, name) == getattr(jax_regression, name)
    for name in ("Regression", "compare_rows", "compare_versions",
                 "read_rows", "write_results"):
        assert getattr(port_bench, name) is getattr(port_regression, name)
    rng = np.random.default_rng(3)
    seqs = [f"S{i}" for i in range(40)]
    prev = rng.uniform(0, 50, (40, 5)).round(3)
    cur = (prev + rng.choice([-0.6, -0.1, 0.0, 0.1, 0.1001, 0.5, 0.51],
                             (40, 5))).round(4)
    want = [(r.sequence, r.column, r.current, r.previous)
            for r in jax_regression.compare_rows(seqs, cur, prev)]
    got = [(r.sequence, r.column, r.current, r.previous)
           for r in port_regression.compare_rows(seqs, cur, prev)]
    assert got == want and got
    assert [str(r) for r in port_regression.compare_rows(seqs, cur, prev)] \
        == [str(r) for r in jax_regression.compare_rows(seqs, cur, prev)]
    for i, reg in enumerate((jax_regression, port_regression)):
        reg.write_results(tmp_path / str(i), 1, "[h]", list(zip(seqs, cur)))
    assert ((tmp_path / "0" / "v1.txt").read_bytes()
            == (tmp_path / "1" / "v1.txt").read_bytes())


def test_matrix_compare_rows_matches_jax():
    rng = np.random.default_rng(4)
    tags = [f"row{i}" for i in range(20)] + [
        f"gop-e2e: {i}" for i in range(5)] + [
        f"gop-e2e-pct: {i}" for i in range(5)]
    prev = {t: f"{v:.4f}" for t, v in zip(tags, rng.uniform(1, 90, 30))}
    rows = [(t, float(prev[t]) + d) for t, d in zip(
        tags, rng.choice([-12.0, -10.0, -0.2, 0.1, 0.15, 11.0], 30))]
    rows.append(("new-row", 1.0))
    assert matrix.compare_rows(rows, prev) == jax_matrix.compare_rows(
        rows, prev)
    assert matrix.compare_rows(rows, prev)[1] > 0


# --- the matrix --------------------------------------------------------------


def _jax_tags():
    """The first argument of every `record(...)` in the JAX run_matrix, in
    source order; the config4 f-string sits in `for blk in (8, 16, 32)`."""
    tree = ast.parse(inspect.getsource(jax_matrix.run_matrix))
    calls = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and getattr(n.func, "id", None) == "record"),
                   key=lambda n: n.lineno)
    tags = []
    for call in calls:
        arg = call.args[0]
        if isinstance(arg, ast.Constant):
            tags.append(arg.value)
        else:
            code = compile(ast.Expression(arg), "<tag>", "eval")
            tags += [eval(code, {"blk": blk}) for blk in (8, 16, 32)]
    return tags


def test_matrix_tags_equal_jax():
    assert len(matrix.TAGS) == 25
    assert list(matrix.TAGS) == _jax_tags()


def test_matrix_frames_equal_jax(frames):
    """The JAX run_matrix draws one default_rng(0) in this order."""
    rng = np.random.default_rng(0)
    want = {
        "config3": jax_matrix._synth(rng, 1080, 1920),
        "adversarial": jax_matrix._synth(rng, 1080, 1920, shift=(14, -14),
                                         noise=2),
        "4k": jax_matrix._synth(rng, 2160, 3840),
        "adversarial-4k": jax_matrix._synth(rng, 2160, 3840,
                                            shift=(28, -28), noise=2),
    }
    for key, pair in want.items():
        for a, b in zip(frames[key], pair):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b, err_msg=key)
    j_ref = want["4k"][1]
    first = np.clip(np.roll(j_ref, (1, -2), (0, 1)).astype(np.int32)
                    + rng.integers(-3, 4, j_ref.shape), 0, 255
                    ).astype(np.uint8)
    np.testing.assert_array_equal(frames["gop"][0], first)
    assert len(frames["gop"]) == 17 and len(frames["post"]) == 16
    planes = np.fromfile(FOREMAN, np.uint8).reshape(5, 288, 352)
    np.testing.assert_array_equal(frames["foreman-f4"][0], planes[1])
    np.testing.assert_array_equal(frames["foreman-f4"][1], planes[0])


def test_config1_left_out_without_f2(frames, frames_dir, capsys):
    rows = matrix.rows_to_run(frames, frames_dir)
    assert [r.tag for r in rows] == list(matrix.TAGS[1:23])
    out = capsys.readouterr().out.splitlines()
    assert out == [f"{matrix.TAGS[0]}: left out: no ForemanYF2.yuv in "
                   f"{frames_dir}"]
    # With F2 present every row runs.
    rows = matrix.rows_to_run({**frames, "foreman-f2": frames["foreman-f4"]},
                              frames_dir)
    assert [r.tag for r in rows] == list(matrix.TAGS[:23])
    assert capsys.readouterr().out == ""


def _jax_field(row, cur, ref):
    """The JAX row's function on the crop: `_full_search_frame_jit` and
    `ssim_search_frame_pallas` in interpret mode, `_diamond_staged` and
    `diamond_search_frame` as the JAX tests run them on the CPU."""
    h, w = cur.shape
    kw = dict(blk_dim=row.blk, span=row.span)
    if row.entry == "full":
        return jax_kernels.full_search_frame_pallas(
            cur, ref, metric=row.metric, interpret=True, **kw)
    if row.entry == "ssim":
        return jax_ssim.ssim_search_frame_pallas(cur, ref, interpret=True,
                                                 **kw)
    if row.entry == "staged":
        return jax_diamond._diamond_staged(
            cur, ref, metric=row.metric, early_term=row.early_term,
            max_steps=jax_diamond.default_max_steps(row.span),
            record_trajectory=False, frame_height=h, frame_width=w,
            escape_policy=row.escape_policy, **kw)[0]
    return jax_diamond.diamond_search_frame(
        cur, ref, metric=row.metric,
        volume_mode={"lazy": "lazy", "volume": "full"}[row.entry], **kw)


@pytest.mark.parametrize("row", matrix.ROWS, ids=lambda r: r.tag.split(":")[0]
                         + ("-blk%d" % r.blk if r.tag.startswith("config4:")
                            else ""))
def test_matrix_row_call_matches_jax(row, frames):
    """The row's call on a 64x96 crop of its frames (config1's on Foreman
    F4/F1: F2 is not in the fixtures) on the CPU, against the JAX row's
    function: MVs, integer costs (SSIM: flat indices) exactly, scores
    exactly for MSE/SAD and within SCORE_ATOL for SSIM."""
    key = "foreman-f4" if row.frames == "foreman-f2" else row.frames
    cur, ref = (np.ascontiguousarray(f[: CROP[0], : CROP[1]])
                for f in frames[key])
    got = matrix.row_call(row, torch.from_numpy(cur), torch.from_numpy(ref),
                          torch.device("cpu"))()
    want = _jax_field(row, cur, ref)
    for name in ("mv_y", "mv_x", "best_cost_i32"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(
        got.score.numpy(), np.asarray(want.score), rtol=0,
        atol=SCORE_ATOL if row.metric == "ssim" else 0)


def test_gop_rows_run_gop_matches_jax(frames, tmp_path):
    """The GOP rows' `run_gop` (8x8 +-12 MSE) on crops of the first GOP
    frames writes the JAX run_gop's dumps, every key."""
    paths = []
    for i, f in enumerate(frames["gop"][:3]):
        paths.append(str(tmp_path / f"f{i}.yuv"))
        np.ascontiguousarray(f[: CROP[0], : CROP[1]]).tofile(paths[-1])
    kw = dict(blk_dim=8, span=12, metric="mse", frame_height=CROP[0],
              frame_width=CROP[1])
    got = runner.run_gop(paths, SearchConfig(**kw), device="cpu",
                         output_dir=tmp_path / "port", resume=False)
    want = jax_runner.run_gop(paths, JaxSearchConfig(**kw), backend="xla",
                              output_dir=tmp_path / "jax", resume=False)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        a, b = np.load(g), np.load(w)
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_run_matrix_needs_the_card(frames_dir, tmp_path):
    with pytest.raises((RuntimeError, ValueError)):
        matrix.run_matrix(1, str(tmp_path), frames_dir=frames_dir,
                          device="cpu")
    assert not os.path.exists(tmp_path / "v1.txt")


# --- the per-sequence main ---------------------------------------------------


def test_synthetic_4k_independent_of_hash_seed():
    """A process with another PYTHONHASHSEED (so another `hash` of the
    name) makes the same frames as this one."""
    seed = "1" if os.environ.get("PYTHONHASHSEED") == "0" else "0"
    code = ("import hashlib, sys; sys.path.insert(0, %r); "
            "from motionestimation_tpu_torch.bench import __main__ as m; "
            "c, r = m._synthetic_4k('Jockey'); print(hash('Jockey')); "
            "print(hashlib.sha256(c.tobytes() + r.tobytes()).hexdigest())"
            % ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], env=dict(os.environ, PYTHONHASHSEED=seed),
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout.split()
    assert int(out[0]) != hash("Jockey")
    cur, ref = port_main._synthetic_4k("Jockey")
    assert out[1] == hashlib.sha256(cur.tobytes() + ref.tobytes()).hexdigest()


def test_synthetic_4k_equals_jax_under_the_port_seed(monkeypatch):
    """The JAX arithmetic, with the JAX module's `hash` replaced by the
    port's seed function."""
    monkeypatch.setattr(jax_main, "hash", port_main.sequence_seed,
                        raising=False)
    for name in ("Jockey", "Beauty"):
        for a, b in zip(port_main._synthetic_4k(name),
                        jax_main._synthetic_4k(name)):
            np.testing.assert_array_equal(a, b)
    assert port_main.sequence_seed("Jockey") != port_main.sequence_seed(
        "Beauty")


def test_main_foreman_matches_jax(frames_dir, tmp_path, monkeypatch, capsys):
    """`-v 1 --device cpu --sequences Foreman` at 8x8 +-12: PSNR 31.816000,
    and the JAX main's header, row count and PSNR column."""
    argv = ["-v", "1", "-b", "8", "-s", "12", "--sequences", "Foreman",
            "--repeats", "1"]
    assert port_main.main(argv + ["--device", "cpu", "--frames-dir",
                                  frames_dir, "--results-dir",
                                  str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    assert "device ms not measured" in out
    monkeypatch.setattr(jax_main, "REF_FRAMES", frames_dir)
    assert jax_main.main(argv + ["--backend", "xla", "--results-dir",
                                 str(tmp_path / "jax")]) == 0
    got = (tmp_path / "port" / "v1.txt").read_text().splitlines()
    want = (tmp_path / "jax" / "v1.txt").read_text().splitlines()
    assert got[0] == want[0] == (
        "[ Version= 1, BlkDim= 8, ExtraSpan=12, Metric= mse ]")
    assert len(got) == len(want) == 3 and got[1] == want[1] == ""
    assert got[2].split()[4] == want[2].split()[4] == "31.816000"
    # A second version compares against the first on the PSNR rule.
    assert port_main.main(argv + ["-v", "2", "--device", "cpu",
                                  "--frames-dir", frames_dir,
                                  "--results-dir",
                                  str(tmp_path / "port")]) in (0, 1)
    rows = port_regression.read_rows(tmp_path / "port", 2, 1)
    assert f"{rows[0][4]:.6f}" == "31.816000"


def test_main_needs_frames_dir(tmp_path, capsys):
    """No default frames directory: the bench reads only what it is
    given."""
    with pytest.raises(SystemExit):
        port_main.main(["-v", "1", "--device", "cpu", "--sequences",
                        "Foreman", "--results-dir", str(tmp_path)])
    assert "--frames-dir" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "v1.txt")


def test_modes_keep_their_series_apart(frames_dir, tmp_path, monkeypatch):
    """Run from a checkout's root with the defaults, the per-sequence rows
    go to results/h100/sequences and compare there, beside the committed
    matrix file results/h100/v1.txt, which they leave as it is; --matrix
    defaults to results/h100."""
    monkeypatch.chdir(tmp_path)
    committed = os.path.join(ROOT, "results", "h100", "v1.txt")
    matrix_file = tmp_path / "results" / "h100" / "v1.txt"
    matrix_file.parent.mkdir(parents=True)
    matrix_file.write_bytes(open(committed, "rb").read())
    argv = ["-b", "8", "-s", "12", "--sequences", "Foreman", "--repeats",
            "1", "--device", "cpu", "--frames-dir", frames_dir]
    assert port_main.main(["-v", "1"] + argv) == 0
    assert port_main.main(["-v", "2"] + argv) in (0, 1)
    assert matrix_file.read_bytes() == open(committed, "rb").read()
    rows = port_regression.read_rows(
        tmp_path / "results" / "h100" / "sequences", 2, 1)
    assert f"{rows[0][4]:.6f}" == "31.816000"
    seen = {}
    monkeypatch.setattr(matrix, "run_matrix",
                        lambda version, results_dir, **kw: seen.setdefault(
                            "dir", results_dir) and 0)
    assert port_main.main(["-v", "2", "--matrix", "--device", "cpu",
                           "--frames-dir", frames_dir]) == 0
    assert seen["dir"] == os.path.join("results", "h100")


def test_idle_of_a_timed_call():
    """The timed pass's idle share: 1 - the profiled busy ms per call over
    the timed call's ms, apart from the profiled pass's own."""
    prof = measure.Profile(
        kernel_ms=0.3, kernels={}, lost=0, device_ops=22.0, launches={},
        busy_ms=0.32, idle=0.574, host_ms=0.5, host_ops=[])
    assert prof.idle_of(0.4) == pytest.approx(0.2)
    text = prof.describe(0.4)
    assert "idle 20.0% of the timed pass" in text
    assert "57.4% of the profiled pass" in text


def test_main_raises_without_cuda(frames_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.main(["-v", "1", "--sequences", "Foreman", "--frames-dir",
                        frames_dir, "--results-dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "v1.txt")


def test_bench_torch_exits_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    import bench_torch

    assert bench_torch.main([]) != 0
    assert capsys.readouterr().out == ""


def test_bound_at_the_headline():
    """4K 8x8 +-12: bytes bind (two frames, the padded reference and two
    int32 grids at 3.35 TB/s), 0.005305 ms."""
    ms, by = bound(2160, 3840, 8, 12, (2160, 3840), (0, 0))
    nbytes = 2160 * 3840 + 2184 * 3864 + 2 * 4 * 270 * 480
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert round(ms, 6) == 0.005305


def test_host_self_ms_matches_key_averages():
    """Self CPU time from the profiler's raw events equals `key_averages`'
    on a profile of the plain search on the CPU."""
    rng = np.random.default_rng(5)
    cur, ref = (rng.integers(0, 256, (40, 56), dtype=np.uint8)
                for _ in range(2))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            full_search_frame_cuda(cur, ref, blk_dim=8, span=2, device="cpu")
    got = measure.host_self_ms(prof.profiler.kineto_results.events())
    want = {a.key: a.self_cpu_time_total / 1e3 for a in prof.key_averages()}
    assert got.keys() == want.keys() and len(got) > 10
    for name, ms in want.items():
        assert got[name] == pytest.approx(ms, abs=1e-6), name


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("row", matrix.ROWS[1:], ids=lambda r: r.tag.split(
    ":")[0] + ("-blk%d" % r.blk if r.tag.startswith("config4:") else ""))
def test_matrix_row_call_matches_cpu_cuda(cuda, row, frames):
    """The row's call on the card equals the CPU's on a 256x384 crop."""
    cur, ref = (np.ascontiguousarray(f[:256, :384])
                for f in frames[row.frames])
    want = matrix.row_call(row, torch.from_numpy(cur), torch.from_numpy(ref),
                           torch.device("cpu"))()
    got = matrix.row_call(row, torch.from_numpy(cur).to(cuda),
                          torch.from_numpy(ref).to(cuda), cuda)()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def test_profile_pass_sees_the_kernels_cuda(cuda, frames):
    """The ctypes-launched search kernels show in the profiler's CUDA
    activity: one phase kernel a frame at 4K 8x8 +-12."""
    cur, ref = (torch.from_numpy(f).to(cuda) for f in frames["4k"])
    row, = (r for r in matrix.ROWS if r.tag.startswith("headline:"))
    call = matrix.row_call(row, cur, ref, cuda)
    call()
    prof = measure.profile_pass(call, 4, cuda)
    assert prof.launches == {"me_phase_search": 1.0}
    name = "me::warp_search_kernel<8, (me::Form)0, false>"
    assert list(prof.kernels) == [name] and prof.kernels[name][0] == 1
    assert prof.kernel_ms == prof.kernels[name][1] > 0
    assert 0 <= prof.idle < 1 and prof.device_ops > 1
    assert prof.busy_ms > 0 and prof.idle_of(1e3) < 1
    assert len(prof.host_ops) == 5
