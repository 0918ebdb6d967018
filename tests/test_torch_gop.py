"""The port's GOP pipeline (`pipeline/runner.run_gop`, `_gop_pack_kk`,
`core/frames.load_yuv_into`) against the JAX package's on the CPU.

`run_gop(device="cpu")` must write the same `mv_%05d.npz` dumps as JAX
`run_gop(backend="xla")`: MVs, integer costs, `psnr` and the path strings
exactly, with equal dtypes; SSIM scores within 1e-6 (jitted XLA fuses the
float32 score arithmetic) and SSIM MVs equal. Packed readbacks above 2^31
decode right; resume skips existing dumps and recomputes a hole equal; the
pool's buffers never alias a staged frame; a writer or reader error raises
promptly. The `_cuda` tests run the same GOPs on the card and hold them
against the CPU path's dumps.
"""
import os
import threading

import numpy as np
import pytest
import torch

from motionestimation_tpu.core import frames as jax_frames
from motionestimation_tpu.core.config import SearchConfig as JaxSearchConfig
from motionestimation_tpu.pipeline import runner as jax_runner
from motionestimation_tpu_torch.core import frames
from motionestimation_tpu_torch.core.config import SearchConfig
from motionestimation_tpu_torch.pipeline import runner

# The tests run in several worker processes on shared cores; one torch
# thread per worker keeps them from oversubscribing the machine.
torch.set_num_threads(1)

FOREMAN = os.path.join(os.path.dirname(__file__), "fixtures",
                       "foreman_mse_16_7", "output.yuv")
SCORE_ATOL = 1e-6


def _write(tmp_path, planes, prefix="f"):
    paths = []
    for i, plane in enumerate(planes):
        path = tmp_path / f"{prefix}{i}.yuv"
        plane.tofile(path)
        paths.append(str(path))
    return paths


def _drift(seed, n, h, w):
    """n frames: a random first one, each next moved by (1, -1) plus noise
    +-2, as tests/test_ingest.py makes them."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, (h, w), dtype=np.uint8)]
    for _ in range(n - 1):
        out.append(np.clip(np.roll(out[-1], (1, -1), (0, 1)).astype(np.int32)
                           + rng.integers(-2, 3, (h, w)), 0, 255)
                   .astype(np.uint8))
    return out


def _foreman():
    """Foreman F1, F4 and F1 again: planes 0 and 1 of a fixture's stack."""
    planes = np.fromfile(FOREMAN, np.uint8).reshape(5, 288, 352)
    return [planes[0], planes[1], planes[0]]


def _assert_dumps_equal(got, want, ssim=False):
    """Every npz key: same dtype and shape, equal values (SSIM's float
    scores within SCORE_ATOL)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        a, b = np.load(g), np.load(w)
        assert sorted(a.files) == sorted(b.files) == [
            "best_cost", "cur", "mv_x", "mv_y", "psnr", "ref", "score"]
        for key in b.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].shape == b[key].shape, key
            if ssim and key in ("best_cost", "score"):
                np.testing.assert_allclose(a[key], b[key], rtol=0,
                                           atol=SCORE_ATOL)
            else:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _assert_dump_is_pair(path, pair):
    """A dump against `run_pair` on the same pair."""
    d = np.load(path)
    np.testing.assert_array_equal(d["mv_y"], pair.field.mv_y)
    np.testing.assert_array_equal(d["mv_x"], pair.field.mv_x)
    np.testing.assert_array_equal(d["best_cost"], pair.field.best_cost_i32)
    np.testing.assert_array_equal(d["score"], pair.field.score)
    assert float(d["psnr"]) == pair.psnr


# --- load_yuv_into -----------------------------------------------------------


def test_load_yuv_into_same_bytes_as_load_yuv(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 30 * 41 + 7, dtype=np.uint8)  # trailing bytes
    path = tmp_path / "f.yuv"
    data.tofile(path)
    buf = np.full((30, 41), 9, np.uint8)
    got = frames.load_yuv_into(path, buf)
    assert got is buf
    np.testing.assert_array_equal(buf, frames.load_yuv(path, 30, 41))
    np.testing.assert_array_equal(buf, jax_frames.load_yuv(path, 30, 41))


@pytest.mark.parametrize("case", ["short", "dtype", "rank", "strided"])
def test_load_yuv_into_raises(case, tmp_path):
    path = tmp_path / "f.yuv"
    np.zeros(30 * 41, np.uint8).tofile(path)
    buf = {
        "short": np.empty((31, 41), np.uint8),
        "dtype": np.empty((30, 41), np.int16),
        "rank": np.empty(30 * 41, np.uint8),
        "strided": np.empty((30, 82), np.uint8)[:, ::2],
    }[case]
    error = IOError if case == "short" else ValueError
    with pytest.raises(error):
        frames.load_yuv_into(path, buf)
    with pytest.raises(error):
        jax_frames.load_yuv_into(path, buf)


# --- _gop_pack_kk ------------------------------------------------------------


@pytest.mark.parametrize("metric", ["mse", "sad", "ssim"])
def test_gop_pack_kk_matches_jax(metric):
    """Every (blk, span) of a grid that crosses the 2^32 edge: MSE 8x8
    packs up to +-15 ((65025*64 + 1)*31^2 < 2^32) and not at +-16."""
    edge = {(8, 15): True, (8, 16): False} if metric == "mse" else {}
    packed = 0
    for blk in (1, 2, 4, 7, 8, 9, 16, 24, 32, 64):
        for span in (0, 1, 4, 7, 12, 15, 16, 31, 64):
            kw = dict(blk_dim=blk, span=span, metric=metric)
            got = runner._gop_pack_kk(SearchConfig(**kw))
            assert got == jax_runner._gop_pack_kk(JaxSearchConfig(**kw))
            if (blk, span) in edge:
                assert (got is not None) == edge[blk, span]
            packed += got is not None
    assert (packed > 0) == (metric != "ssim")


# --- run_gop against JAX -----------------------------------------------------

GOP_CASES = {
    # (frames, config keywords, packed readback)
    "packed-mse": ("drift6", dict(blk_dim=8, span=4, metric="mse"), True),
    "packed-sad": ("drift6", dict(blk_dim=8, span=4, metric="sad"), True),
    "unpacked-mse": ("drift4", dict(blk_dim=32, span=5, metric="mse"), False),
    "unpacked-ssim": ("drift4", dict(blk_dim=8, span=5, metric="ssim"), False),
    "diamond-foreman": ("foreman", dict(blk_dim=16, span=7, metric="mse",
                                        algorithm="diamond",
                                        early_term=40.0), True),
}


def _gop_frames(kind):
    return {"drift6": lambda: _drift(7, 6, 48, 64),
            "drift4": lambda: _drift(5, 4, 64, 64),
            "foreman": _foreman}[kind]()


@pytest.mark.parametrize("name", list(GOP_CASES))
def test_run_gop_matches_jax(name, tmp_path):
    kind, kw, packed = GOP_CASES[name]
    planes = _gop_frames(kind)
    h, w = planes[0].shape
    kw = dict(kw, frame_height=h, frame_width=w)
    paths = _write(tmp_path, planes)
    assert (runner._gop_pack_kk(SearchConfig(**kw)) is not None) == packed
    want = jax_runner.run_gop(paths, JaxSearchConfig(**kw),
                              output_dir=tmp_path / "jax", backend="xla",
                              chunk_pairs=2)
    got = runner.run_gop(paths, SearchConfig(**kw),
                         output_dir=tmp_path / "port", device="cpu",
                         chunk_pairs=2)
    assert [os.path.basename(p) for p in got] == [
        f"mv_{i:05d}.npz" for i in range(len(planes) - 1)]
    _assert_dumps_equal(got, want, ssim=kw["metric"] == "ssim")


def test_run_gop_payload_above_2_31(tmp_path):
    """A white current over a black reference at 8x8 +-12: every cost is
    65025*64, so the payload cost*625 + flat passes 2^31. It must come back
    as the unsigned 32 bits, equal to JAX's dump and to run_pair."""
    black = np.zeros((32, 48), np.uint8)
    white = np.full((32, 48), 255, np.uint8)
    paths = _write(tmp_path, [black, white])
    kw = dict(blk_dim=8, span=12, frame_height=32, frame_width=48)
    want = jax_runner.run_gop(paths, JaxSearchConfig(**kw),
                              output_dir=tmp_path / "jax", backend="xla",
                              chunk_pairs=2)
    got = runner.run_gop(paths, SearchConfig(**kw),
                         output_dir=tmp_path / "port", device="cpu")
    _assert_dumps_equal(got, want)
    d = np.load(got[0])
    assert int(d["best_cost"].max()) * 625 >= 2**31
    _assert_dump_is_pair(got[0], runner.run_pair(white, black,
                                                  SearchConfig(**kw),
                                                  device="cpu"))


# --- the pipeline ------------------------------------------------------------


def test_run_gop_resume_hole_and_stats(tmp_path):
    """Five pairs in chunks of two (the last one short), every dump equal
    to run_pair; a deleted dump mid-GOP is recomputed alone and equal, and
    the others keep their mtimes."""
    planes = _drift(7, 6, 48, 64)
    paths = _write(tmp_path, planes)
    config = SearchConfig(blk_dim=8, span=4, frame_width=64, frame_height=48)
    outdir = tmp_path / "out"
    stats: dict = {}
    out = runner.run_gop(paths, config, output_dir=outdir, device="cpu",
                         chunk_pairs=2, stats_out=stats)
    assert stats["pairs"] == 5 and stats["chunks"] == 3
    assert stats["wall_s"] > 0
    for i in range(5):
        _assert_dump_is_pair(out[i], runner.run_pair(
            planes[i + 1], planes[i], config, device="cpu"))
    golden = dict(np.load(out[2]))
    os.remove(out[2])
    mtimes = {p: os.stat(p).st_mtime_ns for p in out if os.path.exists(p)}
    stats = {}
    assert runner.run_gop(paths, config, output_dir=outdir, device="cpu",
                          chunk_pairs=2, stats_out=stats) == out
    assert stats["pairs"] == 1 and stats["chunks"] == 1
    for p, t in mtimes.items():
        assert os.stat(p).st_mtime_ns == t
    d = np.load(out[2])
    for key, value in golden.items():
        np.testing.assert_array_equal(d[key], value)


def test_run_gop_pool_buffers_never_alias_a_frame(tmp_path):
    """chunk_pairs=1 over 16 unrelated frames: 9 pool buffers serve 16
    reads, each refilled while the frame read into it is still staged as
    the next chunk's reference. Every pair must equal run_pair."""
    rng = np.random.default_rng(11)
    planes = [rng.integers(0, 256, (24, 40), dtype=np.uint8)
              for _ in range(16)]
    paths = _write(tmp_path, planes)
    config = SearchConfig(blk_dim=8, span=3, frame_width=40, frame_height=24)
    out = runner.run_gop(paths, config, output_dir=tmp_path / "out",
                         device="cpu", chunk_pairs=1)
    for i in range(15):
        _assert_dump_is_pair(out[i], runner.run_pair(
            planes[i + 1], planes[i], config, device="cpu"))


def _run_in_thread(fn, timeout=60.0):
    """fn() in a thread joined with a timeout: a hang fails the test."""
    box = {}

    def target():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 — handed to the test
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "run_gop hung"
    return box


@pytest.mark.parametrize("where", ["writer", "reader"])
def test_run_gop_error_raises_not_hangs(where, tmp_path, monkeypatch):
    """A failing np.savez (the writer) or a truncated frame mid-GOP (the
    reader), 13 pairs at chunk_pairs=1, many more than the queues hold:
    run_gop raises the error and fills stats_out."""
    rng = np.random.default_rng(3)
    planes = [rng.integers(0, 256, (32, 32), dtype=np.uint8)
              for _ in range(14)]
    paths = _write(tmp_path, planes)
    if where == "writer":
        def boom(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(np, "savez", boom)
        match = "disk full"
    else:
        planes[7][:20].tofile(paths[7])
        match = "expected at least 1024 bytes"
    config = SearchConfig(blk_dim=8, span=2, frame_width=32, frame_height=32)
    stats: dict = {}
    box = _run_in_thread(lambda: runner.run_gop(
        paths, config, output_dir=tmp_path / "out", device="cpu",
        chunk_pairs=1, stats_out=stats))
    assert isinstance(box.get("error"), OSError), box
    assert match in str(box["error"])
    assert stats["wall_s"] > 0


def test_run_gop_defaults_to_the_card(tmp_path):
    """No device means "cuda": without CUDA, run_gop and the CLI's --gop
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    from motionestimation_tpu_torch import cli

    paths = _write(tmp_path, _drift(1, 2, 16, 16))
    config = SearchConfig(blk_dim=8, span=1, frame_width=16, frame_height=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.run_gop(paths, config, output_dir=tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([*paths, str(tmp_path / "cli"), "8", "1", "16", "16",
                  "--gop", *paths])
    assert not (tmp_path / "out").exists()


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("chunk_pairs", [1, 3])
@pytest.mark.parametrize("name", ["packed-mse", "unpacked-mse",
                                  "unpacked-ssim", "diamond-foreman"])
def test_run_gop_matches_cpu_cuda(cuda, name, chunk_pairs, tmp_path):
    """The pinned, copy-stream pipeline on the card writes the CPU path's
    dumps."""
    kind, kw, _ = GOP_CASES[name]
    planes = _gop_frames(kind)
    planes += planes[1:][::-1]  # more pairs than a chunk, a tail chunk
    h, w = planes[0].shape
    config = SearchConfig(**kw, frame_height=h, frame_width=w)
    paths = _write(tmp_path, planes)
    want = runner.run_gop(paths, config, output_dir=tmp_path / "cpu",
                          device="cpu", chunk_pairs=chunk_pairs)
    stats: dict = {}
    got = runner.run_gop(paths, config, output_dir=tmp_path / "cuda",
                         device=cuda, chunk_pairs=chunk_pairs,
                         stats_out=stats)
    assert stats["chunks"] == -(-(len(planes) - 1) // chunk_pairs)
    _assert_dumps_equal(got, want, ssim=kw["metric"] == "ssim")
