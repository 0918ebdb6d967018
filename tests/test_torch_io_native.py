"""The port's native frame IO (`motionestimation_tpu_torch/io_native`)
against its plain numpy versions (`core/frames.*_np`) and the JAX
package's `core/frames` functions, on fixture planes and random frames of
truncated sizes: bytes and values equal exactly. Also: the short-file and
missing-file errors, mod-256 narrowing, `core/frames` routing through the
library, a build by two processes at once, and a failed build raising
with the compiler's output.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from motionestimation_tpu.core import frames as jax_frames
from motionestimation_tpu_torch import io_native
from motionestimation_tpu_torch.core import frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")


def _fixture_planes(name):
    with open(os.path.join(FIXTURES, name, "meta.json")) as f:
        meta = json.load(f)
    stack = np.fromfile(os.path.join(FIXTURES, name, "output.yuv"),
                        np.uint8).reshape(5, meta["height"], meta["width"])
    return stack[1], stack[0]  # cur, ref


def _random_pair(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h, w), dtype=np.uint8))


PAIRS = {
    "foreman": lambda: _fixture_planes("foreman_mse_8_12"),
    "rand_90x70": lambda: _fixture_planes("rand_mse_90x70_32_8"),
    "rand_33x45": lambda: _random_pair(33, 45, 1),
    "rand_1x7": lambda: _random_pair(1, 7, 2),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_read_matches_plain_and_jax(name, tmp_path):
    cur, _ = PAIRS[name]()
    h, w = cur.shape
    path = tmp_path / "f.yuv"
    np.concatenate([cur.ravel(), np.arange(5, dtype=np.uint8)]).tofile(path)
    got = io_native.read_frame(path, h, w)
    np.testing.assert_array_equal(got, cur)
    np.testing.assert_array_equal(frames.load_yuv(path, h, w), got)
    np.testing.assert_array_equal(frames.load_yuv_np(path, h, w), got)
    np.testing.assert_array_equal(jax_frames.load_yuv(path, h, w), got)
    buf = np.full((h, w), 7, np.uint8)
    assert frames.load_yuv_into(path, buf) is buf
    np.testing.assert_array_equal(buf, cur)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_write_matches_plain_and_jax(name, tmp_path):
    cur, ref = PAIRS[name]()
    # Values outside [0, 255] narrow mod 256, as the C cast does.
    wide = cur.astype(np.int32) * 3 - ref.astype(np.int32) - 300
    for frame in (wide, cur):
        frames.save_yuv(tmp_path / "port.yuv", frame)
        frames.save_yuv_np(tmp_path / "plain.yuv", frame)
        jax_frames.save_yuv(tmp_path / "jax.yuv", frame)
        got = (tmp_path / "port.yuv").read_bytes()
        assert got == (tmp_path / "plain.yuv").read_bytes()
        assert got == (tmp_path / "jax.yuv").read_bytes()
        assert got == (frame.astype(np.int64) % 256).astype(np.uint8).tobytes()


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_stack_output_matches_plain_and_jax(name):
    cur, ref = PAIRS[name]()
    h, w = cur.shape
    # A compensated frame of random MVs (gathers outside the frame at 0).
    rng = np.random.default_rng(h * w)
    blk = 8
    mv_y = rng.integers(-3, 4, (-(-h // blk), -(-w // blk)))
    mv_x = rng.integers(-3, 4, mv_y.shape)
    comp = np.zeros((h, w), np.int32)
    for y in range(h):
        for x in range(w):
            sy = y + mv_y[y // blk, x // blk]
            sx = x + mv_x[y // blk, x // blk]
            if 0 <= sy < h and 0 <= sx < w:
                comp[y, x] = ref[sy, sx]
    stack = frames.stack_output(ref, cur, comp)
    assert stack.dtype == np.int32 and stack.shape == (5 * h, w)
    np.testing.assert_array_equal(stack,
                                  frames.stack_output_np(ref, cur, comp))
    np.testing.assert_array_equal(stack,
                                  jax_frames.stack_output(ref, cur, comp))


@pytest.mark.parametrize("case", ["short", "missing"])
def test_read_errors(case, tmp_path):
    path = tmp_path / "f.yuv"
    if case == "short":
        np.zeros(30 * 41 - 1, np.uint8).tofile(path)
    error = FileNotFoundError if case == "missing" else OSError
    match = "No such file" if case == "missing" else "expected at least 1230"
    with pytest.raises(error, match=match):
        frames.load_yuv(path, 30, 41)
    with pytest.raises(error):
        frames.load_yuv_np(path, 30, 41)
    with pytest.raises(OSError):  # JAX's native reader: a plain OSError
        jax_frames.load_yuv(path, 30, 41)


def test_write_error(tmp_path):
    with pytest.raises(FileNotFoundError):
        frames.save_yuv(tmp_path / "no_dir" / "f.yuv", np.zeros((2, 2)))


def test_stack_output_needs_equal_frames():
    with pytest.raises(ValueError, match="three equal"):
        frames.stack_output(np.zeros((4, 4)), np.zeros((4, 4)),
                            np.zeros((4, 5)))


def test_frames_route_through_the_library(monkeypatch, tmp_path):
    calls = []
    for name in ("read_frame_into", "write_frame", "stack_output"):
        fn = getattr(io_native, name)
        monkeypatch.setattr(io_native, name,
                            lambda *a, fn=fn, name=name: (calls.append(name),
                                                          fn(*a))[1])
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    frames.save_yuv(tmp_path / "a.yuv", a)
    frames.load_yuv(tmp_path / "a.yuv", 3, 4)
    frames.load_yuv_into(tmp_path / "a.yuv", np.empty((3, 4), np.uint8))
    frames.stack_output(a, a, a)
    assert calls == ["write_frame", "read_frame_into", "read_frame_into",
                     "stack_output"]


_BUILD = """
import sys
from pathlib import Path
from motionestimation_tpu_torch import io_native
io_native.BUILD_DIR = Path(sys.argv[1])
print(io_native.build())
print(io_native.read_frame(sys.argv[2], 3, 4).sum())
"""


def test_two_processes_build_at_once(tmp_path):
    build_dir = tmp_path / "build"
    frame = tmp_path / "f.yuv"
    np.arange(12, dtype=np.uint8).tofile(frame)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build_dir),
                               str(frame)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    libs = {o.splitlines()[0] for o, _ in outs}
    assert len(libs) == 1
    assert all(o.splitlines()[1] == "66" for o, _ in outs)
    assert [p.name for p in build_dir.iterdir()] == [
        os.path.basename(libs.pop())]  # no temporary file left


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "yuv_io.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(io_native, "SOURCE", bad)
    monkeypatch.setattr(io_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        io_native.build()
    assert not list((tmp_path / "build").iterdir())


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.setattr(io_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        io_native.build()
