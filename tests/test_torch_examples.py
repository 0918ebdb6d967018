"""The port's SSIM demo and run scripts on the CPU.

* `examples/ssim_demo_torch.py` against the JAX demo's `ssim_unbiased` on
  the same seeded blocks, seeds 0-4: within 1e-6 (float32 sums in another
  order), with a self-SSIM of 1.0 (within 1e-6), and the two lines the
  JAX demo prints.
* `scripts/run_torch.sh` and `scripts/run_ssim_torch.sh` with
  `--device cpu` on Foreman (F4/F1 from a fixture's planes), at their
  default blk and span: the stack byte-equal to the fixture's
  `output.yuv`; an extra CLI option passes through.
"""
import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


demo = _load(os.path.join(ROOT, "examples", "ssim_demo_torch.py"),
             "ssim_demo_torch")
jax_demo = _load(os.path.join(ROOT, "examples", "ssim_demo.py"), "ssim_demo")


@pytest.mark.parametrize("seed", range(5))
def test_demo_matches_jax_demo(seed, capsys):
    a, b = demo.blocks(seed)
    rng = np.random.default_rng(seed)
    np.testing.assert_array_equal(a, rng.integers(10, 20, (16, 16)))
    np.testing.assert_array_equal(b, rng.integers(10, 20, (16, 16)))
    got = float(demo.ssim_unbiased(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jax_demo.ssim_unbiased(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-6
    ident = float(demo.ssim_unbiased(torch.from_numpy(a),
                                     torch.from_numpy(a)))
    assert abs(ident - 1.0) <= 1e-6
    assert demo.main([str(seed), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        f"SSIM VALUE OBTAINED IS {got:f} ", "(self-SSIM sanity: 1.000000)"]


def test_demo_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main(["0"])


@pytest.mark.parametrize("script,fixture,extra", [
    ("run_torch.sh", "foreman_mse_8_12", ["--timing-row"]),
    ("run_ssim_torch.sh", "foreman_ssim_4_15", []),
])
def test_run_script_writes_the_fixture_stack(script, fixture, extra,
                                             tmp_path):
    stack = np.fromfile(os.path.join(FIXTURES, fixture, "output.yuv"),
                        np.uint8)
    planes = stack.reshape(5, 288, 352)
    cur, ref = tmp_path / "ForemanYF4.yuv", tmp_path / "ForemanYF1.yuv"
    planes[1].tofile(cur)
    planes[0].tofile(ref)
    out = tmp_path / "out"
    proc = subprocess.run(
        ["bash", os.path.join(ROOT, "scripts", script), str(cur), str(ref),
         str(out), "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    blk, span = (8, 12) if script == "run_torch.sh" else (4, 15)
    got = np.fromfile(out / f"output_{blk}_{span}.yuv", np.uint8)
    assert got.tobytes() == stack.tobytes()
    if extra:
        assert len(proc.stdout.splitlines()[-1].split()) == 5  # timing row


def test_run_script_needs_both_frames():
    proc = subprocess.run(["bash", os.path.join(ROOT, "scripts",
                                                "run_torch.sh"), "cur.yuv"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2 and "usage" in proc.stderr
