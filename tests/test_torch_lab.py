"""The speed-of-light tools of the port vs the JAX repo's `tools/` kernels.

`tools/kern_lab.py` and `tools/vpu_peak.py` are loaded as fresh module
objects (one per test module, so their jitted functions trace anew) with
small globals, their `pl` replaced by a namespace whose `pallas_call` runs
in interpret mode and hands the raw kernel outputs out through
`jax.debug.callback`. Nothing under `tools/` changes. The same numpy inputs
go through the JAX kernel and the port's wrapper on the CPU (its plain
version):

* L2 ("P0", "P1") and L4 ("P4", "P4S") at 256x256 8x8 +-12, tile_h 64 and
  128: exact at every block start, and a constant pair (cur 0, ref 255)
  whose SSD key wraps int32;
* P2: exact (every value an integer below 2^24);
* P1 per mix, within 1e-5 relative (the two sides round multiply and add
  in their own places), on inputs where one step fewer of any chain moves
  the result far past that tolerance;
* the port's kern_lab CLI prints a FAILED line for an unknown variant.

Tests whose names end in `_cuda` hold each CUDA kernel against its plain
version on the card and skip where there is none:
`python -m pytest --noconftest tests/test_torch_lab.py -k cuda`.
"""
import contextlib
import importlib.util
import io
import os
import sys

import jax
import numpy as np
import pytest
import torch

from motionestimation_tpu_torch.kernels import lab_cuda as lab
from motionestimation_tpu_torch.tools import kern_lab as tkl
from motionestimation_tpu_torch.tools import vpu_peak as tvp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAB_SIZE = 256
PEAK = dict(ROWS=8, COLS=128, OUTER=tvp.CHECK_OUTER, CHAIN=1)
CH_W = 128


class _Interpret:
    """Stands in for a tool's `pl`: `pallas_call` in interpret mode, each
    call's raw outputs appended to `outputs` as numpy arrays."""

    def __init__(self, pl):
        self._pl = pl
        self.outputs = []

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, kernel, **kw):
        call = self._pl.pallas_call(kernel, interpret=True, **kw)

        def run(*args):
            out = call(*args)
            jax.debug.callback(
                lambda *xs: self.outputs.append([np.asarray(x) for x in xs]),
                *jax.tree_util.tree_leaves(out))
            return out

        return run


def _load_tool(name, **globals_):
    """A fresh module object of tools/<name>.py with `globals_` set and `pl`
    interpreted; the compilation-cache setting and the `sys.path` entry
    it makes at import are undone."""
    before = jax.config.jax_compilation_cache_dir
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        sys.path[:] = path
    mod.pl = _Interpret(mod.pl)
    for k, v in globals_.items():
        setattr(mod, k, v)
    return mod


def _last_outputs(mod, result):
    float(result)
    jax.effects_barrier()
    return mod.pl.outputs[-1]


@pytest.fixture(scope="module")
def jax_lab():
    return _load_tool("kern_lab", H=LAB_SIZE, W=LAB_SIZE, CHAIN=1)


@pytest.fixture(scope="module")
def jax_peak():
    return _load_tool("vpu_peak", CH_W=CH_W, **PEAK)


@pytest.fixture(scope="module")
def lab_inputs():
    return tkl.make_inputs(0, height=LAB_SIZE, width=LAB_SIZE)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("tile_h", [64, 128])
@pytest.mark.parametrize("variant", ["P0", "P1"])
def test_phase_matches_jax(jax_lab, lab_inputs, variant, tile_h):
    cur, ref_p = lab_inputs
    want_cost, want_idx = _last_outputs(jax_lab, jax_lab.run_phase(
        cur, ref_p, variant=variant, tile_h=tile_h))
    launches = lab.lab_phase.launches
    cost, idx = tkl.run_phase(*_torch(cur, ref_p), variant=variant,
                              tile_h=tile_h)
    assert lab.lab_phase.launches == launches  # plain versions never count
    assert cost.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(cost.numpy(), want_cost[:, ::8])
    np.testing.assert_array_equal(idx.numpy(), want_idx[:, ::8])


@pytest.mark.parametrize("tile_h", [64, 128])
@pytest.mark.parametrize("variant", ["P4", "P4S"])
def test_diff_key_matches_jax(jax_lab, lab_inputs, variant, tile_h):
    cur, ref_p = lab_inputs
    sad = variant == "P4S"
    (want,) = _last_outputs(jax_lab, jax_lab.run_p4(
        cur, ref_p, tile_h=tile_h, sad=sad, nchain=1))
    key = tkl.run_p4(*_torch(cur, ref_p), tile_h=tile_h, sad=sad)
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy(), want[:, ::8])
    # The key decodes to the cross-term kernel's (cost, idx).
    cost, idx = tkl.decode_key(key)
    want_cost, want_idx = tkl.run_phase(
        *_torch(cur, ref_p), variant="P1" if sad else "P0", tile_h=tile_h)
    assert torch.equal(cost, want_cost) and torch.equal(idx, want_idx)


def test_diff_key_wraps_like_jax(jax_lab):
    """cur 0, ref 255: every valid SSD is 64 * 255^2 = 4,161,600, so
    cost * 625 passes 2^31 and the int32 key wraps; the first valid
    candidate in raster order wins."""
    cur, ref_p = tkl.make_inputs(0, height=LAB_SIZE, width=LAB_SIZE)
    cur[:] = 0
    ref_p[tkl.SPAN : tkl.SPAN + LAB_SIZE, tkl.SPAN : tkl.SPAN + LAB_SIZE] = 255
    (want,) = _last_outputs(jax_lab, jax_lab.run_p4(
        cur, ref_p, tile_h=64, sad=False, nchain=1))
    key = tkl.run_p4(*_torch(cur, ref_p), tile_h=64)
    np.testing.assert_array_equal(key.numpy(), want[:, ::8])
    cost, idx = tkl.decode_key(key)
    assert bool((cost == 64 * 255**2).all())
    assert 64 * 255**2 * 625 > 2**31
    # The top-left block's first valid candidate is (0, 0): flat 12*25+12.
    assert int(idx[0, 0]) == 12 * 25 + 12 and int(idx[2, 2]) == 0


def test_chain_matches_jax(jax_peak):
    c, e = tvp.chain_inputs(ch_w=CH_W)
    (want,) = _last_outputs(jax_peak, jax_peak.run_chain(c.numpy(), e.numpy()))
    got = tvp.run_chain(c, e, chain=1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _peak_rel(got, want):
    got = np.asarray(got, np.float64)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    return float((np.abs(got - want) / np.abs(want)).max())


# On the check's inputs (tvp.check_input, 8x128, OUTER 8), where every step
# moves the result; the largest relative difference seen here between JAX
# interpret mode and the plain version: fma 2.6e-7, mix 1.1e-6, roll 0.
@pytest.mark.parametrize("mix", ["fma", "mix", "roll"])
def test_peak_matches_jax(jax_peak, mix):
    a = tvp.check_input(mix, PEAK["ROWS"], PEAK["COLS"])
    (want,) = _last_outputs(jax_peak, jax_peak.run(a.numpy(), mix=mix))
    got = tvp.run(a, mix=mix, outer=PEAK["OUTER"], chain=1)
    assert _peak_rel(got.numpy(), want) <= 1e-5


# Largest relative difference over the entries that one step fewer makes,
# seen here (the smaller of the two cases): fma 0.031, mix 0.33, roll 0.996.
@pytest.mark.parametrize("mix", ["fma", "mix", "roll"])
def test_peak_check_sees_one_step(jax_peak, mix):
    """On the check's inputs one step fewer, in the inner chain or the outer
    loop, moves the output far past both tolerances (1e-5 against JAX,
    tvp.CHECK_TOL on the card), so neither check passes a short chain."""
    a = tvp.check_input(mix, PEAK["ROWS"], PEAK["COLS"])
    (want,) = _last_outputs(jax_peak, jax_peak.run(a.numpy(), mix=mix))
    step = 4 if mix == "fma" else 8  # INNER ops per step of each stream
    for inner, outer in ((tvp.INNER - step, PEAK["OUTER"]),
                         (tvp.INNER, PEAK["OUTER"] - 1)):
        short = lab.peak_plain(a, mix, inner=inner, outer=outer)
        assert _peak_rel(short.numpy(), want) > 10 * tvp.CHECK_TOL[mix]


def test_kern_lab_cli_reports_unported_variants():
    """Every variant of the JAX lab is ported (tests/test_torch_lab_variants.py);
    a name no kernel takes is reported as the JAX tool reports it (its
    `make_kernel` raises ValueError): one FAILED line each, and the CLI
    goes on."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tkl.main(["Q1", "L9:64", "X:128:5"]) == 0
    lines = buf.getvalue().splitlines()
    assert len(lines) == 3
    for line, name in zip(lines, ("Q1", "L9:64", "X:128:5")):
        assert line.startswith(f"{name:14s} FAILED: ValueError: ")


def test_lab_operand_checks():
    cur, ref_p = _torch(*tkl.make_inputs(0, height=64, width=64))
    with pytest.raises(ValueError, match="tile_h"):
        tkl.run_p4(cur, ref_p, tile_h=48)
    with pytest.raises(ValueError, match="tile_h"):
        tkl.run_phase(cur, ref_p, variant="P0", tile_h=12)
    with pytest.raises(ValueError, match="cover"):
        tkl.run_p4(cur, ref_p[:80], tile_h=64)
    with pytest.raises(ValueError, match="mix"):
        tvp.run(cur, mix="add", chain=1)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mix", ["fma", "mix", "roll"])
def test_peak_kernel_matches_plain_cuda(cuda, mix):
    a = tvp.check_input(mix, 16, 256).to(cuda)
    before = lab.lab_peak.launches
    got = lab.lab_peak(a, mix=mix, inner=tvp.INNER, outer=tvp.CHECK_OUTER)
    assert lab.lab_peak.launches == before + 1
    want = lab.peak_plain(a, mix, inner=tvp.INNER, outer=tvp.CHECK_OUTER)
    assert _peak_rel(got.cpu().numpy(), want.cpu().double().numpy()) <= (
        tvp.CHECK_TOL[mix])


def test_chain_kernel_matches_plain_cuda(cuda):
    c, e = (t.to(cuda) for t in tvp.chain_inputs(ch_w=256))
    got = lab.lab_chain(c, e, ch_g=tvp.CH_G)
    assert torch.equal(got, lab.chain_plain(c, e, ch_g=tvp.CH_G))


@pytest.mark.parametrize("tile_h", [8, 64, 128])
@pytest.mark.parametrize("sad", [False, True])
def test_lab_kernels_match_plain_cuda(cuda, tile_h, sad):
    cur, ref_p = (t.to(cuda) for t in _torch(*tkl.make_inputs(
        1, height=128, width=200)))
    got = lab.lab_phase(cur, ref_p, tile_h=tile_h, sad=sad)
    want = lab.phase_plain(cur, ref_p, sad=sad)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = lab.lab_diff(cur, ref_p, tile_h=tile_h, sad=sad)
    assert torch.equal(got, lab.diff_plain(cur, ref_p, sad=sad))
