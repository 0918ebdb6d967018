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
* P2: exact (every value an integer below 2^24) at widths 128 and 37, and
  the chain without any one dy row or term differs from it;
* P1 per mix, within 1e-5 relative (the two sides round multiply and add
  in their own places), on inputs where one step fewer of any chain moves
  the result far past that tolerance;
* `vpu_peak.roll_adds`, the adds the roll mix executes, against a count of
  the adds of the JAX tool's roll loop run on numpy;
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


# 37: a width that is not a multiple of a warp's 32 lanes.
@pytest.mark.parametrize("ch_w", [CH_W, 37])
def test_chain_matches_jax(jax_peak, ch_w):
    jax_tool = (jax_peak if ch_w == CH_W
                else _load_tool("vpu_peak", CH_W=ch_w, **PEAK))
    c, e = tvp.chain_inputs(ch_w=ch_w)
    (want,) = _last_outputs(jax_tool, jax_tool.run_chain(c.numpy(), e.numpy()))
    assert want.shape == (tvp.CH_G, ch_w)
    got = tvp.run_chain(c, e, chain=1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_chain_check_sees_each_dy_and_term():
    """On the tool's inputs at width 256 the chain with any one of its 25
    dy rows, or any one of its 8 terms, left out differs from the full
    chain in some element, so the card's exact check of P2 against
    `chain_plain` cannot pass a kernel that drops a share of either."""
    c, e = tvp.chain_inputs(ch_w=256)
    g, w = tvp.CH_G, 256
    windows = e.reshape(tvp.CH_BLK + tvp.CH_K - 1, g, w).unfold(
        0, tvp.CH_BLK, 1).permute(0, 3, 1, 2)           # [K, BLK, g, w]
    terms = (c.reshape(tvp.CH_BLK, g, w)[None] - windows) ** 2
    rows = terms.sum(1)                                   # [K, g, w]
    full = rows.amin(0)
    assert torch.equal(full, lab.chain_plain(c, e, ch_g=g))
    for dy in range(tvp.CH_K):
        without = torch.cat([rows[:dy], rows[dy + 1:]]).amin(0)
        assert not torch.equal(without, full), dy
    for r in range(tvp.CH_BLK):
        without = (rows - terms[:, r]).amin(0)
        assert not torch.equal(without, full), r


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


def test_roll_adds_counts_the_jax_loop():
    """The JAX tool's roll kernel body run on numpy (its `pltpu.roll` a
    counting np.roll, `lax.fori_loop` a Python loop): the adds that take a
    rolled operand number `vpu_peak.roll_adds` at the tool's INNER and
    other shapes, half the JAX tool's own count (`peak_ops`), and the
    result is the plain version's."""
    import types

    class Rolled(np.ndarray):
        adds = 0

        def __radd__(self, other):
            Rolled.adds += self.size
            return np.add(other, self.view(np.ndarray))

    for rows, cols, inner, outer in ((4, 128, tvp.INNER, 3), (2, 32, 24, 2)):
        mod = _load_tool("vpu_peak", ROWS=rows, COLS=cols, INNER=inner,
                         OUTER=outer)
        mod.pltpu = types.SimpleNamespace(
            roll=lambda x, shift, axis: np.roll(x, shift, axis).view(Rolled))

        def fori_loop(lo, hi, body, carry):
            for i in range(lo, hi):
                carry = body(i, carry)
            return carry

        mod.lax = types.SimpleNamespace(fori_loop=fori_loop)
        a = tvp.check_input("roll", rows, cols).numpy()
        out, scratch = np.zeros_like(a), np.zeros_like(a)
        Rolled.adds = 0
        mod.make_kernel("roll")(a, out, scratch)
        assert Rolled.adds == tvp.roll_adds(rows, cols, inner, outer)
        np.testing.assert_array_equal(out, lab.peak_plain(
            torch.from_numpy(a), "roll", inner=inner, outer=outer).numpy())
    assert tvp.peak_ops() == 2 * tvp.roll_adds()


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


# fma and mix at one shape; roll at a warp a row (32 and 64 columns), rows
# of several warps (96, 256 and 1024 columns) and 1 to 512 rows.
PEAK_CARD_CASES = [("fma", 16, 256), ("mix", 16, 256), ("roll", 16, 256),
                   ("roll", 1, 96),
                   *(("roll", r, c) for r in (1, 64, 512)
                     for c in (32, 64, 1024))]


@pytest.mark.parametrize("mix,rows,cols", PEAK_CARD_CASES)
def test_peak_kernel_matches_plain_cuda(cuda, mix, rows, cols):
    a = tvp.check_input(mix, rows, cols).to(cuda)
    before = lab.lab_peak.launches
    got = lab.lab_peak(a, mix=mix, inner=tvp.INNER, outer=tvp.CHECK_OUTER)
    assert lab.lab_peak.launches == before + 1
    want = lab.peak_plain(a, mix, inner=tvp.INNER, outer=tvp.CHECK_OUTER)
    assert _peak_rel(got.cpu().numpy(), want.cpu().double().numpy()) <= (
        tvp.CHECK_TOL[mix])


# (G, w): the JAX tool's shape, the width chip_smoke.py fills the card at,
# a width past a multiple of a CUDA block's 128 threads, one g row, and
# one element a row.
@pytest.mark.parametrize("g,w", [(8, 2048), (8, 65536), (8, 4100), (1, 33),
                                 (3, 1)])
def test_chain_kernel_matches_plain_cuda(cuda, g, w):
    rng = np.random.default_rng(g * w)
    c, e = (torch.from_numpy(rng.integers(0, 256, (n * g, w)).astype(
        np.float32)).to(cuda) for n in (tvp.CH_BLK, tvp.CH_BLK + tvp.CH_K - 1))
    before = lab.lab_chain.launches
    got = lab.lab_chain(c, e, ch_g=g)
    assert lab.lab_chain.launches == before + 1
    assert torch.equal(got, lab.chain_plain(c, e, ch_g=g))


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
