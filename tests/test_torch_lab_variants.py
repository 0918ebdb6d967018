"""The rest of the port's full-search lab vs the JAX repo's `tools/kern_lab.py`.

L1 (`make_kernel`: "NOP", "L0", "L1", "M1", "M2", "M3"), L3
(`make_p3_kernel`: "P3", "P3S", "P3A", "P3B"), L5 ("P5", "P5S", "P5B",
"P5SB"), L6 ("P6", "P6B") and L7 ("P7", "P7S"). The JAX tool is loaded by
file path with small globals and `pallas_call` in interpret mode, as
`tests/test_torch_lab.py` loads it (nothing under `tools/` changes). The
same numpy inputs (256x256 8x8 +-12, random pixels, the reference
zero-padded, the top-left block of cur set to 0) go through the JAX kernel
and the port's wrapper on the CPU (its plain version); every output is
exact at every block start. The zero block's best offset is (-12, -12),
wholly outside the frame, so L0, M1 and M2 are also held to the JAX
kernel's unmasked edges there.

Two variants have no JAX oracle, for reasons of the TPU kernel:

* "M3" is L0 with a DEFAULT-precision block-sum matmul. On the TPU that
  rounds each product to bfloat16; interpret mode on the CPU runs the
  matmul in float32, so there M3 equals L0 and says nothing of the
  rounding. The port defines M3 as each product rounded to bfloat16 (to
  nearest even), then an exact sum; it is held against numpy with
  `ml_dtypes.bfloat16`, and shown to differ from L0.
* "P3A" (`nochain`) reads 24 of the 25 dy groups of its chain buffer
  unwritten; interpret mode fills float scratch with NaN, so its output
  means nothing. The port defines those rows as 0
  (`lab_cuda.nochain_plain`); it is held against numpy on that
  definition only.

Tests whose names end in `_cuda` hold each new CUDA kernel against its
plain version on the card and skip where there is none:
`python -m pytest --noconftest tests/test_torch_lab_variants.py -k cuda`.
"""
import contextlib
import io
import sys

import ml_dtypes
import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view

from motionestimation_tpu_torch.kernels import lab_cuda as lab
from motionestimation_tpu_torch.tools import kern_lab as tkl
from test_torch_lab import LAB_SIZE, _last_outputs, _load_tool, _torch

torch.set_num_threads(1)

K, SPAN, BLK = tkl.K, tkl.SPAN, tkl.BLK


@pytest.fixture(scope="module")
def jax_lab():
    return _load_tool("kern_lab", H=LAB_SIZE, W=LAB_SIZE, CHAIN=1)


def _edge_inputs(seed, height, width):
    """make_inputs with cur's top-left block 0: against the zero halo, its
    first candidate (-12, -12) has SSD and SAD 0."""
    cur, ref_p = tkl.make_inputs(seed, height=height, width=width)
    cur[:BLK, :BLK] = 0
    return cur, ref_p


@pytest.fixture(scope="module")
def lab_inputs():
    return _edge_inputs(0, LAB_SIZE, LAB_SIZE)


# -- L1 ------------------------------------------------------------------------

@pytest.mark.parametrize("variant,tile_h", [
    ("NOP", 128), ("L0", 64), ("L0", 128), ("L1", 128), ("M1", 128),
    ("M2", 128),
])
def test_padded_matches_jax(jax_lab, lab_inputs, variant, tile_h):
    cur, ref_p = lab_inputs
    want_cost, want_idx = _last_outputs(jax_lab, jax_lab.run_variant(
        cur, ref_p, variant=variant, tile_h=tile_h, chunk=5))
    launches = lab.lab_padded.launches
    cost, idx = tkl.run_variant(*_torch(cur, ref_p), variant=variant,
                                tile_h=tile_h)
    assert lab.lab_padded.launches == launches  # plain versions never count
    assert cost.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(cost.numpy(), want_cost[:, ::8])
    np.testing.assert_array_equal(idx.numpy(), want_idx[:, ::8])
    if variant in ("L0", "M1", "M2"):
        # The zero block's best candidate lies wholly outside the frame.
        assert (float(cost[0, 0]), int(idx[0, 0])) == (0.0, 0)


def _m3_numpy(cur, ref_p):
    """M3 by numpy: products rounded to ml_dtypes.bfloat16, exact sums,
    (Qcur - X) + (Qref - X), first minimum over all 625 unmasked offsets."""
    h, w = cur.shape
    c = cur.astype(np.float64)
    win = ref_p[: h + 2 * SPAN, : w + 2 * SPAN].astype(np.float64)

    def blocks(x):
        return x.reshape(*x.shape[:-2], h // BLK, BLK, w // BLK, BLK).sum(
            (-3, -1))

    qcur = blocks(c * c)
    box = sliding_window_view(win * win, (BLK, BLK)).sum((-2, -1))
    best = np.full((h // BLK, w // BLK), np.inf)
    for oy in range(K):
        for ox in range(K):
            e = win[oy : oy + h, ox : ox + w]
            prod = (c * e).astype(np.float32).astype(ml_dtypes.bfloat16)
            x = blocks(prod.astype(np.float64))
            qref = box[oy : oy + h : BLK, ox : ox + w : BLK]
            key = ((qcur - x) + (qref - x)) * K * K + oy * K + ox
            best = np.minimum(best, key)
    cost = np.floor(best / (K * K))
    return cost.astype(np.float32), (best - cost * K * K).astype(np.int32)


def test_m3_rounds_products_to_bf16(lab_inputs):
    cur = lab_inputs[0][:64]  # 64 rows keep numpy quick
    ref_p = lab_inputs[1][: 64 + 2 * SPAN]
    want_cost, want_idx = _m3_numpy(cur, ref_p)
    cost, idx = tkl.run_variant(*_torch(cur, ref_p), variant="M3", tile_h=64)
    np.testing.assert_array_equal(cost.numpy(), want_cost)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    # The rounding moves costs: M3 is not L0.
    l0_cost, _ = tkl.run_variant(*_torch(cur, ref_p), variant="L0", tile_h=64)
    assert bool((cost != l0_cost).any())


# -- L3, L5, L6, L7 ------------------------------------------------------------

KEY_CASES = [  # (variant, tile_h, JAX runner, its keywords)
    ("P3", 64, "run_p3", dict(sad=False, ablate=None)),
    ("P3", 128, "run_p3", dict(sad=False, ablate=None)),
    ("P3S", 128, "run_p3", dict(sad=True, ablate=None)),
    ("P3B", 128, "run_p3", dict(sad=False, ablate="nofold")),
    ("P5", 128, "run_p5", dict(sad=False, bf16=False)),
    ("P5S", 128, "run_p5", dict(sad=True, bf16=False)),
    ("P5B", 128, "run_p5", dict(sad=False, bf16=True)),
    ("P5SB", 128, "run_p5", dict(sad=True, bf16=True)),
    ("P6", 128, "run_p6", dict(bf16=False)),
    ("P6B", 128, "run_p6", dict(bf16=True)),
    ("P7", 128, "run_p7", dict(sad=False)),
    ("P7S", 128, "run_p7", dict(sad=True)),
]


@pytest.mark.parametrize("variant,tile_h,runner,kw", KEY_CASES,
                         ids=[f"{v}-{t}" for v, t, _, _ in KEY_CASES])
def test_key_variants_match_jax(jax_lab, lab_inputs, variant, tile_h, runner,
                                kw):
    cur, ref_p = lab_inputs
    (want,) = _last_outputs(jax_lab, getattr(jax_lab, runner)(
        cur, ref_p, tile_h=tile_h, nchain=1, **kw))
    fn, decode = tkl.variant_fn(f"{variant}:{tile_h}")
    key = fn(*_torch(cur, ref_p))
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy(), want[:, ::8])
    if variant != "P3B":  # every other key variant is L4's key
        sad = kw.get("sad", False)
        assert torch.equal(key, lab.diff_plain(*_torch(cur, ref_p), sad=sad))


def test_p3a_matches_its_definition(lab_inputs):
    cur, ref_p = lab_inputs
    h, w = cur.shape
    c = cur.astype(np.int64)
    win = ref_p[: h + 2 * SPAN, : w + 2 * SPAN].astype(np.int64)
    qcur = (c * c).reshape(h // BLK, BLK, w // BLK, BLK).sum((1, 3))
    box = sliding_window_view(win * win, (BLK, BLK)).sum((-2, -1))
    first = sliding_window_view(win, BLK, axis=1)  # [h + 24, w + 17, 8]
    best = np.full((h // BLK, w // BLK), 2**32 - 1, np.int64)
    ty, tx = np.arange(0, h, BLK), np.arange(0, w, BLK)
    crow = c[ty].reshape(h // BLK, w // BLK, BLK)
    for oy in range(K):
        for ox in range(K):
            ok = (((ty + oy - SPAN >= 0) & (ty + oy - SPAN <= h - BLK))[:, None]
                  & ((tx + ox - SPAN >= 0) & (tx + ox - SPAN <= w - BLK)))
            x = ((crow * first[ty][:, tx + ox]).sum(-1) if oy == 0 else 0)
            cost = qcur + box[ty + oy][:, tx + ox] - 2 * x
            u = (cost * K * K + oy * K + ox) % 2**32
            best = np.where(ok, np.minimum(best, u), best)
    key = tkl.run_p3(*_torch(cur, ref_p), tile_h=128, ablate="nochain")
    np.testing.assert_array_equal(key.numpy(), (best - 2**31).astype(np.int32))


# -- the CLI's routing ---------------------------------------------------------

SPECS = ["NOP", "L1:128:5", "M3:64:3", "P0", "P1:64", "P2", "P3", "P3S",
         "P3A", "P3B", "P3X", "P3SB", "P4", "P4S", "P4X", "P5", "P5S", "P5B",
         "P5SB", "P5BS", "P6", "P6B", "P6S", "P6SB", "P7", "P7S", "P7B"]
RUNNERS = ("run_variant", "run_phase", "run_p3", "run_p4", "run_p5",
           "run_p6", "run_p7")


def test_names_route_as_jax_main(jax_lab, monkeypatch):
    """Each spec reaches the same runner with the same keywords through the
    JAX tool's `main` and the port's `variant_fn` ("P6S" is SSD, "P3X" is
    P3, "L1:128:5" is accepted)."""
    routes = {"jax": [], "port": []}

    def recorder(side, name):
        def run(cur, ref_p, **kw):
            routes[side].append((name, kw))
            return 0.0
        return run

    for name in RUNNERS:
        monkeypatch.setattr(jax_lab, name, recorder("jax", name))
        monkeypatch.setattr(tkl, name, recorder("port", name))
    monkeypatch.setattr(sys, "argv", ["kern_lab.py", *SPECS])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        jax_lab.main()
    assert "FAILED" not in out.getvalue()
    for spec in SPECS:
        fn, _ = tkl.variant_fn(spec)
        fn(None, None)
    # JAX's main calls each runner 1 + REPS = 4 times; the port's once.
    assert routes["jax"][::4] == routes["port"]
    assert len(routes["jax"]) == 4 * len(SPECS)
    assert dict(zip(SPECS, routes["port"]))["P6S"] == ("run_p6",
                                                       dict(tile_h=128,
                                                            bf16=False))
    with pytest.raises(ValueError):
        tkl.variant_fn("Q1")


def test_variant_operand_checks():
    cur, ref_p = _torch(*tkl.make_inputs(0, height=64, width=64))
    with pytest.raises(ValueError, match="chunk"):
        tkl.run_variant(cur, ref_p, variant="L0", tile_h=64, chunk=0)
    with pytest.raises(ValueError, match="ablate"):
        tkl.run_p3(cur, ref_p, tile_h=64, sad=True, ablate="nofold")
    with pytest.raises(ValueError, match="tile_h"):
        tkl.run_p6(cur, ref_p, tile_h=24)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(cuda):
    return tuple(t.to(cuda) for t in _torch(*_edge_inputs(1, 128, 200)))


@pytest.mark.parametrize("tile_h", [8, 64, 128])
def test_padded_kernel_matches_plain_cuda(cuda, tile_h):
    cur, ref_p = _card_inputs(cuda)
    plains = {"NOP": lab.nop_plain(cur, ref_p),
              "L0": lab.padded_plain(cur, ref_p),
              "L1": lab.raw_plain(cur, ref_p, tile_h=tile_h),
              "M1": lab.padded_plain(cur, ref_p),
              "M2": lab.padded_plain(cur, ref_p, sad=True),
              "M3": lab.padded_plain(cur, ref_p, rounding=True)}
    for variant, want in plains.items():
        before = lab.lab_padded.launches
        got = lab.lab_padded(cur, ref_p, tile_h=tile_h, variant=variant)
        assert lab.lab_padded.launches == before + 1
        assert all(torch.equal(a, b) for a, b in zip(got, want)), variant


@pytest.mark.parametrize("tile_h", [8, 64, 128])
def test_key_kernels_match_plain_cuda(cuda, tile_h):
    cur, ref_p = _card_inputs(cuda)
    diff = {sad: lab.diff_plain(cur, ref_p, sad=sad) for sad in (False, True)}
    cases = [
        (lab.lab_p3, dict(), diff[False]),
        (lab.lab_p3, dict(sad=True), diff[True]),
        (lab.lab_p3, dict(ablate="nochain"), lab.nochain_plain(cur, ref_p)),
        (lab.lab_p3, dict(ablate="nofold"), lab.nofold_plain(cur, ref_p)),
        *[(lab.lab_p5, dict(sad=s, bf16=b), diff[s])
          for s in (False, True) for b in (False, True)],
        *[(lab.lab_p6, dict(bf16=b), diff[False]) for b in (False, True)],
        *[(lab.lab_p7, dict(sad=s), diff[s]) for s in (False, True)],
    ]
    for fn, kw, want in cases:
        before = fn.launches
        got = fn(cur, ref_p, tile_h=tile_h, **kw)
        assert fn.launches == before + 1
        assert torch.equal(got, want), (fn.__name__, kw)
