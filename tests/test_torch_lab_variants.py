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

`kernel_turns.LAB_GROUPS`, the A/B cells of L1, the key and cross
variants and P1, name variants and mixes the wrappers take, and each key
variant (`kern_lab.KEY_VARIANTS`) gives the diff form's or SAD's key. The
plain versions of the key and of "P3A" ignore the reference's halo
(`kern_lab.check_inputs` fills it with NaN, 1e9 and -7.5), and
`bench/roofline.lab_bound` counts the key kernel's arithmetic over the
valid candidates (over all of them for "P3B", which masks nothing).

Tests whose names end in `_cuda` hold each new CUDA kernel against its
plain version on the card (L1 on frames whose last CUDA block is partial,
constant frames, and through `kern_lab.run_variant` with a `chunk` other
than 5, which changes nothing; the key kernel's sixteen variants, L2-L7,
on frames with partial CUDA blocks, garbage halos, ties and the wrapping
key, "P3B" on the zero halo) and skip where there is none:
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

from motionestimation_tpu_torch.bench import roofline
from motionestimation_tpu_torch.kernels import lab_cuda as lab
from motionestimation_tpu_torch.tools import kern_lab as tkl
from motionestimation_tpu_torch.tools import kernel_turns, sass_loops
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


def test_lab_groups_name_the_wrappers_variants():
    """Each cell of `kernel_turns.LAB_GROUPS` names a tool and size the
    timing reads, and entries that `kern_lab.variant_fn` (L1's, the key
    and the cross variants) or `lab_peak` take; the L1 cells take every L1
    variant, the key cells every key variant at tile_h 128 and L4's at
    64, the cross cells every cross variant at 128 and L2's at 64; the
    occupancy query refuses a name no instance has before it touches a
    card."""
    kinds = {"lab L1": lab.PADDED_VARIANTS, "lab key": tkl.KEY_VARIANTS,
             "lab cross": tkl.CROSS_VARIANTS}
    cells = {}  # (kind, tile_h) -> its variants
    for label, tool, entries in kernel_turns.LAB_GROUPS:
        name, size = tool.split()
        assert name in ("kern_lab", "vpu_peak") and int(size) > 0, label
        known = ((*lab.PADDED_VARIANTS, *tkl.KEY_VARIANTS,
                  *tkl.CROSS_VARIANTS) if name == "kern_lab" else lab.MIXES)
        assert entries and set(entries) <= set(known), label
        if name == "kern_lab":
            assert tkl.H % int(size) == 0 and int(size) % BLK == 0
            kind = next(k for k, vs in kinds.items() if set(entries) <= set(vs))
            assert label.startswith(kind), label
            cells.setdefault((kind, int(size)), set()).update(entries)
    assert cells == {
        ("lab L1", 128): set(lab.PADDED_VARIANTS),
        ("lab L1", 64): set(lab.PADDED_VARIANTS),
        ("lab key", 128): set(tkl.KEY_VARIANTS), ("lab key", 64): {"P4", "P4S"},
        ("lab cross", 128): set(tkl.CROSS_VARIANTS),
        ("lab cross", 64): {"P0", "P1"}}
    with pytest.raises(ValueError):
        lab.lab_occupancy("Q1")


@pytest.mark.parametrize("variant", tkl.KEY_VARIANTS)
def test_key_variants_give_the_diff_form_or_sad(lab_inputs, variant):
    """`kern_lab.variant_fn` of each key variant gives L4's key: SAD's
    where "S" is in the name, the diff form's otherwise, as the card checks
    (chip_smoke.py, the `_cuda` tests below) assume."""
    cur, ref_p = _torch(*lab_inputs)
    got = tkl.variant_fn(f"{variant}:64")[0](cur, ref_p)
    assert torch.equal(got, lab.diff_plain(cur, ref_p, sad="S" in variant))


@pytest.mark.parametrize("variant", [*tkl.KEY_VARIANTS, *tkl.CROSS_VARIANTS])
def test_key_plain_is_the_wrappers_plain_version(lab_inputs, variant):
    """`kern_lab.key_plain`, which the card checks (chip_smoke.py, the
    `_cuda` tests below) hold each kernel against, is what the variant's
    wrapper computes on the CPU, where it runs its plain version."""
    cur, ref_p = _torch(*lab_inputs)
    got = tkl.variant_fn(f"{variant}:64")[0](cur, ref_p)
    want = tkl.key_plain(variant, cur, ref_p)
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want) == (2 if variant in ("P0", "P1") else 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- the key kernel's inputs and bound ----------------------------------------

@pytest.mark.parametrize("sad", [False, True])
def test_diff_plain_ignores_the_halo(sad):
    """The key's plain version reads only the frame: the same keys for a
    zero halo and one of NaN, 1e9 and -7.5 (`kern_lab.check_inputs`)."""
    zero = _torch(*tkl.make_inputs(3, height=40, width=72))
    garbage = _torch(*tkl.check_inputs(3, height=40, width=72))
    assert torch.equal(zero[0], garbage[0])
    assert bool(torch.isnan(garbage[1]).any())
    assert torch.equal(lab.diff_plain(*zero, sad=sad),
                       lab.diff_plain(*garbage, sad=sad))


@pytest.mark.parametrize("content", tkl.CHECK_CONTENTS)
def test_nochain_plain_ignores_the_halo(content):
    """"P3A"'s plain version reads only the frame too: the same keys for
    `kern_lab.check_inputs`' halo of NaN, 1e9 and -7.5 and for the zero
    halo around the same frame (`kern_lab.zero_halo`)."""
    cur, garbage = _torch(*tkl.check_inputs(3, height=40, width=72,
                                            content=content))
    zero = tkl.zero_halo(garbage, height=40, width=72)
    assert bool(torch.isnan(garbage).any()) and not bool(torch.isnan(zero).any())
    assert torch.equal(lab.nochain_plain(cur, zero),
                       lab.nochain_plain(cur, garbage))


@pytest.mark.parametrize("content", tkl.CHECK_CONTENTS)
def test_check_inputs_contents(content):
    """Integer frames inside a halo of exactly HALO_FILL's values; "tie"
    costs every candidate alike (each block's key is its first valid
    candidate's flat index), "wrap" gives the largest cost, whose
    cost * 625 passes 2^31 and wraps in int32."""
    h, w = 24, 40
    cur, ref_p = tkl.check_inputs(1, height=h, width=w, content=content)
    frame = ref_p[SPAN : SPAN + h, SPAN : SPAN + w]
    for x in (cur, frame):
        assert ((x >= 0) & (x <= 255) & (x == np.round(x))).all()
    outside = np.ones(ref_p.shape, bool)
    outside[SPAN : SPAN + h, SPAN : SPAN + w] = False
    halo = ref_p[outside]
    assert np.isnan(halo).any()
    assert {float(v) for v in halo[~np.isnan(halo)]} == {1e9, -7.5}
    key = lab.diff_plain(*_torch(cur, ref_p)).numpy().astype(np.int64)
    if content == "random":
        return
    # A block's first valid candidate: offset max(0, 12 - 8b) on each axis.
    first = np.maximum(0, SPAN - BLK * np.arange(h // BLK))[:, None] * K \
        + np.maximum(0, SPAN - BLK * np.arange(w // BLK))[None]
    cost = 0 if content == "tie" else BLK * BLK * 255 ** 2
    assert (key == cost * K * K + first - 2**31).all()
    if content == "wrap":
        assert cost * K * K > 2**31 - 1


# Valid block-candidates at 2048x2048 8x8 +-12: 6,368 a block row or column
# (25 a block but 12 + 4 fewer at each end).
VALID_2048 = 6368 ** 2
LAB_BOUNDS = [  # (variant, instructions a block-candidate, lanes, masked,
    #              what bounds it)
    *[(v, 32, 128, True, "operations") for v in ("P4", "P5", "P5B", "P7")],
    *[(v, 16, 64, True, "operations")
      for v in ("P4S", "P5S", "P5SB", "P7S", "P3S", "P1")],
    *[(v, 16, 64, True, "operations") for v in ("P0", "P3", "P6", "P6B")],
    ("P3B", 16, 64, False, "operations"),
    ("P3A", 4, 64, True, "bytes"),
    *[(v, 16, 64, False, "operations") for v in ("L0", "M1", "M2")],
    ("M3", 128, 128, False, "operations"),
]


@pytest.mark.parametrize("variant,ops,lanes,masked,by", LAB_BOUNDS,
                         ids=[v for v, *_ in LAB_BOUNDS])
def test_lab_bound_counts_the_arithmetic(variant, ops, lanes, masked, by):
    """`roofline.lab_bound` at 2048x2048 on 132 SMs at 1980 MHz: the
    variant's instructions over the block-candidates its function needs
    (the valid ones for the key and L2: 0.0388 ms for the diff form, whose
    two instructions a word count against the SM's 128 lanes of issue, for
    SAD and for the cross term; all 625 a block for L1 and "P3B", which
    keeps the ring live at every offset), or its bytes where they take
    longer ("P3A", no ring: 4 integer instructions a candidate)."""
    cands = VALID_2048 if masked else 256 * 256 * K * K
    want = cands * ops / (132 * lanes * 1980e6) * 1e3
    ops_ms, bytes_ms = roofline.lab_parts(variant, 2048, 2048, 132, 1980)
    assert ops_ms == pytest.approx(want, rel=1e-12)
    ms, got_by = roofline.lab_bound(variant, 2048, 2048, 132, 1980)
    assert got_by == by and (want > bytes_ms) == (by == "operations")
    assert ms == max(ops_ms, bytes_ms)
    expected = {"P4": 0.038789, "P4S": 0.038789, "L0": 0.039180,
                "M3": 0.156719, "P0": 0.038789, "P3": 0.038789,
                "P3B": 0.039180, "P3A": 0.010213}
    if variant in expected:
        assert round(ms, 6) == expected[variant]


def test_lab_bound_of_the_unmasked_nop_is_its_bytes():
    """NOP and "L1" do (next to) no arithmetic: their bound is their
    float32 operands and outputs once, 0.010291 ms at 2048x2048; the
    key variants write half the output bytes, L2's (cost, idx) as many as
    L1."""
    for v in ("NOP", "L1"):
        ms, by = roofline.lab_bound(v, 2048, 2048, 132, 1980)
        assert by == "bytes" and round(ms, 6) == 0.010291
    for v, out_bytes in (("P4", 4), ("P3B", 4), ("P0", 8), ("P1", 8)):
        assert roofline.lab_parts(v, 2048, 2048, 132, 1980)[1] == (
            pytest.approx((4 * (2048 ** 2 + 2072 ** 2)
                           + out_bytes * 256 ** 2) / 3.35e12 * 1e3))
    with pytest.raises(KeyError):
        roofline.lab_bound("P2", 2048, 2048, 132, 1980)


def test_sass_loops_matches_anonymous_namespace_kernels_across_builds():
    """lab.cu's kernels live in an anonymous namespace whose mangled name
    carries a per-build hash: `sass_loops --against` matches them without
    it, so a kernel whose code is unchanged reads as identical."""
    a = "_ZN38_GLOBAL__N__6a1122e9_6_lab_cu"
    b = "_ZN38_GLOBAL__N__82561dd2_6_lab_cu"
    ours = {a + "_bcbd64cf4peakEv": [(0, "EXIT")],
            a + "_bcbd64cf4rollEv": [(0, "NOP")]}
    theirs = {b + "_bcbd64cf4peakEv": [(0, "EXIT")],
              b + "_bcbd64cf4rollEv": [(0, "EXIT")]}
    assert sass_loops.same_code(ours, theirs) == {
        "_ZN38_GLOBAL__N__6_lab_cu_bcbd64cf4peakEv": True,
        "_ZN38_GLOBAL__N__6_lab_cu_bcbd64cf4rollEv": False}


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


def _constant_inputs(height, width, cur_value, ref_value):
    """cur all `cur_value`, the reference all `ref_value` inside its zero
    halo."""
    cur, ref_p = tkl.make_inputs(0, height=height, width=width)
    cur[:] = cur_value
    ref_p[:] = 0
    ref_p[SPAN : SPAN + height, SPAN : SPAN + width] = ref_value
    return cur, ref_p


# (frames, tile_h, chunk). L1's CUDA blocks take 4 x 8 macroblocks: 128x200
# leaves a last block column of one macroblock, 168x200 also a last block
# row of one. Constant frames: 255 against 0 and 0 against 255 give the
# largest costs (64 * 255^2), 255 against 255 products of 65,025 that M3
# rounds, 7 against 37 products of 259, a tie that M3 rounds to even
# (260); the zero halo gives the other offsets their costs.
PADDED_CARD_CASES = [
    ("edge 128x200", 8, 5), ("edge 128x200", 64, 5),
    ("edge 128x200", 128, 5), ("edge 128x200", 128, 3),
    ("random 168x200", 56, 5), ("random 168x200", 8, 7),
    ("constant 255 0", 64, 5), ("constant 0 255", 64, 5),
    ("constant 255 255", 64, 5), ("constant 7 37", 128, 5),
]


def _padded_card_frames(name):
    if name == "edge 128x200":
        return _edge_inputs(1, 128, 200)
    if name == "random 168x200":
        return tkl.make_inputs(2, height=168, width=200)
    return _constant_inputs(128, 200, *map(int, name.split()[1:]))


@pytest.mark.parametrize("frames,tile_h,chunk", PADDED_CARD_CASES)
def test_padded_kernel_matches_plain_cuda(cuda, frames, tile_h, chunk):
    cur, ref_p = (t.to(cuda) for t in _torch(*_padded_card_frames(frames)))
    plains = {"NOP": lab.nop_plain(cur, ref_p),
              "L0": lab.padded_plain(cur, ref_p),
              "L1": lab.raw_plain(cur, ref_p, tile_h=tile_h),
              "M1": lab.padded_plain(cur, ref_p),
              "M2": lab.padded_plain(cur, ref_p, sad=True),
              "M3": lab.padded_plain(cur, ref_p, rounding=True)}
    for variant, want in plains.items():
        before = lab.lab_padded.launches
        got = tkl.run_variant(cur, ref_p, variant=variant, tile_h=tile_h,
                              chunk=chunk)
        assert lab.lab_padded.launches == before + 1
        assert all(torch.equal(a, b) for a, b in zip(got, want)), variant
    if frames == "constant 7 37":  # every product a tie: M3 is not L0
        assert not torch.equal(plains["M3"][0], plains["L0"][0])


# The key wrappers' card frames: (frames, tile_h), "edge" the 128x200 pair
# with cur's top-left block 0 against a zero halo, or (content, h, w) from
# `kern_lab.check_inputs` in a halo of NaN, 1e9 and -7.5. The key kernel's
# CUDA blocks take 4 x 8 macroblocks, so 24x24 is one partial block, 40x72
# a partial last row and column of blocks, 128x2040 a last column of 7
# macroblocks.
KEY_CARD_CASES = [
    *[pytest.param("edge", t, id=str(t)) for t in (8, 64, 128)],
    *[pytest.param((c, h, w), t, id=f"{c}-{h}x{w}-{t}")
      for h, w, t in [(24, 24, 8), (40, 72, 8), (128, 2040, 8),
                      (128, 2040, 64), (128, 2040, 128)]
      for c in tkl.CHECK_CONTENTS],
]


# The wrapper that each key or cross variant launches, by its first two
# characters.
KEY_WRAPPERS = {"P0": lab.lab_phase, "P1": lab.lab_phase, "P3": lab.lab_p3,
                "P4": lab.lab_diff, "P5": lab.lab_p5, "P6": lab.lab_p6,
                "P7": lab.lab_p7}


@pytest.mark.parametrize("variant", [*tkl.KEY_VARIANTS, *tkl.CROSS_VARIANTS])
@pytest.mark.parametrize("frames,tile_h", KEY_CARD_CASES)
def test_key_kernels_match_plain_cuda(cuda, frames, tile_h, variant):
    """Each key or cross variant (`kern_lab.variant_fn`, on
    `lab_key_kernel`), one launch of its wrapper a call, equal to its plain
    version (`kern_lab.key_plain`: L4's key by the diff form or SAD, L2's
    (cost, idx), the ablations') on every frame pair: random pixels, ties
    (one value in both frames) and the wrapping key (cur 255 against ref
    0) in the garbage halo, "P3B", which masks nothing, in the zero halo
    around the same frame."""
    if frames == "edge":
        cur, ref_p = _card_inputs(cuda)
        h, w = cur.shape
    else:
        c, h, w = frames
        cur, ref_p = (t.to(cuda) for t in _torch(*tkl.check_inputs(
            h + w, height=h, width=w, content=c)))
    if variant == "P3B":
        ref_p = tkl.zero_halo(ref_p, height=h, width=w)
    wrapper = KEY_WRAPPERS[variant[:2]]
    before = wrapper.launches
    got = tkl.variant_fn(f"{variant}:{tile_h}")[0](cur, ref_p)
    assert wrapper.launches == before + 1
    want = tkl.key_plain(variant, cur, ref_p)
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
