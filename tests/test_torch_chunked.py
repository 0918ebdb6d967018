"""The port's MSE routes outside the phase kernel vs the JAX package.

`full_search_frame_cuda(device="cpu")` against
`full_search_frame_pallas(interpret=True)` with the same `phase` and
`operand_bf16`, on the configs the JAX package sends to `_kernel_f32` (K5),
`_kernel_f32_bf16` (K6) and `_kernel_f32_wide` (K7), with the int kernel on
the truncated edge slabs: equal MVs, int32 costs and float32 scores, dtypes
included. On the CPU the wrappers run their plain versions and count no
launch. The interior tiles of the new wrappers are held against the JAX
interior as well. Every in-turns group of `tools/kernel_turns.py` names
wrappers that take the keywords the tool passes.

Tests whose names end in `_cuda` compare each CUDA kernel with its plain
version on the card, exactly, and skip where there is none:
`python -m pytest --noconftest tests/test_torch_chunked.py -k cuda`.
"""
import inspect

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from motionestimation_tpu.kernels import full_search_pallas as kp
from motionestimation_tpu_torch.kernels import full_search_cuda as kc
from motionestimation_tpu_torch.search import full_search as tfs
from motionestimation_tpu_torch.tools import kernel_turns, sass_loops

# The tests run in several worker processes on shared cores; one torch
# thread per worker keeps them from oversubscribing the machine.
torch.set_num_threads(1)

WRAPPERS = (kc.phase_search, kc.int_search, kc.chunked_search,
            kc.chunked_u8_search, kc.wide_search)


def random_pair(seed, h, w):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = np.roll(ref, (rng.integers(-3, 4), rng.integers(-3, 4)), (0, 1))
    cur = np.clip(
        cur.astype(np.int32) + rng.integers(-6, 7, (h, w)), 0, 255
    ).astype(np.uint8)
    return cur, ref


def assert_fields_equal(jax_field, torch_field):
    for name in ("mv_y", "mv_x", "best_cost_i32", "score"):
        want = np.asarray(getattr(jax_field, name))
        got = getattr(torch_field, name).cpu().numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def launch_counts():
    return [fn.launches for fn in WRAPPERS]


# (h, w, blk, span, phase, operand_bf16, metric, interior wrapper)
CASES = [
    pytest.param(40, 52, 12, 4, None, False, "mse", kc.chunked_search,
                 id="K5-blk12"),
    pytest.param(37, 51, 7, 5, None, False, "mse", kc.chunked_search,
                 id="K5-blk7-both-edges"),
    pytest.param(36, 52, 8, 0, None, False, "mse", kc.chunked_search,
                 id="K5-blk8-span0"),
    pytest.param(48, 64, 16, 0, None, False, "mse", kc.chunked_search,
                 id="K5-blk16-span0"),
    pytest.param(36, 52, 8, 5, False, False, "mse", kc.chunked_search,
                 id="K5-phase-off"),
    pytest.param(64, 64, 8, 4, False, True, "mse", kc.chunked_u8_search,
                 id="K6-blk8"),
    pytest.param(48, 64, 16, 7, False, True, "mse", kc.chunked_u8_search,
                 id="K6-blk16"),
    pytest.param(96, 120, 24, 7, None, False, "mse", kc.wide_search,
                 id="K7-blk24"),
    pytest.param(70, 90, 32, 5, False, False, "mse", kc.wide_search,
                 id="K7-blk32-phase-off"),
    pytest.param(36, 52, 8, 5, False, False, "sad", None, id="K2-sad"),
]


@pytest.mark.parametrize(
    "h,w,blk,span,phase,operand_bf16,metric,interior", CASES
)
def test_routes_match_pallas(h, w, blk, span, phase, operand_bf16, metric,
                             interior):
    cur, ref = random_pair(h * 7 + w + blk + span, h, w)
    kw = dict(blk_dim=blk, span=span, metric=metric, phase=phase,
              operand_bf16=operand_bf16)
    want = kp.full_search_frame_pallas(cur, ref, interpret=True, **kw)
    assert kc.interior_search(blk, span, metric, phase,
                              operand_bf16) is interior
    before = launch_counts()
    got = kc.full_search_frame_cuda(cur, ref, device="cpu", **kw)
    assert_fields_equal(want, got)
    # The plain versions never count as launches.
    assert launch_counts() == before
    if interior is None:
        return
    # The interior wrapper alone on the whole blocks vs JAX's interior.
    nyf, nxf = h // blk, w // blk
    halo = F.pad(torch.from_numpy(ref), (span, span, span, span))
    cost, idx = interior(
        torch.from_numpy(cur)[: nyf * blk, : nxf * blk], halo, blk_dim=blk,
        span=span, frame_height=h, frame_width=w,
    )
    k = 2 * span + 1
    np.testing.assert_array_equal(
        cost.numpy(), np.asarray(want.best_cost_i32)[:nyf, :nxf])
    mv_y = np.asarray(want.mv_y)[:nyf, :nxf]
    mv_x = np.asarray(want.mv_x)[:nyf, :nxf]
    np.testing.assert_array_equal(idx.numpy(), (mv_y + span) * k + mv_x + span)


@pytest.mark.parametrize(
    "blk,phase,operand_bf16",
    [(12, None, False), (12, False, True), (24, None, False)],
)
def test_constant_frames_raster_first_wins(blk, phase, operand_bf16):
    """Every cost ties at 0 (and Qref is the same at every candidate): the
    first valid candidate in raster order must win."""
    cur = np.full((3 * blk + 4, 3 * blk + 8), 77, np.uint8)
    kw = dict(blk_dim=blk, span=4, metric="mse", phase=phase,
              operand_bf16=operand_bf16)
    want = kp.full_search_frame_pallas(cur, cur, interpret=True, **kw)
    got = kc.full_search_frame_cuda(cur, cur, device="cpu", **kw)
    assert_fields_equal(want, got)
    assert int(got.mv_y[1, 1]) == -4 and int(got.mv_x[1, 1]) == -4
    assert int(got.mv_y[0, 0]) == 0 and int(got.mv_x[0, 0]) == 0
    assert not got.best_cost_i32.any()


def test_phase_true_where_unsupported_raises():
    cur, ref = random_pair(6, 48, 48)
    for blk, span, metric in ((24, 4, "mse"), (12, 4, "mse"), (8, 0, "sad")):
        with pytest.raises(ValueError, match="phase kernel requires"):
            kc.full_search_frame_cuda(cur, ref, blk_dim=blk, span=span,
                                      metric=metric, phase=True, device="cpu")
        with pytest.raises(ValueError, match="phase kernel requires"):
            kp.full_search_frame_pallas(cur, ref, blk_dim=blk, span=span,
                                        metric=metric, phase=True)


def test_no_mse_config_raises_not_implemented():
    """Every MSE/SAD config runs: blk 1..40 at spans 0 and 2, phase on, off
    and automatic (small frames; the golden search is the yardstick)."""
    rng = np.random.default_rng(8)
    for blk in (1, 3, 5, 7, 9, 12, 16, 20, 24, 28, 32, 40):
        h, w = blk + 3, 2 * blk + 1
        ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
        cur = np.roll(ref, (1, -1), (0, 1))
        for span in (0, 2):
            for metric in ("mse", "sad"):
                want = tfs.full_search_frame(
                    torch.from_numpy(cur), torch.from_numpy(ref),
                    blk_dim=blk, span=span, metric=metric)
                for phase in (None, False):
                    got = kc.full_search_frame_cuda(
                        cur, ref, blk_dim=blk, span=span, metric=metric,
                        phase=phase, operand_bf16=phase is False,
                        device="cpu")
                    for a, b in zip(got, want):
                        assert torch.equal(a, b), (blk, span, metric, phase)


def test_chunked_occupancy_rejects_what_the_kernel_does_not_cover():
    """The resource query checks its config before it reaches the card."""
    for blk, span, nbx in ((24, 15, 80), (0, 4, 80), (7, -1, 80), (7, 15, 0)):
        with pytest.raises(ValueError, match="no chunked kernel"):
            kc.chunked_occupancy(blk, span, nbx)


@pytest.mark.parametrize(
    "occupancy,args",
    [("phase_occupancy", (12, 4, "mse", 80)),
     ("phase_occupancy", (8, 0, "sad", 80)),
     ("phase_occupancy", (8, 4, "ssim", 80)),
     ("phase_occupancy", (8, 4, "mse", 0)),
     ("wide_occupancy", (16, 4, 80)), ("wide_occupancy", (28, 4, 80)),
     ("wide_occupancy", (24, -1, 80)), ("wide_occupancy", (32, 4, 0))],
)
def test_phase_and_wide_occupancy_reject_what_the_kernels_do_not_cover(
        occupancy, args):
    """The resource queries of K1 and K7 check their config before they
    reach the card."""
    with pytest.raises(ValueError, match="no (phase|wide) kernel"):
        getattr(kc, occupancy)(*args)


def test_interior_wrappers_reject_what_they_do_not_cover():
    cur, ref = random_pair(7, 48, 48)
    cur_t = torch.from_numpy(cur)
    halo = F.pad(torch.from_numpy(ref), (2, 2, 2, 2))
    kw = dict(span=2, frame_height=48, frame_width=48)
    with pytest.raises(ValueError, match="1 <= blk_dim <= 16"):
        kc.chunked_search(cur_t, halo, blk_dim=24, **kw)
    with pytest.raises(ValueError, match="1 <= blk_dim <= 16"):
        kc.chunked_u8_search(cur_t, halo, blk_dim=20, **kw)
    with pytest.raises(ValueError, match="16 < blk_dim <= 32"):
        kc.wide_search(cur_t, halo, blk_dim=16, **kw)
    with pytest.raises(ValueError, match="MSE only"):
        kc.chunked_search(cur_t, halo, blk_dim=8, metric="sad", **kw)
    with pytest.raises(ValueError, match="whole in-frame blocks"):
        kc.chunked_search(cur_t[:44], halo, blk_dim=8, **kw)


@pytest.mark.parametrize("group", kernel_turns.GROUPS, ids=lambda g: g[0])
def test_kernel_turns_groups_name_wrappers_that_take_their_keywords(group):
    """Each entry's wrapper exists in its module, counts its launches and
    binds (tile, halo) and the keywords `time_group` passes, so the tool
    cannot fail on the card with an AttributeError or a TypeError. Nothing
    is launched."""
    label, h, w, blk, span, entries = group
    for entry in entries:
        fn, kw = kernel_turns.entry_call(entry, h, w, blk, span)
        inspect.signature(fn).bind(None, None, **kw)
        assert isinstance(fn.launches, int), entry
        if kw.get("return_volume"):
            assert isinstance(fn.volume_launches, int), entry


def test_sass_loops_counts_the_instructions_of_each_loop():
    """The SASS reader finds each kernel and each backward branch, and
    counts the loop's instructions by opcode, predicates and modifiers
    dropped."""
    sass = "\n".join([
        "\t\tFunction : _Z3addPi",
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x1 */",
        "                                                            /* 0x2 */",
        "        /*0010*/                   IDP.4A.U8.U8 R2, R3, R4, R2 ;",
        "        /*0020*/                   LDS R3, [R5+0x10] ;",
        "        /*0030*/               @!P0 BRA 0x10 ;",
        "        /*0040*/                   EXIT ;",
        "\t\tFunction : _Z4nonev",
        "        /*0000*/                   EXIT ;",
    ])
    found = sass_loops.functions(sass)
    assert list(found) == ["_Z3addPi", "_Z4nonev"]
    assert len(found["_Z3addPi"]) == 5
    (start, end, count, ops), = sass_loops.loops(found["_Z3addPi"])
    assert (start, end, count) == (0x10, 0x30, 3)
    assert ops == {"IDP": 1, "LDS": 1, "BRA": 1}
    assert sass_loops.loops(found["_Z4nonev"]) == []


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(cuda, h, w, span, seed):
    cur, ref = random_pair(seed, h, w)
    cur_t = torch.from_numpy(cur).to(cuda)
    halo = F.pad(torch.from_numpy(ref).to(cuda), (span, span, span, span))
    return cur_t, halo


def _assert_exact(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("wrapper", ["chunked_search", "chunked_u8_search"])
@pytest.mark.parametrize(
    "h,w,blk,span",
    [(64, 96, 1, 3), (66, 99, 3, 4), (64, 96, 4, 5), (70, 98, 7, 15),
     (96, 200, 8, 12), (96, 200, 8, 0), (99, 143, 11, 6), (96, 96, 12, 3),
     (96, 160, 16, 15), (128, 128, 16, 31),
     # spans 0 and 1: fewer candidates than lanes in K5's warp
     (35, 63, 7, 0), (64, 96, 4, 1), (66, 99, 3, 1),
     # fewer macroblocks in the tile than warps in a CUDA block
     (21, 21, 7, 3),
     # K = 63 at span 31
     (64, 64, 1, 31), (66, 99, 3, 31), (70, 98, 7, 31), (99, 143, 11, 31)],
)
def test_chunked_kernels_match_plain_cuda(cuda, wrapper, h, w, blk, span):
    """Exact against the plain version, every volume entry too (K5's emit
    mode: the tile is the whole frame, so candidates past both frame edges
    hold INT32_MAX wherever span > 0). At K = 2 span + 1 > 32 K5's lanes
    wrap within a row of candidates, below it across rows; 70x98 at blk 7
    leaves the last CUDA block of each row short of macroblocks."""
    fn = getattr(kc, wrapper)
    cur_t, halo = _operands(cuda, h, w, span, blk + span)
    kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w)
    tile = cur_t[: h // blk * blk, : w // blk * blk]
    before = fn.launches
    got = fn(tile, halo, **kw)
    assert fn.launches == before + 1
    _assert_exact(got, kc.search_plain(tile, halo, metric="mse", **kw))
    if wrapper == "chunked_search":
        before = fn.volume_launches
        got = fn(tile, halo, return_volume=True, **kw)
        assert fn.volume_launches == before + 1
        _assert_exact(got, kc.search_plain(tile, halo, metric="mse",
                                           return_volume=True, **kw))
        assert bool((got[2] == 2**31 - 1).any()) == (span > 0)


@pytest.mark.parametrize("span", [0, 3, 15])
@pytest.mark.parametrize("blk", range(1, 17))
def test_u8_kernel_equals_chunked_kernel_cuda(cuda, blk, span):
    """K6 runs K5's search instance: equal (cost, idx) at every blk."""
    h, w = 4 * blk + 3, 9 * blk + 2
    cur_t, halo = _operands(cuda, h, w, span, 3 * blk + span)
    kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w)
    tile = cur_t[: h // blk * blk, : w // blk * blk]
    before = kc.chunked_u8_search.launches
    got = kc.chunked_u8_search(tile, halo, **kw)
    assert kc.chunked_u8_search.launches == before + 1
    _assert_exact(got, kc.chunked_search(tile, halo, **kw))


@pytest.mark.parametrize(
    "wrapper,blk,metric",
    [("chunked_search", 7, "mse"), ("chunked_search", 12, "mse"),
     ("phase_search", 8, "mse"), ("phase_search", 8, "sad"),
     ("phase_search", 32, "mse"), ("phase_search", 32, "sad"),
     ("wide_search", 24, "mse")],
)
def test_constant_frames_raster_first_wins_cuda(cuda, wrapper, blk, metric):
    """K5, K1 and K7 on the card: every cost ties at 0, and the first valid
    candidate in raster order must win."""
    fn = getattr(kc, wrapper)
    span, k = 4, 9
    h, w = 3 * blk + 4, 3 * blk + 8
    cur_t = torch.full((h, w), 77, dtype=torch.uint8, device=cuda)
    halo = F.pad(cur_t, (span, span, span, span))
    kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
              frame_width=w)
    tile = cur_t[: 3 * blk, : 3 * blk]
    before = fn.launches
    cost, idx = fn(tile, halo, **kw)
    assert fn.launches == before + 1
    _assert_exact((cost, idx), kc.search_plain(tile, halo, **kw))
    assert not cost.any()
    assert int(idx[1, 1]) == 0  # (-4, -4)
    assert int(idx[0, 0]) == span * k + span  # (0, 0): dy, dx < 0 invalid


def test_chunked_occupancy_cuda(cuda):
    """K5 at 3840x2160 7x7 +-15 keeps at least 32 warps resident per SM,
    with no spills."""
    occ = kc.chunked_occupancy(7, 15, 3840 // 7)
    assert occ["local_bytes"] == 0, occ
    assert occ["warps_per_sm"] >= 32, occ


@pytest.mark.parametrize(
    "occupancy,args",
    [("phase_occupancy", (8, 12, "mse", 3840 // 8)),
     ("phase_occupancy", (8, 12, "sad", 3840 // 8)),
     ("phase_occupancy", (16, 15, "mse", 3840 // 16)),
     ("phase_occupancy", (16, 15, "sad", 3840 // 16)),
     ("wide_occupancy", (24, 15, 1920 // 24))],
)
def test_phase_and_wide_occupancy_cuda(cuda, occupancy, args):
    """K1 at 3840x2160 8x8 +-12 and 16x16 +-15 and K7 at 1920x1080 24x24
    +-15 keep at least 16 warps resident per SM, with no spills."""
    occ = getattr(kc, occupancy)(*args)
    assert occ["local_bytes"] == 0, occ
    assert occ["warps_per_sm"] >= 16, occ


@pytest.mark.parametrize(
    "h,w,blk,span,y0,x0,nby,nbx",
    [(96, 120, 24, 7, 0, 0, 4, 5), (128, 256, 32, 15, 0, 0, 4, 8),
     (96, 96, 32, 31, 0, 0, 3, 3), (96, 192, 24, 0, 0, 0, 4, 8),
     # a tile of 2 x 3 blocks from global (blk, 2 blk)
     (120, 200, 24, 9, 24, 48, 2, 3), (140, 230, 32, 5, 32, 64, 2, 3)],
)
def test_wide_kernel_matches_plain_cuda(cuda, h, w, blk, span, y0, x0, nby,
                                        nbx):
    cur_t, halo = _operands(cuda, h, w, span, blk * 3 + span)
    kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w,
              y_origin=y0, x_origin=x0)
    tile = (cur_t[y0 : y0 + nby * blk, x0 : x0 + nbx * blk], halo[y0:, x0:])
    before = kc.wide_search.launches
    got = kc.wide_search(*tile, **kw)
    assert kc.wide_search.launches == before + 1
    _assert_exact(got, kc.search_plain(*tile, metric="mse", **kw))


@pytest.mark.parametrize(
    "h,w,blk,span,phase,operand_bf16",
    [(40, 52, 12, 4, None, False), (37, 51, 7, 5, None, False),
     (48, 64, 16, 0, None, False), (64, 64, 8, 4, False, True),
     (48, 64, 16, 7, False, True), (96, 120, 24, 7, None, False),
     (70, 90, 32, 5, False, False)],
)
def test_frame_routes_match_golden_cuda(cuda, h, w, blk, span, phase,
                                        operand_bf16):
    cur, ref = random_pair(h + w + blk, h, w)
    got = kc.full_search_frame_cuda(cur, ref, blk_dim=blk, span=span,
                                    phase=phase, operand_bf16=operand_bf16,
                                    device=cuda)
    want = tfs.full_search_frame(
        torch.from_numpy(cur).to(cuda), torch.from_numpy(ref).to(cuda),
        blk_dim=blk, span=span,
    )
    _assert_exact(got, want)
