"""The port's kernel wrappers vs the JAX Pallas kernels (interpret mode).

On the CPU the wrappers run their plain PyTorch versions, held here against
`full_search_frame_pallas(..., interpret=True)` (interior blocks from
`_kernel_phase`), `_edge_slab_bottom` / `_edge_slab_right` (`_kernel_int`),
and the whole-frame int route. Every output is integer or a float32
division, so the tolerance is exact equality.

Tests whose names end in `_cuda` compare each CUDA kernel with its plain
version on the card and skip where there is none:
`python -m pytest --noconftest tests/test_torch_kernels.py -k cuda` on a
CUDA machine.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from motionestimation_tpu.core.config import SearchConfig as JaxSearchConfig
from motionestimation_tpu.kernels import full_search_pallas as kp
from motionestimation_tpu.pipeline import runner as jax_runner
from motionestimation_tpu_torch import cli
from motionestimation_tpu_torch.core.config import SearchConfig
from motionestimation_tpu_torch.kernels import full_search_cuda as kc
from motionestimation_tpu_torch.pipeline import runner
from motionestimation_tpu_torch.search import full_search as tfs

# The tests run in several worker processes on shared cores; one torch
# thread per worker keeps them from oversubscribing the machine.
torch.set_num_threads(1)


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


# (h, w, blk, span, metric): blk 4/8/16/32, mse and sad, truncated edges.
CASES = [
    (32, 32, 4, 3, "mse"),    # exact grid, interior kernel only
    (36, 52, 8, 5, "sad"),    # truncated bottom row and right column
    (48, 72, 16, 7, "mse"),   # 8-px right column (1080p-like slab, turned)
    (70, 90, 32, 8, "mse"),   # blk 32, both edges truncated
    (66, 64, 32, 6, "sad"),   # 2-row bottom slab
]


@pytest.mark.parametrize("h,w,blk,span,metric", CASES)
def test_plain_kernels_match_pallas(h, w, blk, span, metric):
    cur, ref = random_pair(h * 31 + w + blk, h, w)
    want = kp.full_search_frame_pallas(
        cur, ref, blk_dim=blk, span=span, metric=metric, interpret=True
    )
    launches = (kc.phase_search.launches, kc.int_search.launches)
    got = kc.full_search_frame_cuda(
        cur, ref, blk_dim=blk, span=span, metric=metric, device="cpu"
    )
    assert_fields_equal(want, got)
    # The plain versions never count as launches.
    assert (kc.phase_search.launches, kc.int_search.launches) == launches

    cur_t, ref_t = torch.from_numpy(cur), torch.from_numpy(ref)
    halo = F.pad(ref_t, (span, span, span, span))
    kw = dict(blk_dim=blk, span=span, metric=metric)
    # Interior blocks: the phase kernel's plain version.
    nyf, nxf = h // blk, w // blk
    cost, idx = kc.phase_search(
        cur_t[: nyf * blk, : nxf * blk], halo, frame_height=h, frame_width=w,
        **kw,
    )
    np.testing.assert_array_equal(
        cost.numpy(), np.asarray(want.best_cost_i32)[:nyf, :nxf]
    )
    mv_y = np.asarray(want.mv_y)[:nyf, :nxf]
    mv_x = np.asarray(want.mv_x)[:nyf, :nxf]
    k = 2 * span + 1
    np.testing.assert_array_equal(idx.numpy(), (mv_y + span) * k + mv_x + span)
    # Edge slabs: the int kernel's plain version vs `_kernel_int`.
    nby, nbx = -(-h // blk), -(-w // blk)
    if h % blk:
        j_cost, j_idx = kp._edge_slab_bottom(
            cur, ref, blk_dim=blk, span=span, interpret=True, metric=metric
        )
        t_cost, t_idx = kc._edge_slab_bottom(cur_t, halo, **kw)
        np.testing.assert_array_equal(t_cost.numpy()[0], np.asarray(j_cost)[0, :nbx])
        np.testing.assert_array_equal(t_idx.numpy()[0], np.asarray(j_idx)[0, :nbx])
    if w % blk:
        j_cost, j_idx = kp._edge_slab_right(
            cur, ref, blk_dim=blk, span=span, interpret=True, metric=metric
        )
        t_cost, t_idx = kc._edge_slab_right(cur_t, halo, **kw)
        np.testing.assert_array_equal(t_cost.numpy()[:, 0], np.asarray(j_cost)[:nby, 0])
        np.testing.assert_array_equal(t_idx.numpy()[:, 0], np.asarray(j_idx)[:nby, 0])


def test_plain_kernels_ties_match_pallas():
    """Constant frames: all costs tie at 0 and raster-first must win."""
    cur = np.full((40, 44), 77, np.uint8)
    want = kp.full_search_frame_pallas(
        cur, cur, blk_dim=8, span=6, metric="mse", interpret=True
    )
    got = kc.full_search_frame_cuda(
        cur, cur, blk_dim=8, span=6, metric="mse", device="cpu"
    )
    assert_fields_equal(want, got)
    assert int(got.mv_y[2, 2]) == -6 and int(got.mv_x[2, 2]) == -6


@pytest.mark.parametrize("blk,metric", [(12, "sad"), (20, "mse")])
def test_whole_frame_int_route_matches_pallas(blk, metric):
    """Configs the phase kernel does not cover and K5-K7 do not take run
    the int kernel over the whole frame, as `_full_search_frame_jit` does."""
    cur, ref = random_pair(blk, 30, 50)
    want = kp.full_search_frame_pallas(
        cur, ref, blk_dim=blk, span=4, metric=metric, interpret=True
    )
    got = kc.full_search_frame_cuda(
        cur, ref, blk_dim=blk, span=4, metric=metric, device="cpu"
    )
    assert_fields_equal(want, got)


# (blk, metric, h, w): configs whose whole frame runs the int kernel (SAD
# outside the phase kernel's blk, MSE above K7's), on frames with a
# truncated bottom block row and right block column.
WHOLE_FRAME_INT = [(3, "sad", 17, 23), (7, "sad", 30, 44),
                   (20, "mse", 45, 50), (40, "mse", 50, 90),
                   (40, "sad", 50, 90)]


@pytest.mark.parametrize("span", range(6))
@pytest.mark.parametrize("blk,metric,h,w", WHOLE_FRAME_INT)
def test_whole_frame_int_routes_match_pallas_at_every_span(blk, metric, h, w,
                                                           span):
    """The whole-frame int route, span 0 included (SAD at any blk there),
    against `full_search_frame_pallas(interpret=True)`: MVs and integer
    costs equal."""
    assert kc.interior_search(blk, span, metric) is None
    cur, ref = random_pair(blk * 10 + span, h, w)
    want = kp.full_search_frame_pallas(
        cur, ref, blk_dim=blk, span=span, metric=metric, interpret=True
    )
    got = kc.full_search_frame_cuda(
        cur, ref, blk_dim=blk, span=span, metric=metric, device="cpu"
    )
    assert_fields_equal(want, got)


@pytest.mark.parametrize(
    "blk,span,kernel",
    [(12, 4, "K5"), (8, 0, "K5"), (16, 0, "K5"), (24, 4, "K7")],
)
def test_chunked_mse_routes_raise(blk, span, kernel):
    """MSE configs the JAX package sends to K5-K7, once a raise naming the
    kernel, take its port (`chunked_search` for K5, `wide_search` for K7)
    and equal the JAX result."""
    cur, ref = random_pair(1, 48, 48)
    ported = {"K5": kc.chunked_search, "K7": kc.wide_search}[kernel]
    assert kc.interior_search(blk, span, "mse") is ported
    want = kp.full_search_frame_pallas(
        cur, ref, blk_dim=blk, span=span, metric="mse", interpret=True
    )
    got = kc.full_search_frame_cuda(
        cur, ref, blk_dim=blk, span=span, metric="mse", device="cpu"
    )
    assert_fields_equal(want, got)


def test_frame_inputs_are_checked():
    cur, ref = random_pair(2, 32, 32)
    with pytest.raises(ValueError, match="ssim_cuda"):
        kc.full_search_frame_cuda(
            cur, ref, blk_dim=8, span=4, metric="ssim", device="cpu"
        )
    with pytest.raises(TypeError):
        kc.full_search_frame_cuda(
            cur.astype(np.float32), ref, blk_dim=8, span=4, device="cpu"
        )
    with pytest.raises(ValueError, match=r"\[0, 255\]"):
        kc.full_search_frame_cuda(
            cur.astype(np.int32) + 256, ref, blk_dim=8, span=4, device="cpu"
        )
    with pytest.raises(ValueError, match="identical shapes"):
        kc.full_search_frame_cuda(
            cur, ref[:, :24], blk_dim=8, span=4, device="cpu"
        )
    # Integer frames within [0, 255] are cast, as the JAX kernels cast.
    wide = kc.full_search_frame_cuda(
        cur.astype(np.int32), ref.astype(np.int64), blk_dim=8, span=4,
        device="cpu",
    )
    narrow = kc.full_search_frame_cuda(cur, ref, blk_dim=8, span=4, device="cpu")
    for a, b in zip(wide, narrow):
        assert torch.equal(a, b)


def _entry_full_search(cur, ref):
    kc.full_search_frame_cuda(cur, ref, blk_dim=8, span=4)


def _entry_run_pair(cur, ref):
    runner.run_pair(
        cur, ref, SearchConfig(blk_dim=8, span=4, frame_width=32,
                               frame_height=32)
    )


def _entry_cli(cur, ref, tmp_path):
    cur.tofile(tmp_path / "c.yuv")
    ref.tofile(tmp_path / "r.yuv")
    cli.main([str(tmp_path / "c.yuv"), str(tmp_path / "r.yuv"),
              str(tmp_path / "out"), "8", "4", "32", "32"])


@pytest.mark.parametrize("entry", ["full_search", "run_pair", "cli"])
def test_entry_points_raise_without_cuda(entry, tmp_path):
    """Without a device argument the entry points ask for CUDA and raise
    where it is absent, never carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    cur, ref = random_pair(3, 32, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "cli":
            _entry_cli(cur, ref, tmp_path)
        else:
            {"full_search": _entry_full_search,
             "run_pair": _entry_run_pair}[entry](cur, ref)


def test_run_pair_cpu_matches_golden():
    cur, ref = random_pair(4, 40, 56)
    config = SearchConfig(blk_dim=16, span=5, frame_width=56, frame_height=40)
    res = runner.run_pair(cur, ref, config, device="cpu")
    gold = tfs.full_search_frame(
        torch.from_numpy(cur), torch.from_numpy(ref), blk_dim=16, span=5
    )
    np.testing.assert_array_equal(res.field.mv_y, gold.mv_y.numpy())
    np.testing.assert_array_equal(res.field.mv_x, gold.mv_x.numpy())
    np.testing.assert_array_equal(res.field.best_cost_i32, gold.best_cost_i32.numpy())
    assert len(res.timing_row.split()) == 5
    # Diamond (early termination, crossover) equals JAX run_pair on the CPU.
    for extra in ({"early_term": 30.0}, {"escape_policy": "crossover"}):
        kw = dict(blk_dim=8, span=15, algorithm="diamond", frame_width=56,
                  frame_height=40, **extra)
        got = runner.run_pair(cur, ref, SearchConfig(**kw), device="cpu")
        want = jax_runner.run_pair(cur, ref, JaxSearchConfig(**kw))
        for a, b in zip(got.field, want.field):
            b = np.asarray(b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.comp, want.comp)
        assert got.psnr == want.psnr


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# (blk, span): span 1 (K = 3: most lanes of a warp idle) and wider
# windows; at blk 32, +-15 and +-31 make two and four warps share a
# macroblock.
PHASE_CUDA = [(1, 1), (1, 3), (1, 31), (2, 1), (2, 5), (4, 1), (4, 5),
              (8, 1), (8, 12), (16, 1), (16, 15), (32, 1), (32, 4), (32, 15),
              (32, 31)]


@pytest.mark.parametrize("metric", ["mse", "sad"])
@pytest.mark.parametrize("blk,span", PHASE_CUDA)
def test_phase_kernel_matches_plain_cuda(cuda, blk, span, metric):
    """Exact against the plain version: costs and indices, every volume
    entry (INT32_MAX past the frame edges included), and a tile off the
    frame's origin."""
    h, w = 4 * blk + 11, 6 * blk + 13
    cur, ref = random_pair(blk + span, h, w)
    cur_t = torch.from_numpy(cur).to(cuda)
    halo = F.pad(torch.from_numpy(ref).to(cuda), (span, span, span, span))
    kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
              frame_width=w)
    tile = cur_t[: h // blk * blk, : w // blk * blk]
    before = kc.phase_search.launches, kc.phase_search.volume_launches
    got = kc.phase_search(tile, halo, **kw)
    assert kc.phase_search.launches == before[0] + 1
    _assert_exact(got, kc.search_plain(tile, halo, **kw))
    got = kc.phase_search(tile, halo, return_volume=True, **kw)
    assert kc.phase_search.volume_launches == before[1] + 1
    _assert_exact(got, kc.search_plain(tile, halo, return_volume=True, **kw))
    assert bool((got[2] == 2**31 - 1).any())
    # Two block rows and three block columns from global (blk, 2 blk).
    y0, x0 = blk, 2 * blk
    sub = (cur_t[y0 : y0 + 2 * blk, x0 : x0 + 3 * blk], halo[y0:, x0:])
    okw = dict(kw, y_origin=y0, x_origin=x0, return_volume=True)
    _assert_exact(kc.phase_search(*sub, **okw),
                  kc.search_plain(*sub, **okw))


def _assert_exact(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize(
    "h,w,blk,span,metric",
    [(70, 90, 32, 8, "mse"), (47, 61, 8, 5, "sad"), (50, 77, 12, 7, "mse"),
     (45, 45, 40, 3, "sad")],
)
def test_int_kernel_matches_plain_cuda(cuda, h, w, blk, span, metric):
    cur, ref = random_pair(blk * span, h, w)
    cur_t = torch.from_numpy(cur).to(cuda)
    halo = F.pad(torch.from_numpy(ref).to(cuda), (span, span, span, span))
    kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
              frame_width=w)
    got = kc.int_search(cur_t, halo, **kw)
    want = kc.search_plain(cur_t, halo, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# (blk, span): every blk 1-33 at span 0 and one span that grows with blk
# (warps share a macroblock where the grid is short; K = 3 leaves most
# lanes idle), and blk 40, 48 and 64 (runtime words per row).
INT_CUDA = [(blk, span) for blk in list(range(1, 34)) + [40, 48, 64]
            for span in (0, (1, 3, 5, 7)[blk % 4])]


def edge_frame(blk):
    """(h, w): two whole block rows and five whole block columns, then a
    truncated one of each (blk >= 2; blk 1 leaves no slab)."""
    return (3 * blk - 1 - (blk % 3 if blk > 2 else 0),
            5 * blk + (blk + 1) // 2)


@pytest.mark.parametrize("metric", ["mse", "sad"])
@pytest.mark.parametrize("blk,span", INT_CUDA)
def test_int_kernel_whole_frames_and_slabs_cuda(cuda, blk, span, metric):
    """`int_search` exactly against its plain version, with and without
    its volume, on a whole frame with both edges truncated, its bottom and
    right slabs, a tile off the frame's origin, and constant frames (every
    cost ties at 0: raster-first must win)."""
    h, w = edge_frame(blk)
    cur, ref = random_pair(blk * 7 + span, h, w)
    cur_t = torch.from_numpy(cur).to(cuda)
    halo = F.pad(torch.from_numpy(ref).to(cuda), (span, span, span, span))
    flat = torch.full((h, w), 77, dtype=torch.uint8, device=cuda)
    flat_halo = F.pad(flat, (span, span, span, span))
    kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
              frame_width=w)
    y0, x0 = h // blk * blk, w // blk * blk
    tiles = [
        ((cur_t, halo), {}),
        ((cur_t[y0:], halo[y0:]), dict(y_origin=y0)),
        ((cur_t[:, x0:], halo[:, x0:]), dict(x_origin=x0)),
        ((cur_t[blk:, blk:], halo[blk:, blk:]),
         dict(y_origin=blk, x_origin=blk)),
        ((flat, flat_halo), {}),
    ]
    for ops, extra in tiles:
        if not ops[0].numel():  # blk 1: no slab
            continue
        for volume in (False, True):
            before = kc.int_search.launches, kc.int_search.volume_launches
            got = kc.int_search(*ops, return_volume=volume, **kw, **extra)
            assert (kc.int_search.launches,
                    kc.int_search.volume_launches) == (before[0] + 1,
                                                       before[1] + volume)
            _assert_exact(got, kc.search_plain(*ops, return_volume=volume,
                                               **kw, **extra))
    assert not got[0].any()  # constant frames


def test_int_occupancy_cuda(cuda):
    """K2 at its whole-frame and slab cells: no spills."""
    for blk, span, metric, nby, nbx in ((7, 15, "sad", 309, 549),
                                        (16, 15, "mse", 1, 120),
                                        (64, 15, "sad", 34, 60)):
        occ = kc.int_occupancy(blk, span, metric, nby, nbx)
        assert occ["local_bytes"] == 0, occ


@pytest.mark.parametrize("h,w,blk,span,metric", CASES)
def test_frame_matches_golden_cuda(cuda, h, w, blk, span, metric):
    cur, ref = random_pair(h + w, h, w)
    got = kc.full_search_frame_cuda(
        cur, ref, blk_dim=blk, span=span, metric=metric, device=cuda
    )
    want = tfs.full_search_frame(
        torch.from_numpy(cur).to(cuda), torch.from_numpy(ref).to(cuda),
        blk_dim=blk, span=span, metric=metric,
    )
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_rejects_wide_pixels_cuda(cuda):
    cur = torch.zeros((32, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        kc.phase_search(
            cur, F.pad(cur, (2, 2, 2, 2)), blk_dim=8, span=2, metric="mse",
            frame_height=32, frame_width=32,
        )
