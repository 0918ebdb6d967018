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

from motionestimation_tpu.kernels import full_search_pallas as kp
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


@pytest.mark.parametrize(
    "blk,span,kernel",
    [(12, 4, "K5"), (8, 0, "K5"), (16, 0, "K5"), (24, 4, "K7")],
)
def test_chunked_mse_routes_raise(blk, span, kernel):
    """MSE configs the JAX package sends to K5-K7 are not rerouted."""
    cur, ref = random_pair(1, 48, 48)
    with pytest.raises(NotImplementedError, match=kernel):
        kc.full_search_frame_cuda(
            cur, ref, blk_dim=blk, span=span, metric="mse", device="cpu"
        )


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
    with pytest.raises(NotImplementedError, match="diamond"):
        runner.run_pair(
            cur, ref, SearchConfig(algorithm="diamond", frame_width=56,
                                   frame_height=40), device="cpu",
        )


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "h,w,blk,span,metric",
    [(64, 96, 1, 3, "mse"), (64, 96, 4, 5, "sad"), (96, 200, 8, 12, "mse"),
     (96, 160, 16, 15, "sad"), (128, 256, 32, 31, "mse")],
)
def test_phase_kernel_matches_plain_cuda(cuda, h, w, blk, span, metric):
    cur, ref = random_pair(blk + span, h, w)
    cur_t = torch.from_numpy(cur).to(cuda)
    halo = F.pad(torch.from_numpy(ref).to(cuda), (span, span, span, span))
    kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
              frame_width=w)
    before = kc.phase_search.launches
    got = kc.phase_search(cur_t, halo, **kw)
    assert kc.phase_search.launches == before + 1
    want = kc.search_plain(cur_t, halo, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
