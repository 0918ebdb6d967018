"""Port's plain-torch golden search vs the JAX golden search.

All 9 MSE fixtures (Foreman from the planes of the fixture's stacked
output, the rand_* fixtures from their own cur.yuv / ref.yuv), SAD on a
subset, ties, and a tile with a non-zero global origin. MVs, int32 costs,
float32 scores and compensated frames must be bit-equal; the compensated
stack must equal the C reference's output byte for byte.
"""
import os

import numpy as np
import pytest
import torch

from conftest import FixtureCase, mse_cases
from motionestimation_tpu.search import full_search as jfs
from motionestimation_tpu_torch.core import frames as tframes
from motionestimation_tpu_torch.search import full_search as tfs

# The tests run in several worker processes on shared cores; one torch
# thread per worker keeps them from oversubscribing the machine.
torch.set_num_threads(1)


def fixture_frames(case: FixtureCase):
    """(cur, ref) uint8 planes: the fixture's own files, or planes 1 and 0
    of its stacked output ([ref, cur, comp, ...]) for Foreman."""
    if os.path.exists(os.path.join(case.dir, case.meta["cur"])):
        return case.cur, case.ref
    stack = case.golden_stack
    return stack[1].copy(), stack[0].copy()


def assert_fields_equal(jax_field, torch_field):
    for name in ("mv_y", "mv_x", "best_cost_i32", "score"):
        want = np.asarray(getattr(jax_field, name))
        got = getattr(torch_field, name).cpu().numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _search_both(cur, ref, blk, span, metric):
    kw = dict(blk_dim=blk, span=span, metric=metric)
    jf = jfs.full_search_frame(cur, ref, **kw)
    tf = tfs.full_search_frame(torch.from_numpy(cur), torch.from_numpy(ref), **kw)
    return jf, tf


@pytest.mark.parametrize("name", mse_cases())
def test_golden_matches_jax_on_fixture(name):
    case = FixtureCase(name)
    cur, ref = fixture_frames(case)
    h, w = cur.shape
    jf, tf = _search_both(cur, ref, case.blk_dim, case.span, "mse")
    assert_fields_equal(jf, tf)
    geo = dict(frame_height=h, frame_width=w, blk_dim=case.blk_dim,
               span=case.span)
    jcomp = np.asarray(jfs.compensate_frame(ref, jf, **geo))
    tcomp = tfs.compensate_frame(torch.from_numpy(ref), tf, **geo).numpy()
    np.testing.assert_array_equal(tcomp, jcomp)
    stack = tframes.stack_output(ref, cur, tcomp).astype(np.uint8)
    assert stack.tobytes() == case.golden_stack.tobytes()
    assert "%.6f" % tframes.image_psnr(tcomp, cur) == "%.6f" % case.golden_psnr()


@pytest.mark.parametrize(
    "name", ["foreman_mse_16_7", "rand_mse_61x47_8_5", "rand_mse_90x70_32_8"]
)
def test_golden_sad_matches_jax(name):
    case = FixtureCase(name)
    cur, ref = fixture_frames(case)
    jf, tf = _search_both(cur, ref, case.blk_dim, case.span, "sad")
    assert_fields_equal(jf, tf)


@pytest.mark.parametrize("metric", ["mse", "sad"])
def test_golden_ties_match_jax(metric):
    """Constant frames: every cost ties at 0, the window's first candidate
    in raster order must win."""
    cur = np.full((32, 40), 77, np.uint8)
    jf, tf = _search_both(cur, cur.copy(), 8, 4, metric)
    assert_fields_equal(jf, tf)
    assert int(tf.mv_y[1, 1]) == -4 and int(tf.mv_x[1, 1]) == -4
    assert int(tf.mv_y[0, 0]) == 0 and int(tf.mv_x[0, 0]) == 0


@pytest.mark.parametrize("metric", ["mse", "sad"])
def test_tile_with_origin_matches_jax(metric):
    """A tile at a non-zero global origin (the unit a sharded run uses)."""
    rng = np.random.default_rng(3)
    h, w, blk, span = 44, 60, 8, 5
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = np.roll(ref, (2, -1), (0, 1))
    y0, x0 = 16, 24
    th, tw = 24, 40  # rows 16..40, cols 24..64: the right blocks truncate
    cur_p = np.zeros((th, tw), np.int32)
    cur_p[:, : w - x0] = cur[y0 : y0 + th, x0:]
    halo = np.array(jfs.make_ref_halo(ref, h, w, blk, span))
    halo_t = halo[y0 : y0 + th + 2 * span, x0 : x0 + tw + 2 * span]
    kw = dict(frame_height=h, frame_width=w, blk_dim=blk, span=span,
              metric=metric)
    jf = jfs.full_search_tile(cur_p, halo_t, y0, x0, **kw)
    tf = tfs.full_search_tile(
        torch.from_numpy(cur_p), torch.from_numpy(halo_t), y0, x0, **kw
    )
    assert_fields_equal(jf, tf)
    np.testing.assert_array_equal(
        tfs.make_ref_halo(torch.from_numpy(ref), h, w, blk, span).numpy(), halo
    )


def test_golden_ssim_names_its_slice():
    """The golden SSIM search, once a raise naming its slice, equals JAX's
    on Foreman 16x16 +-7: MVs, flat indices and float32 scores within 1e-6
    (jitted XLA fuses the score arithmetic; the port rounds each step)."""
    case = FixtureCase("foreman_ssim_16_7")
    cur, ref = fixture_frames(case)
    jf, tf = _search_both(cur, ref, case.blk_dim, case.span, "ssim")
    for name in ("mv_y", "mv_x", "best_cost_i32"):
        np.testing.assert_array_equal(
            getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
            err_msg=name,
        )
    np.testing.assert_allclose(tf.score.numpy(), np.asarray(jf.score),
                               rtol=0, atol=1e-6)
