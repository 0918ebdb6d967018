"""Port vs JAX package: geometry, cost helpers, frame ops and SearchConfig.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in motionestimation_tpu_torch. Every output is integer or a
float computed in the same precision, so the tolerance is exact equality.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from motionestimation_tpu.core import config as jconfig
from motionestimation_tpu.core import frames as jframes
from motionestimation_tpu.core import geometry as jgeo
from motionestimation_tpu.metrics import cost as jcost
from motionestimation_tpu_torch.core import config as tconfig
from motionestimation_tpu_torch.core import frames as tframes
from motionestimation_tpu_torch.core import geometry as tgeo
from motionestimation_tpu_torch.metrics import cost as tcost

# The tests run in several worker processes on shared cores; one torch
# thread per worker keeps them from oversubscribing the machine.
torch.set_num_threads(1)

# (height, width, blk_dim): exact grids and truncated edges.
SHAPES = [(288, 352, 8), (70, 90, 32), (47, 61, 8), (36, 52, 12), (3, 5, 4)]


@pytest.mark.parametrize("h,w,blk", SHAPES)
def test_geometry_matches_jax(h, w, blk):
    assert tgeo.cdiv(h, blk) == jgeo.cdiv(h, blk)
    assert tgeo.grid_shape(h, w, blk) == jgeo.grid_shape(h, w, blk)
    assert tgeo.padded_dims(h, w, blk) == jgeo.padded_dims(h, w, blk)
    nby, nbx = tgeo.grid_shape(h, w, blk)
    for y0, x0 in ((0, 0), (blk, 2 * blk)):
        jext = jgeo.block_extents(y0, x0, nby, nbx, blk, h, w)
        text = tgeo.block_extents(y0, x0, nby, nbx, blk, h, w)
        for a, b in zip(jext, text):
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for d_y in (-blk - 1, -1, 0, 2, blk + 3):
            for d_x in (-2, 0, 1, blk):
                jv = jgeo.displacement_valid(d_y, d_x, *jext, h, w)
                tv = tgeo.displacement_valid(d_y, d_x, *text, h, w)
                np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


# tests/test_geometry.py's block_extents_np shapes, then SHAPES.
@pytest.mark.parametrize("h,w,blk", [(36, 52, 8), (47, 61, 8)] + SHAPES)
def test_block_extents_np_and_residual_mse_match_jax(h, w, blk):
    got = tgeo.block_extents_np(h, w, blk)
    want = jgeo.block_extents_np(h, w, blk)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32 and a.flags.writeable
        np.testing.assert_array_equal(a, b)
    text = tgeo.block_extents(0, 0, *tgeo.grid_shape(h, w, blk), blk, h, w)
    for a, b in zip(got, text):
        np.testing.assert_array_equal(a, b.numpy())
    rng = np.random.default_rng(h * w)
    a = rng.integers(0, 256, (h, w), dtype=np.uint8)
    b = rng.integers(0, 256, (h, w)).astype(np.int32)
    assert tframes.residual_mse(a, b) == jframes.residual_mse(a, b)
    assert tframes.residual_mse(a, a) == 0.0


@pytest.mark.parametrize("span", [0, 3, 12, 31])
def test_mv_from_flat_index_matches_jax(span):
    k = 2 * span + 1
    flat = np.arange(k * k, dtype=np.int32).reshape(k, k)
    jy, jx = jgeo.mv_from_flat_index(flat, span)
    ty, tx = tgeo.mv_from_flat_index(torch.from_numpy(flat), span)
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    assert ty.dtype == torch.int32


@pytest.mark.parametrize("blk", [4, 8, 32])
def test_cost_helpers_match_jax(blk):
    rng = np.random.default_rng(blk)
    x = rng.integers(0, 65026, (2, 3 * blk, 5 * blk), dtype=np.int32)
    np.testing.assert_array_equal(
        np.asarray(jcost.block_reduce(x, blk)),
        tcost.block_reduce(torch.from_numpy(x), blk).numpy(),
    )
    cost = rng.integers(0, 65025 * blk * blk, (6, 7), dtype=np.int32)
    count = rng.integers(0, blk * blk + 1, (6, 7), dtype=np.int32)
    count[0, :3] = 0  # padding blocks score 0, not NaN
    for jf, tf in ((jcost.mse_from_ssd, tcost.mse_from_ssd),
                   (jcost.mad_from_sad, tcost.mad_from_sad)):
        want = np.asarray(jf(cost, count))
        got = tf(torch.from_numpy(cost), torch.from_numpy(count)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(want, got)  # bit-equal float32
    assert tcost.INT32_MAX == int(jcost.INT32_MAX)


@pytest.mark.parametrize("h,w,blk", SHAPES)
def test_frame_ops_match_jax(h, w, blk):
    rng = np.random.default_rng(h * w)
    a = rng.integers(0, 256, (h, w), dtype=np.uint8)
    b = rng.integers(0, 200, (h, w), dtype=np.uint8)
    assert tframes.image_psnr(a, b) == jframes.image_psnr(a, b)
    assert tframes.image_psnr(a, a) == jframes.image_psnr(a, a) == 99.0
    err = int(((a.astype(np.int64) - b) ** 2).sum())
    mx = int(max(a.max(), b.max()))
    assert tframes.psnr_from_stats(err, a.size, mx) == jframes.psnr_from_stats(
        err, a.size, mx
    )
    assert tframes.residual_mse_c_float32(
        a, b
    ) == jframes.residual_mse_c_float32(a, b)
    np.testing.assert_array_equal(
        tframes.frame_diff(a, b), jframes.frame_diff(a, b)
    )
    nby, nbx = tgeo.grid_shape(h, w, blk)
    span = 3
    # In-frame MVs for every block, like a full search returns.
    tl_y = np.arange(nby)[:, None] * blk
    tl_x = np.arange(nbx)[None, :] * blk
    bh = np.minimum(blk, h - tl_y)
    bw = np.minimum(blk, w - tl_x)
    mv_y = np.clip(rng.integers(-span, span + 1, (nby, nbx)), -tl_y, h - bh - tl_y)
    mv_x = np.clip(rng.integers(-span, span + 1, (nby, nbx)), -tl_x, w - bw - tl_x)
    comp = tframes.compensate_frame_np(b, mv_y, mv_x, blk)
    np.testing.assert_array_equal(
        comp, jframes.compensate_frame_np(b, mv_y, mv_x, blk)
    )
    np.testing.assert_array_equal(
        tframes.stack_output(b, a, comp), jframes.stack_output(b, a, comp)
    )
    assert tframes.output_filename("d", blk, span) == jframes.output_filename(
        "d", blk, span
    )


def test_yuv_io_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (36, 52), dtype=np.uint8)
    wide = frame.astype(np.int32) + 256  # C-cast narrowing wraps mod 256
    tframes.save_yuv(tmp_path / "t.yuv", wide)
    jframes.save_yuv(tmp_path / "j.yuv", wide)
    assert (tmp_path / "t.yuv").read_bytes() == (tmp_path / "j.yuv").read_bytes()
    loaded = tframes.load_yuv(tmp_path / "t.yuv", 36, 52)
    assert loaded.flags.writeable
    np.testing.assert_array_equal(
        loaded, jframes.load_yuv(tmp_path / "j.yuv", 36, 52)
    )
    np.testing.assert_array_equal(loaded, frame)
    with pytest.raises(IOError):
        tframes.load_yuv(os.fspath(tmp_path / "t.yuv"), 37, 52)


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        dict(blk_dim=16, span=15, metric="sad", frame_width=1920,
             frame_height=1080),
        dict(algorithm="diamond", early_term=40.0, escape_policy="crossover"),
        dict(blk_dim=0),
        dict(span=-1),
        dict(metric="ncc"),
        dict(algorithm="hex"),
        dict(early_term=1.0),
        dict(escape_policy="crossover"),
        dict(frame_width=0),
    ],
)
def test_search_config_matches_jax(kwargs):
    try:
        jcfg = jconfig.SearchConfig(**kwargs)
    except ValueError:
        with pytest.raises(ValueError):
            tconfig.SearchConfig(**kwargs)
        return
    tcfg = tconfig.SearchConfig(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.num_candidates == jcfg.num_candidates
