"""The port's sharded path (`parallel/sharded.py`, the tile entries of the
ported kernels, `search.diamond.diamond_search_tile`) against the JAX
package's on the CPU.

The port runs on meshes of CPU slots (`[cpu] * n`), JAX on its 8 virtual
CPU devices (tests/conftest.py), both on the same frames made from numpy
seeds. Each port case runs both backends: "golden" (the plain tile search)
and "cuda" (the kernels' tile entries, which run their plain versions on
CPU tensors and so exercise their split of a tile into in-frame, truncated
and padding blocks). The JAX side runs `backend="golden"`, which its own
tests show bit-identical to its Pallas path.

Held exactly: MVs, integer costs, compensated frames and the stats
(the port's int64 Σerr² against JAX's (hi << 15) + lo) on the frame's
block grid and pixels; the unsharded port path as well. SSIM scores: bit
for bit against the unsharded port, within 1e-6 of jitted JAX (XLA:CPU
fuses the float32 score arithmetic; ROADMAP, "Held against").
"""
import functools

import jax
import numpy as np
import pytest
import torch

from motionestimation_tpu.parallel import make_mesh as jax_make_mesh
from motionestimation_tpu.parallel import sharded as jax_sharded
from motionestimation_tpu.search import diamond as jax_diamond
from motionestimation_tpu.search import full_search as jax_fs
from motionestimation_tpu_torch.core import frames
from motionestimation_tpu_torch.kernels import full_search_cuda as kc
from motionestimation_tpu_torch.kernels import ssim_cuda as sc
from motionestimation_tpu_torch.parallel import make_mesh, sharded
from motionestimation_tpu_torch.search import diamond
from motionestimation_tpu_torch.search import full_search as fs

torch.set_num_threads(1)
CPU = torch.device("cpu")
BACKENDS = ["golden", "cuda"]
# Test ids without "cuda": the card's tests are the ones named `*_cuda`.
BACKEND_IDS = ["golden", "tile-entries"]
SCORE_ATOL = 1e-6
INT32_MAX = 2**31 - 1


def _mesh(dp, ty, tx):
    return make_mesh(dp, ty, tx, devices=[CPU] * (dp * ty * tx))


def _step(*args, **kw):
    """`sharded_motion_step`'s results, gathered in this process."""
    return sharded.gather(sharded.sharded_motion_step(*args, **kw))


def _pair(rng, h, w):
    """As tests/test_sharded.py makes them: a random reference, the
    current frame moved and noised."""
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = np.clip(np.roll(ref, (rng.integers(-3, 4), rng.integers(-3, 4)),
                          (0, 1)).astype(np.int32)
                  + rng.integers(-6, 7, (h, w)), 0, 255).astype(np.uint8)
    return cur, ref


def _smooth(rng, h, w, shift, noise=2):
    """Blocky content that diamond search follows (tests/test_sharded.py's
    diamond frames)."""
    small = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float64)
    ref = np.clip(np.kron(small, np.ones((8, 8)))[:h, :w]
                  + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
    cur = np.clip(np.roll(ref, shift, (0, 1)).astype(np.int32)
                  + rng.integers(-noise, noise + 1, (h, w)),
                  0, 255).astype(np.uint8)
    return cur, ref


def _np(t):
    return t.cpu().numpy()


def _grid(h, w, blk):
    return -(-h // blk), -(-w // blk)


def _assert_step_equals_jax(res, jres, b, h, w, blk, metric):
    """Batch entry b of a port step against the JAX step's."""
    nby, nbx = _grid(h, w, blk)
    for got, want in ((res.mv_y, jres.mv_y), (res.mv_x, jres.mv_x)):
        np.testing.assert_array_equal(_np(got)[b, :nby, :nbx],
                                      np.asarray(want)[b, :nby, :nbx])
    cost, jcost = _np(res.best_cost)[b, :nby, :nbx], np.asarray(
        jres.best_cost)[b, :nby, :nbx]
    if metric == "ssim":
        np.testing.assert_allclose(cost, jcost, rtol=0, atol=SCORE_ATOL)
    else:
        np.testing.assert_array_equal(cost, jcost)
    np.testing.assert_array_equal(_np(res.comp)[b, :h, :w],
                                  np.asarray(jres.comp)[b, :h, :w])
    assert int(res.sum_sq[b]) == (int(np.asarray(jres.sum_sq_hi)[b]) << 15) \
        + int(np.asarray(jres.sum_sq_lo)[b])
    assert int(res.frame_max[b]) == int(np.asarray(jres.frame_max)[b])


def _assert_step_equals_unsharded(res, b, cur, ref, blk, span, metric):
    """Batch entry b against the port's unsharded golden path, every value
    bit for bit (SSIM scores included), and the stats against the host."""
    h, w = cur.shape
    nby, nbx = _grid(h, w, blk)
    want = fs.full_search_frame(torch.from_numpy(cur), torch.from_numpy(ref),
                                blk_dim=blk, span=span, metric=metric)
    assert torch.equal(res.mv_y[b, :nby, :nbx], want.mv_y)
    assert torch.equal(res.mv_x[b, :nby, :nbx], want.mv_x)
    assert torch.equal(res.best_cost[b, :nby, :nbx],
                       want.score if metric == "ssim" else want.best_cost_i32)
    comp = fs.compensate_frame(torch.from_numpy(ref), want, frame_height=h,
                               frame_width=w, blk_dim=blk, span=span)
    assert torch.equal(res.comp[b, :h, :w], comp)
    err = _np(comp).astype(np.int64) - cur.astype(np.int64)
    assert int(res.sum_sq[b]) == int(np.sum(err * err))
    assert frames.psnr_from_stats(int(res.sum_sq[b]), h * w,
                                  int(res.frame_max[b])) == \
        frames.image_psnr(_np(comp), cur.astype(np.int32))


# tests/test_sharded.py:28-39
STEP_CASES = [
    (1, 2, 4, 64, 96, 8, 5),
    (1, 4, 2, 64, 96, 8, 12),
    (1, 1, 8, 48, 128, 8, 4),
    (1, 8, 1, 128, 48, 8, 4),
    (2, 2, 2, 64, 64, 16, 7),
    (1, 2, 2, 36, 52, 4, 5),    # truncated edges land in padding
    (1, 2, 2, 128, 128, 32, 5),
]


@pytest.mark.parametrize("backend", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("dp,ty,tx,h,w,blk,span", STEP_CASES)
def test_sharded_step_matches_jax_and_unsharded(dp, ty, tx, h, w, blk, span,
                                                backend):
    rng = np.random.default_rng(dp * 100 + ty * 10 + tx + h + w)
    refs = np.stack([_pair(rng, h, w)[1] for _ in range(dp)])
    curs = np.clip(refs.astype(np.int32) + rng.integers(-8, 9, refs.shape),
                   0, 255).astype(np.uint8)
    res = _step(
        curs, refs, mesh=_mesh(dp, ty, tx), blk_dim=blk, span=span,
        frame_height=h, frame_width=w, backend=backend)
    jres = jax_sharded.sharded_motion_step(
        curs, refs, mesh=jax_make_mesh(dp, ty, tx), blk_dim=blk, span=span,
        metric="mse", frame_height=h, frame_width=w, backend="golden")
    for b in range(dp):
        _assert_step_equals_jax(res, jres, b, h, w, blk, "mse")
        _assert_step_equals_unsharded(res, b, curs[b], refs[b], blk, span,
                                      "mse")


# span == tile width (tests/test_sharded.py:83), then :111-118
HOP_CASES = [
    (1, 4, 32, 128, 8, 31),
    (4, 2, 64, 32, 8, 20),
    (2, 4, 32, 64, 8, 20),
    (4, 1, 32, 32, 8, 31),
]


@pytest.mark.parametrize("backend", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("ty,tx,h,w,blk,span", HOP_CASES)
def test_multihop_halo_matches_jax_and_unsharded(ty, tx, h, w, blk, span,
                                                 backend):
    rng = np.random.default_rng(span * 100 + ty)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = np.clip(np.roll(ref, (2, -3), (0, 1)).astype(np.int32)
                  + rng.integers(-5, 6, (h, w)), 0, 255).astype(np.uint8)
    res = _step(
        cur[None], ref[None], mesh=_mesh(1, ty, tx), blk_dim=blk, span=span,
        frame_height=h, frame_width=w, backend=backend)
    jres = jax_sharded.sharded_motion_step(
        cur[None], ref[None], mesh=jax_make_mesh(1, ty, tx), blk_dim=blk,
        span=span, metric="mse", frame_height=h, frame_width=w,
        backend="golden")
    _assert_step_equals_jax(res, jres, 0, h, w, blk, "mse")
    _assert_step_equals_unsharded(res, 0, cur, ref, blk, span, "mse")


# (ty, tx, h, w, blk, span, metric): SSIM (tests/test_sharded.py:50, 158),
# blk 32 on the fast kernel's tiles and blk 40 on the truncated-extent
# kernel's, SAD at a blk the phase kernel does not take (the int kernel
# over every tile), MSE at blk 24 (the wide kernel), and span 0.
METRIC_CASES = [
    (2, 4, 64, 96, 8, 5, "ssim"),
    (2, 2, 52, 60, 8, 5, "ssim"),
    (2, 2, 100, 140, 32, 3, "ssim"),
    (2, 2, 100, 140, 40, 3, "ssim"),
    (2, 2, 52, 60, 7, 5, "sad"),
    (2, 2, 60, 100, 24, 3, "mse"),
    (2, 2, 52, 60, 8, 0, "mse"),
]


@pytest.mark.parametrize("backend", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("ty,tx,h,w,blk,span,metric", METRIC_CASES)
def test_sharded_metrics_match_jax_and_unsharded(ty, tx, h, w, blk, span,
                                                 metric, backend):
    """At blk 32 the JAX Pallas tile entry is mis-sized (ROADMAP Queue 3,
    reference fault 1): the JAX side here is its golden tile search."""
    rng = np.random.default_rng(blk * 10 + span + h)
    cur, ref = _pair(rng, h, w)
    res = _step(
        cur[None], ref[None], mesh=_mesh(1, ty, tx), blk_dim=blk, span=span,
        metric=metric, frame_height=h, frame_width=w, backend=backend)
    jres = jax_sharded.sharded_motion_step(
        cur[None], ref[None], mesh=jax_make_mesh(1, ty, tx), blk_dim=blk,
        span=span, metric=metric, frame_height=h, frame_width=w,
        backend="golden")
    _assert_step_equals_jax(res, jres, 0, h, w, blk, metric)
    _assert_step_equals_unsharded(res, 0, cur, ref, blk, span, metric)


def test_sharded_full_search_crops_to_the_frame():
    rng = np.random.default_rng(11)
    cur, ref = _pair(rng, 52, 60)
    mesh = _mesh(1, 2, 2)
    mv_y, mv_x, cost, comp = sharded.sharded_full_search(
        cur, ref, mesh=mesh, blk_dim=8, span=5, metric="ssim",
        backend="cuda")
    j = jax_sharded.sharded_full_search(
        cur, ref, mesh=jax_make_mesh(1, 2, 2), blk_dim=8, span=5,
        metric="ssim", backend="golden")
    assert tuple(mv_y.shape) == (7, 8) and tuple(comp.shape) == (52, 60)
    np.testing.assert_array_equal(_np(mv_y), np.asarray(j[0]))
    np.testing.assert_array_equal(_np(mv_x), np.asarray(j[1]))
    np.testing.assert_allclose(_np(cost), np.asarray(j[2]), rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_array_equal(_np(comp), np.asarray(j[3]))


# tests/test_sharded.py:199-208
DIAMOND_CASES = [
    (2, 2, 64, 96, 8, 7, "mse"),
    (2, 2, 64, 96, 8, 7, "sad"),
    (4, 2, 64, 96, 8, 12, "mse"),
    (2, 2, 52, 60, 8, 5, "mse"),
    (2, 2, 48, 64, 8, 5, "ssim"),
]


def _assert_diamond(res, cur, ref, blk, span, metric, early_term, jres):
    h, w = cur.shape
    g_mvy, g_mvx, g_cost, _ = jax_diamond.diamond_search_np(
        cur, ref, blk_dim=blk, span=span, metric=metric,
        early_term=early_term)
    nby, nbx = g_mvy.shape
    np.testing.assert_array_equal(_np(res.mv_y)[0, :nby, :nbx], g_mvy)
    np.testing.assert_array_equal(_np(res.mv_x)[0, :nby, :nbx], g_mvx)
    want = diamond.diamond_search_frame(
        cur, ref, blk_dim=blk, span=span, metric=metric,
        early_term=early_term, device="cpu")
    if metric == "ssim":
        assert torch.equal(res.best_cost[0, :nby, :nbx], want.score)
    else:
        np.testing.assert_array_equal(_np(res.best_cost)[0, :nby, :nbx],
                                      g_cost.astype(np.int64))
    comp = fs.compensate_frame(torch.from_numpy(ref), want, frame_height=h,
                               frame_width=w, blk_dim=blk, span=span)
    assert torch.equal(res.comp[0, :h, :w], comp)
    _assert_step_equals_jax(res, jres, 0, h, w, blk, metric)


@pytest.mark.parametrize("backend", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("ty,tx,h,w,blk,span,metric", DIAMOND_CASES)
def test_sharded_diamond_matches_jax_and_numpy(ty, tx, h, w, blk, span,
                                               metric, backend):
    rng = np.random.default_rng(ty * 10 + tx + h + span)
    cur, ref = _smooth(rng, h, w, (2, -3))
    kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
              frame_width=w, algorithm="diamond")
    res = _step(cur[None], ref[None],
                                      mesh=_mesh(1, ty, tx), backend=backend,
                                      **kw)
    jres = jax_sharded.sharded_motion_step(
        cur[None], ref[None], mesh=jax_make_mesh(1, ty, tx),
        backend="golden", **kw)
    _assert_diamond(res, cur, ref, blk, span, metric, None, jres)


@pytest.mark.parametrize("backend", BACKENDS, ids=BACKEND_IDS)
def test_sharded_diamond_early_term_matches_jax_and_numpy(backend):
    h, w, blk, span, early = 64, 96, 8, 7, 60.0
    rng = np.random.default_rng(7)
    cur, ref = _smooth(rng, h, w, (3, -4), noise=6)
    kw = dict(blk_dim=blk, span=span, metric="mse", frame_height=h,
              frame_width=w, algorithm="diamond", early_term=early)
    res = _step(cur[None], ref[None],
                                      mesh=_mesh(1, 2, 2), backend=backend,
                                      **kw)
    jres = jax_sharded.sharded_motion_step(
        cur[None], ref[None], mesh=jax_make_mesh(1, 2, 2), backend="golden",
        **kw)
    _assert_diamond(res, cur, ref, blk, span, "mse", early, jres)
    plain = _step(
        cur[None], ref[None], mesh=_mesh(1, 2, 2), backend=backend,
        **dict(kw, early_term=None))
    assert not torch.equal(res.mv_y, plain.mv_y) or not torch.equal(
        res.mv_x, plain.mv_x), "the threshold must change the field"


@pytest.mark.parametrize("use_kernels", [False, True])
def test_diamond_tile_trajectory_matches_jax(use_kernels):
    """tests/test_sharded.py:290: a tile's trajectories (the bottom-right
    quadrant, origin (32, 48)) equal the canonical numpy ones, and the JAX
    tile entry's MVs and costs."""
    rng = np.random.default_rng(42)
    h, w, blk, span = 64, 96, 8, 7
    cur, ref = _smooth(rng, h, w, (6, 5))  # forces escalation
    _, _, _, g_traj = jax_diamond.diamond_search_np(
        cur, ref, blk_dim=blk, span=span, metric="mse")
    halo = np.pad(ref, span)[32 : 32 + 32 + 2 * span,
                             48 : 48 + 48 + 2 * span]
    kw = dict(frame_height=h, frame_width=w, blk_dim=blk, span=span,
              metric="mse", record_trajectory=True)
    mv_y, mv_x, cost, traj = diamond.diamond_search_tile(
        torch.from_numpy(cur[32:, 48:].copy()), torch.from_numpy(halo), 32,
        48, use_kernels=use_kernels, **kw)
    np.testing.assert_array_equal(_np(traj), g_traj[:, 4:, 6:])
    j = jax_diamond.diamond_search_tile(
        jax.numpy.asarray(cur[32:, 48:], jax.numpy.int32),
        jax.numpy.asarray(halo, jax.numpy.int32), 32, 48, **kw)
    for got, want in zip((mv_y, mv_x, cost, traj), j):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


# tests/test_sharded.py:337-343
PIPE_CASES = [(52, 60, "mse"), (48, 64, "mse"), (48, 64, "ssim"),
              (52, 60, "sad")]


@pytest.mark.parametrize("backend", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("h,w,metric", PIPE_CASES)
def test_sharded_gop_pipelined_matches_per_pair_and_jax(h, w, metric,
                                                        backend):
    blk, span, npairs = 8, 5, 3
    rng = np.random.default_rng(h + w + len(metric))
    stack = [rng.integers(0, 256, (h, w), dtype=np.uint8)]
    for _ in range(npairs):
        stack.append(np.clip(np.roll(stack[-1], (2, -3), (0, 1))
                             .astype(np.int32) + rng.integers(-4, 5, (h, w)),
                             0, 255).astype(np.uint8))
    stack = np.stack(stack)
    kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
              frame_width=w)
    got = sharded.gather(sharded.sharded_gop_pipelined(
        stack, mesh=_mesh(1, 2, 2), backend=backend, **kw))
    assert got.comp is None
    mv_y, mv_x, cost, sq, fmax = (got.mv_y, got.mv_x, got.best_cost,
                                  got.sum_sq, got.frame_max)
    j = jax_sharded.sharded_gop_pipelined(
        stack, mesh=jax_make_mesh(1, 2, 2), backend="golden", **kw)
    nby, nbx = _grid(h, w, blk)
    for i in range(npairs):
        res = _step(
            stack[i + 1][None], stack[i][None], mesh=_mesh(1, 2, 2),
            backend=backend, **kw)
        for got, want in ((mv_y, res.mv_y), (mv_x, res.mv_x),
                          (cost, res.best_cost)):
            assert torch.equal(got[i, :nby, :nbx], want[0, :nby, :nbx])
        assert int(sq[i]) == int(res.sum_sq[0])
        assert int(fmax[i]) == int(res.frame_max[0])
        np.testing.assert_array_equal(_np(mv_y)[i, :nby, :nbx],
                                      np.asarray(j[0])[i, :nby, :nbx])
        np.testing.assert_array_equal(_np(mv_x)[i, :nby, :nbx],
                                      np.asarray(j[1])[i, :nby, :nbx])
        np.testing.assert_allclose(_np(cost)[i, :nby, :nbx],
                                   np.asarray(j[2])[i, :nby, :nbx], rtol=0,
                                   atol=SCORE_ATOL if metric == "ssim" else 0)
        assert int(sq[i]) == (int(np.asarray(j[3])[i]) << 15) + int(
            np.asarray(j[4])[i])
        assert int(fmax[i]) == int(np.asarray(j[5])[i])


def test_sharded_gop_pipelined_needs_dp_1():
    with pytest.raises(ValueError, match="dp = 1"):
        sharded.sharded_gop_pipelined(
            np.zeros((3, 16, 16), np.uint8), mesh=_mesh(2, 1, 1), blk_dim=8,
            span=2, frame_height=16, frame_width=16)


def test_sharded_psnr_stats_bit_exact():
    """tests/test_sharded.py:137: the reduced stats give image_psnr's value
    bit for bit, truncated edges included."""
    rng = np.random.default_rng(99)
    h, w, blk, span = 70, 100, 8, 5
    cur, ref = _pair(rng, h, w)
    for backend in BACKENDS:
        res = _step(
            cur[None], ref[None], mesh=_mesh(1, 2, 2), blk_dim=blk,
            span=span, frame_height=h, frame_width=w, backend=backend)
        comp = _np(res.comp)[0, :h, :w]
        err = comp.astype(np.int64) - cur.astype(np.int64)
        assert res.sum_sq.dtype == torch.int64
        assert int(res.sum_sq[0]) == int(np.sum(err * err))
        assert frames.psnr_from_stats(int(res.sum_sq[0]), h * w,
                                      int(res.frame_max[0])) == \
            frames.image_psnr(comp, cur.astype(np.int32))


def test_resolve_backend():
    cpu_mesh = _mesh(1, 2, 2)
    assert sharded._resolve_backend("auto", cpu_mesh) == "golden"
    assert sharded._resolve_backend("cuda", cpu_mesh) == "cuda"
    assert sharded._resolve_backend("golden", cpu_mesh) == "golden"
    with pytest.raises(ValueError, match="unknown sharded backend"):
        sharded._resolve_backend("pallas", cpu_mesh)


def test_mesh_of_card_slots_without_a_card_raises(monkeypatch):
    """No fallback: a mesh of CUDA slots on a machine without CUDA raises
    before anything runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = make_mesh(1, 2, 2, devices=["cuda:0"] * 4)
    assert mesh.platform == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharded.sharded_motion_step(
            np.zeros((1, 16, 16), np.uint8), np.zeros((1, 16, 16), np.uint8),
            mesh=mesh, blk_dim=8, span=2, frame_height=16, frame_width=16)


def test_make_mesh():
    mesh = _mesh(2, 2, 2)
    assert mesh.shape == {"dp": 2, "ty": 2, "tx": 2}
    assert mesh.devices.shape == (2, 2, 2) and not mesh.ranks.any()
    assert mesh.local_slots() == mesh.slots() and len(mesh.slots()) == 8
    assert mesh.platform == "cpu"
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh(2, 2, 2, devices=[CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="have 0"):
            make_mesh(1, 1, 1)
    assert sharded.padded_dims_for_mesh(36, 52, 4, mesh) == \
        jax_sharded.padded_dims_for_mesh(36, 52, 4, jax_make_mesh(2, 2, 2))


# -- the tile entries, against the JAX ones -----------------------------------

def _tile(cur, ref, span, y0, x0, th, tw):
    """(cur tile, its halo) of a frame pair at (y0, x0), zero beyond the
    frame: the operands `halo_exchange_2d` gives a shard."""
    h, w = cur.shape
    big = np.zeros((h + th + 2 * span, w + tw + 2 * span), np.uint8)
    big[span : span + h, span : span + w] = ref
    cur_p = np.zeros((h + th, w + tw), np.uint8)
    cur_p[:h, :w] = cur
    return (torch.from_numpy(cur_p[y0 : y0 + th, x0 : x0 + tw].copy()),
            torch.from_numpy(big[y0 : y0 + th + 2 * span,
                                 x0 : x0 + tw + 2 * span].copy()))


# (h, w, blk, span, metric, (y0, x0), (th, tw)): interior tiles off the
# origin, the tile holding the truncated corner, and a tile reaching into
# the padding (whole padding blocks beside in-frame and truncated ones).
TILE_CASES = [
    (70, 100, 8, 5, "mse", (16, 24), (32, 48)),
    (70, 100, 8, 5, "sad", (48, 64), (32, 48)),
    (70, 100, 7, 4, "sad", (35, 49), (49, 56)),
    (70, 100, 8, 5, "mse", (40, 80), (48, 40)),
    (70, 100, 24, 3, "mse", (48, 72), (48, 48)),
    (70, 100, 8, 5, "ssim", (16, 24), (32, 48)),
    (70, 100, 8, 5, "ssim", (48, 64), (32, 48)),
    (70, 100, 40, 3, "ssim", (40, 40), (80, 80)),
]


@pytest.mark.parametrize("h,w,blk,span,metric,origin,tile", TILE_CASES)
def test_tile_entries_match_jax_golden_tile(h, w, blk, span, metric, origin,
                                            tile):
    """`full_search_tile_cuda` / `ssim_search_tile_cuda` and their volume
    entries (their plain versions here) against the JAX golden
    `full_search_tile` on every block that touches the frame; the blocks
    wholly in the padding hold the fixed fill."""
    rng = np.random.default_rng(h + blk + span)
    cur, ref = _pair(rng, h, w)
    (y0, x0), (th, tw) = origin, tile
    cur_t, halo = _tile(cur, ref, span, y0, x0, th, tw)
    kw = dict(frame_height=h, frame_width=w, blk_dim=blk, span=span)
    jf, jvol = jax_fs.full_search_tile(
        jax.numpy.asarray(_np(cur_t), jax.numpy.int32),
        jax.numpy.asarray(_np(halo), jax.numpy.int32), y0, x0, metric=metric,
        return_cost_volume=True, **kw)
    if metric == "ssim":
        cost, idx = sc.ssim_search_tile_cuda(cur_t, halo, y0, x0, **kw)
        vol = sc.ssim_volume_tile_cuda(cur_t, halo, y0, x0, **kw)
        jcost, fill, sentinel = jf.score, 0.0, -np.inf
    else:
        cost, idx = kc.full_search_tile_cuda(cur_t, halo, y0, x0,
                                             metric=metric, **kw)
        vol = kc.full_search_volume_tile_cuda(cur_t, halo, y0, x0,
                                              metric=metric, **kw)
        jcost, fill, sentinel = jf.best_cost_i32, INT32_MAX, INT32_MAX
    k = 2 * span + 1
    ny = max(0, min(th, -(-(h - y0) // blk) * blk)) // blk
    nx = max(0, min(tw, -(-(w - x0) // blk) * blk)) // blk
    got_mv = [g[:ny, :nx] for g in fs.geometry.mv_from_flat_index(idx, span)]
    np.testing.assert_array_equal(_np(got_mv[0]), np.asarray(jf.mv_y)[:ny, :nx])
    np.testing.assert_array_equal(_np(got_mv[1]), np.asarray(jf.mv_x)[:ny, :nx])
    tol = SCORE_ATOL if metric == "ssim" else 0
    np.testing.assert_allclose(_np(cost)[:ny, :nx],
                               np.asarray(jcost)[:ny, :nx], rtol=0, atol=tol)
    np.testing.assert_allclose(_np(vol)[:, :ny, :nx],
                               np.asarray(jvol)[:, :ny, :nx], rtol=0, atol=tol)
    pad = np.ones(cost.shape, bool)
    pad[:ny, :nx] = False
    assert (_np(cost)[pad] == fill).all()
    assert (_np(idx)[pad] == span * k + span).all()
    assert (_np(vol)[:, pad] == sentinel).all()


@pytest.mark.parametrize("metric", ["mse", "sad", "ssim"])
def test_tile_entries_match_jax_pallas_tile(metric):
    """An interior tile at a nonzero origin against the JAX Pallas tile
    entries in interpret mode (the phase kernel, the fast SSIM kernel at
    blk 8)."""
    from motionestimation_tpu.kernels import full_search_pallas as kp
    from motionestimation_tpu.kernels import ssim_pallas as ssim_kp

    rng = np.random.default_rng(5)
    h, w, blk, span = 64, 96, 8, 4
    cur, ref = _pair(rng, h, w)
    cur_t, halo = _tile(cur, ref, span, 16, 32, 32, 32)
    kw = dict(frame_height=h, frame_width=w, blk_dim=blk, span=span)
    jargs = (jax.numpy.asarray(_np(cur_t), jax.numpy.int32),
             jax.numpy.asarray(_np(halo), jax.numpy.int32), 16, 32)
    if metric == "ssim":
        got = sc.ssim_search_tile_cuda(cur_t, halo, 16, 32, **kw)
        want = ssim_kp.ssim_search_tile_pallas(*jargs, interpret=True, **kw)
    else:
        got = kc.full_search_tile_cuda(cur_t, halo, 16, 32, metric=metric,
                                       **kw)
        want = kp.full_search_tile_pallas(*jargs, metric=metric,
                                          interpret=True, **kw)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=0,
                               atol=SCORE_ATOL if metric == "ssim" else 0)


def test_tile_wholly_in_padding_searches_nothing(monkeypatch):
    """A tile past the frame runs no search (no kernel, no plain version:
    every one evaluates its costs through `make_displacement_cost`) and
    holds the fill."""
    def no_search(*a, **kw):
        raise AssertionError("a tile wholly in the padding was searched")

    monkeypatch.setattr(fs, "make_displacement_cost", no_search)
    cur_t = torch.zeros((16, 16), dtype=torch.uint8)
    halo = torch.zeros((20, 20), dtype=torch.uint8)
    kw = dict(frame_height=30, frame_width=40, blk_dim=8, span=2)
    cost, idx = kc.full_search_tile_cuda(cur_t, halo, 32, 0, **kw)
    assert (cost == INT32_MAX).all() and (idx == 12).all()
    score, idx = sc.ssim_search_tile_cuda(cur_t, halo, 0, 48, **kw)
    assert (score == 0).all() and (idx == 12).all()
    vol = kc.full_search_volume_tile_cuda(cur_t, halo, 32, 48, **kw)
    assert tuple(vol.shape) == (25, 2, 2) and (vol == INT32_MAX).all()
    with pytest.raises(ValueError, match="whole blocks"):
        kc.full_search_tile_cuda(cur_t[:12], halo, 0, 0, **kw)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("h,w,blk,span,metric,origin,tile", TILE_CASES)
def test_tile_entries_match_plain_cuda(cuda, h, w, blk, span, metric, origin,
                                       tile):
    rng = np.random.default_rng(h + blk + span)
    cur, ref = _pair(rng, h, w)
    (y0, x0), (th, tw) = origin, tile
    cur_t, halo = _tile(cur, ref, span, y0, x0, th, tw)
    kw = dict(frame_height=h, frame_width=w, blk_dim=blk, span=span)
    if metric == "ssim":
        entries = (sc.ssim_search_tile_cuda, sc.ssim_volume_tile_cuda)
    else:
        entries = tuple(functools.partial(f, metric=metric) for f in (
            kc.full_search_tile_cuda, kc.full_search_volume_tile_cuda))
    for entry in entries:
        got = entry(cur_t.to(cuda), halo.to(cuda), y0, x0, **kw)
        want = entry(cur_t, halo, y0, x0, **kw)
        for a, b in zip(got if isinstance(got, tuple) else [got],
                        want if isinstance(want, tuple) else [want]):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("ty,tx,h,w,blk,span,metric", [
    (2, 2, 70, 100, 8, 5, "mse"),
    (2, 2, 70, 100, 16, 7, "ssim"),
    (1, 4, 70, 100, 7, 5, "sad"),
    (2, 4, 32, 64, 8, 20, "mse"),
])
def test_sharded_on_one_card_matches_frame_entries_cuda(cuda, ty, tx, h, w,
                                                        blk, span, metric):
    rng = np.random.default_rng(blk + span)
    cur, ref = _pair(rng, h, w)
    mesh = make_mesh(1, ty, tx, devices=[cuda] * (ty * tx))
    mv_y, mv_x, cost, comp = sharded.sharded_full_search(
        cur, ref, mesh=mesh, blk_dim=blk, span=span, metric=metric)
    if metric == "ssim":
        want = sc.ssim_search_frame_cuda(cur, ref, blk_dim=blk, span=span)
        want_cost = want.score
    else:
        want = kc.full_search_frame_cuda(cur, ref, blk_dim=blk, span=span,
                                         metric=metric)
        want_cost = want.best_cost_i32
    assert torch.equal(mv_y, want.mv_y) and torch.equal(mv_x, want.mv_x)
    assert torch.equal(cost, want_cost)
    assert torch.equal(comp, fs.compensate_frame(
        torch.from_numpy(ref).to(cuda), want, frame_height=h, frame_width=w,
        blk_dim=blk, span=span))


@pytest.mark.parametrize("backend", BACKENDS, ids=BACKEND_IDS)
@pytest.mark.parametrize("algorithm", ["full", "diamond"])
def test_step_without_comp_gathers_no_frame(backend, algorithm):
    """`with_comp=False` (run_gop_sharded's per-pair path): MVs, costs and
    stats equal the full step's, `comp` is None, and no slot keeps a
    compensated tile for the gather to assemble."""
    rng = np.random.default_rng(31)
    h, w, blk, span = 40, 56, 8, 5
    refs = np.stack([_pair(rng, h, w)[1] for _ in range(2)])
    curs = np.clip(refs.astype(np.int32) + rng.integers(-8, 9, refs.shape),
                   0, 255).astype(np.uint8)
    kw = dict(mesh=_mesh(2, 2, 2), blk_dim=blk, span=span, frame_height=h,
              frame_width=w, backend=backend, algorithm=algorithm)
    want = _step(curs, refs, **kw)
    local = sharded.sharded_motion_step(curs, refs, with_comp=False, **kw)
    assert local.frame is None
    assert all(len(tiles) == 3 for tiles in local.tiles.values())
    got = sharded.gather(local)
    assert got.comp is None and want.comp is not None
    for name in ("mv_y", "mv_x", "best_cost", "sum_sq", "frame_max"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
