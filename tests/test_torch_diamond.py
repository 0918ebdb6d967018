"""The port's diamond search vs the JAX package, on the CPU.

* Trajectory parity with JAX `diamond_search_np` (the canonical numpy
  model) on the cases of tests/test_diamond.py: MVs, int32 costs and
  trajectories equal. SSIM scores are bit-equal to `diamond_search_np`'s,
  which evaluates JAX's `ssim_from_sums` eagerly, op by op.
* `diamond_search_frame(device="cpu")` against JAX `diamond_search_frame`
  (jitted) in every `volume_mode`: MVs, costs, flat indices and
  trajectories equal; SSIM scores within 1e-6 (jitted XLA fuses the float32
  score arithmetic; ROADMAP.md "Held against").
* The staged cases (escalation, SAD, blk 32, SSIM, early termination with
  escalation) and the crossover policy, as tests/test_diamond.py holds the
  JAX function.
* `_round_plan`, `_staged_levels` and `staged_supported` equal JAX's.
* `ssim_volume_cuda(device="cpu")` against JAX `ssim_volume_pallas`
  (interpret mode: its golden volume), -inf positions included; the emit
  modes' plain versions on edge slabs against JAX's golden tile volume.

Tests whose names end in `_cuda` hold the emit modes against their plain
versions, and diamond on the card against diamond on the CPU, and skip
where there is no card:
`python -m pytest --noconftest tests/test_torch_diamond.py -k cuda`.
"""
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from motionestimation_tpu.kernels import ssim_pallas as jsp
from motionestimation_tpu.search import diamond as jd
from motionestimation_tpu.search import full_search as jfs
from motionestimation_tpu_torch.kernels import full_search_cuda as kc
from motionestimation_tpu_torch.kernels import ssim_cuda as sc
from motionestimation_tpu_torch.search import diamond as td
from motionestimation_tpu_torch.search import full_search as tfs

# The tests run in several worker processes on shared cores; one torch
# thread per worker keeps them from oversubscribing the machine.
torch.set_num_threads(1)

SCORE_ATOL = 1e-6
WRAPPERS = (kc.phase_search, kc.int_search, kc.chunked_search,
            sc.ssim_fast_search, sc.ssim_search)


def _smooth(rng, h, w):
    """Low-frequency random image, as tests/test_diamond.py makes it."""
    small = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float64)
    up = np.kron(small, np.ones((8, 8)))[:h, :w]
    return np.clip(up + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)


def _pair(rng, h, w, dy, dx):
    ref = _smooth(rng, h, w)
    cur = np.roll(ref, (dy, dx), (0, 1))
    cur = np.clip(
        cur.astype(np.int32) + rng.integers(-2, 3, (h, w)), 0, 255
    ).astype(np.uint8)
    return cur, ref


def _launches():
    return [fn.launches for fn in WRAPPERS]


def _assert_matches_np(field, traj, golden, metric):
    """Port (field, traj) == diamond_search_np's (mv_y, mv_x, cost, traj):
    integer costs exactly, SSIM scores bit for bit."""
    mv_y, mv_x, best, g_traj = golden
    np.testing.assert_array_equal(traj.numpy(), g_traj)
    np.testing.assert_array_equal(field.mv_y.numpy(), mv_y)
    np.testing.assert_array_equal(field.mv_x.numpy(), mv_x)
    if metric == "ssim":
        assert field.score.dtype == torch.float32
        np.testing.assert_array_equal(field.score.numpy(),
                                      best.astype(np.float32))
    else:
        assert field.best_cost_i32.dtype == torch.int32
        np.testing.assert_array_equal(field.best_cost_i32.numpy(),
                                      best.astype(np.int64))


def _assert_matches_jax(field, jax_field, traj=None, jax_traj=None):
    """Port vs JAX diamond_search_frame: every integer field equal, the
    float32 score exact for MSE/SAD and within SCORE_ATOL for SSIM."""
    for name in ("mv_y", "mv_x", "best_cost_i32"):
        want = np.asarray(getattr(jax_field, name))
        got = getattr(field, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    want = np.asarray(jax_field.score)
    assert field.score.dtype == torch.float32
    np.testing.assert_allclose(field.score.numpy(), want, rtol=0,
                               atol=SCORE_ATOL)
    if traj is not None:
        np.testing.assert_array_equal(traj.numpy(), np.asarray(jax_traj))


CASES = [
    # h, w, blk, span, metric, early_term (tests/test_diamond.py:26-34)
    (48, 64, 8, 7, "mse", None),
    (48, 64, 8, 7, "mse", 50.0),
    (52, 60, 8, 5, "mse", None),     # truncated edge blocks
    (64, 64, 16, 15, "mse", None),
    (48, 64, 8, 7, "ssim", None),
    (48, 64, 8, 7, "ssim", 0.9),
]


@pytest.mark.parametrize("h,w,blk,span,metric,early", CASES)
def test_trajectory_parity(h, w, blk, span, metric, early):
    rng = np.random.default_rng(h * w + blk + span)
    cur, ref = _pair(rng, h, w, 2, -3)
    golden = jd.diamond_search_np(cur, ref, blk_dim=blk, span=span,
                                  metric=metric, early_term=early)
    before = _launches()
    field, traj = td.diamond_search_frame(
        cur, ref, blk_dim=blk, span=span, metric=metric, early_term=early,
        record_trajectory=True, device="cpu",
    )
    assert _launches() == before  # the CPU runs the plain versions
    _assert_matches_np(field, traj, golden, metric)


@pytest.mark.parametrize("mode", ["auto", "staged", "lazy", "full"])
@pytest.mark.parametrize("metric,early", [("mse", 40.0), ("sad", None),
                                          ("ssim", None)])
def test_volume_modes_match_jax(mode, metric, early):
    """Every volume_mode on a frame with truncated edges, against the JAX
    function in the same mode and the numpy model."""
    rng = np.random.default_rng(5)
    cur, ref = _pair(rng, 52, 60, 3, -2)
    kw = dict(blk_dim=8, span=7, metric=metric, early_term=early,
              record_trajectory=True, volume_mode=mode)
    j_field, j_traj = jd.diamond_search_frame(cur, ref, **kw)
    field, traj = td.diamond_search_frame(cur, ref, device="cpu", **kw)
    _assert_matches_jax(field, j_field, traj, j_traj)
    _assert_matches_np(field, traj, jd.diamond_search_np(
        cur, ref, blk_dim=8, span=7, metric=metric, early_term=early),
        metric)


@pytest.mark.parametrize("shift", [(1, -2), (6, 5)])
def test_staged_equals_golden(shift):
    """Staged volumes at span 7 (one level) on content that stays near the
    centre and content that travels."""
    rng = np.random.default_rng(17)
    cur, ref = _pair(rng, 48, 64, *shift)
    field, traj = td.diamond_search_frame(
        cur, ref, blk_dim=8, span=7, metric="mse", record_trajectory=True,
        volume_mode="staged", device="cpu",
    )
    _assert_matches_np(field, traj, jd.diamond_search_np(
        cur, ref, blk_dim=8, span=7, metric="mse"), "mse")


@pytest.mark.parametrize(
    "blk,span,metric,shift,hw",
    [
        (8, 7, "sad", (1, -2), (48, 64)),      # SAD staged, level 1 only
        (8, 15, "sad", (6, 5), (48, 64)),      # SAD staged, escalation
        (32, 12, "mse", (2, -1), (96, 128)),   # blk 32
        (32, 12, "mse", (9, -8), (96, 128)),   # blk 32, escalation
        (32, 7, "sad", (1, 2), (100, 170)),    # blk 32 SAD, truncated edges
    ],
)
def test_staged_sad_blk32_equals_golden(blk, span, metric, shift, hw):
    h, w = hw
    rng = np.random.default_rng(blk * span + h)
    cur, ref = _pair(rng, h, w, *shift)
    assert td.staged_supported(blk, span, metric)
    field, traj = td.diamond_search_frame(
        cur, ref, blk_dim=blk, span=span, metric=metric,
        record_trajectory=True, volume_mode="staged", device="cpu",
    )
    _assert_matches_np(field, traj, jd.diamond_search_np(
        cur, ref, blk_dim=blk, span=span, metric=metric), metric)


@pytest.mark.parametrize("metric,early", [("mse", 40.0), ("sad", 4.0)])
def test_staged_early_term_with_escalation(metric, early):
    """Early termination across levels (span 15: levels 6 and 15), with
    truncated blocks in the per-pixel threshold."""
    rng = np.random.default_rng(99)
    cur, ref = _pair(rng, 52, 68, 6, 5)
    field, traj = td.diamond_search_frame(
        cur, ref, blk_dim=8, span=15, metric=metric, early_term=early,
        record_trajectory=True, volume_mode="staged", device="cpu",
    )
    _assert_matches_np(field, traj, jd.diamond_search_np(
        cur, ref, blk_dim=8, span=15, metric=metric, early_term=early),
        metric)


@pytest.mark.parametrize(
    "h,w,blk,span,shift",
    [
        (48, 64, 8, 12, (1, -2)),    # level 1 only
        (44, 52, 8, 15, (6, 5)),     # escalation + truncated edges
        (48, 80, 16, 15, (6, 5)),    # blk 16 escalation
    ],
)
def test_staged_ssim_equals_golden(h, w, blk, span, shift):
    """Staged SSIM (the score volumes' plain versions on the CPU): the
    numpy model's MVs, trajectories and scores, the port's full replay's
    flat indices and scores exactly, and JAX's full replay within 1e-6."""
    rng = np.random.default_rng(h + w + span)
    cur, ref = _pair(rng, h, w, *shift)
    assert td.staged_supported(blk, span, "ssim")
    kw = dict(blk_dim=blk, span=span, metric="ssim")
    field, traj = td.diamond_search_frame(
        cur, ref, record_trajectory=True, volume_mode="staged",
        device="cpu", **kw)
    _assert_matches_np(field, traj, jd.diamond_search_np(cur, ref, **kw),
                       "ssim")
    full = td.diamond_search_frame(cur, ref, volume_mode="full",
                                   device="cpu", **kw)
    for a, b in zip(field, full):
        assert torch.equal(a, b)
    _assert_matches_jax(field, jd.diamond_search_frame(
        cur, ref, volume_mode="full", **kw))


class TestCrossoverPolicy:
    """escape_policy="crossover": blocks escaping the first level take the
    full-search optimum; equal to the JAX package's policy."""

    def test_no_escape_identical_to_canonical(self):
        rng = np.random.default_rng(3)
        # A noise-free shift of one larger plane: every block has an exact
        # zero-cost match at (-1, +2), nothing escapes.
        big = _smooth(rng, 72, 104)
        ref = big[4:68, 4:100]
        cur = big[3:67, 6:102]
        kw = dict(blk_dim=8, span=15, device="cpu")
        f_c = td.diamond_search_frame(cur, ref, escape_policy="crossover",
                                      **kw)
        f_n = td.diamond_search_frame(cur, ref, **kw)
        for a, b in zip(f_c, f_n):
            assert torch.equal(a, b)

    def test_adversarial_escapes_take_full_search_optimum(self):
        rng = np.random.default_rng(4)
        cur, ref = _pair(rng, 64, 96, 13, -13)  # past the level-1 radius
        kw = dict(blk_dim=8, span=15)
        f_c = td.diamond_search_frame(cur, ref, escape_policy="crossover",
                                      device="cpu", **kw)
        f_n = td.diamond_search_frame(cur, ref, device="cpu", **kw)
        full = tfs.full_search_frame(torch.from_numpy(cur),
                                     torch.from_numpy(ref), **kw)
        assert (f_c.best_cost_i32 <= f_n.best_cost_i32).all()
        differs = (f_c.mv_y != f_n.mv_y) | (f_c.mv_x != f_n.mv_x)
        assert differs.any(), "the adversarial shift must escape"
        for a, b in zip(f_c, full):
            assert torch.equal(a[differs], b[differs])
        _assert_matches_jax(f_c, jd.diamond_search_frame(
            cur, ref, escape_policy="crossover", **kw))

    def test_crossover_rejects_unsupported_modes(self):
        rng = np.random.default_rng(5)
        cur, ref = _pair(rng, 48, 64, 1, 1)
        for kw in (dict(span=7, metric="ssim"),
                   dict(span=15, volume_mode="lazy"),
                   dict(span=15, record_trajectory=True)):
            with pytest.raises(ValueError, match="crossover"):
                td.diamond_search_frame(cur, ref, blk_dim=8,
                                        escape_policy="crossover",
                                        device="cpu", **kw)


def test_rejects_bad_arguments():
    cur, ref = _pair(np.random.default_rng(6), 32, 32, 1, 1)
    kw = dict(blk_dim=8, span=7, device="cpu")
    for args, extra, match in (
        ((cur, ref[:, :24]), {}, "identical shapes"),
        ((cur, ref), dict(metric="ncc"), "unknown metric"),
        ((cur, ref), dict(volume_mode="eager"), "unknown volume_mode"),
        ((cur, ref), dict(escape_policy="greedy"), "unknown escape_policy"),
    ):
        with pytest.raises(ValueError, match=match):
            td.diamond_search_frame(*args, **kw, **extra)


@pytest.mark.parametrize("span", range(1, 32))
def test_round_plan_and_levels_match_jax(span):
    max_steps = td.default_max_steps(span)
    assert max_steps == jd.default_max_steps(span)
    assert td._round_plan(span, max_steps) == jd._round_plan(span, max_steps)
    assert td._staged_levels(span) == jd._staged_levels(span)
    assert (td.LDSP, td.SDSP) == (jd.LDSP, jd.SDSP)


def test_staged_supported_matches_jax():
    for blk in range(1, 41):
        for span in range(5):
            for metric in ("mse", "sad", "ssim"):
                assert td.staged_supported(blk, span, metric) == (
                    jd.staged_supported(blk, span, metric)), (blk, span,
                                                             metric)


@pytest.mark.parametrize("h,w,blk,span", [
    (37, 45, 4, 3), (45, 61, 8, 3), (40, 56, 16, 3), (70, 90, 32, 2),
])
def test_ssim_volume_matches_jax(h, w, blk, span):
    """ssim_volume_cuda on the CPU (the emit modes' plain versions) on a
    frame whose last block row and column are both truncated: the port's
    golden volume exactly, JAX's within 1e-6 with -inf at the same
    entries."""
    rng = np.random.default_rng(h * w + blk)
    cur, ref = _pair(rng, h, w, 1, -2)
    before = _launches()
    got = sc.ssim_volume_cuda(cur, ref, blk_dim=blk, span=span, device="cpu")
    assert _launches() == before
    _, golden = tfs.full_search_frame(
        torch.from_numpy(cur), torch.from_numpy(ref), blk_dim=blk, span=span,
        metric="ssim", return_cost_volume=True)
    assert got.dtype == torch.float32 and torch.equal(got, golden)
    want = np.asarray(jsp.ssim_volume_pallas(cur, ref, blk_dim=blk,
                                             span=span, interpret=True))
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isfinite(got[~np.isneginf(got)]).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)


def test_ssim_volume_rejects_unsupported():
    cur, ref = _pair(np.random.default_rng(7), 40, 40, 1, 1)
    for blk, span in ((40, 3), (8, 0)):
        with pytest.raises(ValueError, match="ssim_volume_cuda requires"):
            sc.ssim_volume_cuda(cur, ref, blk_dim=blk, span=span,
                                device="cpu")


@pytest.mark.parametrize("metric", ["mse", "sad", "ssim"])
@pytest.mark.parametrize("side", ["bottom", "right"])
def test_slab_volumes_match_jax(metric, side):
    """The slab emit modes' plain versions (`int_search` / `ssim_search`
    with `return_volume` on the CPU) against JAX's golden tile volume on
    the same slab, as `full_search_volume_pallas` and `_ssim_volume_jit`
    compute their edge slabs."""
    h, w, blk, span = 45, 58, 8, 4
    cur, ref = _pair(np.random.default_rng(8), h, w, 1, 2)
    cur_t = torch.from_numpy(cur)
    halo = F.pad(torch.from_numpy(ref), (span, span, span, span))
    slab = kc.bottom_slab if side == "bottom" else kc.right_slab
    cur_s, halo_s, org = slab(cur_t, halo, blk, span)
    y0, x0 = (org, 0) if side == "bottom" else (0, org)
    kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w,
              y_origin=y0, x_origin=x0, return_volume=True)
    if metric == "ssim":
        *_, got = sc.ssim_search(cur_s, halo_s, **kw)
    else:
        *_, got = kc.int_search(cur_s, halo_s, metric=metric, **kw)
    cur_p = jfs.pad_cur_frame(cur, h, w, blk)
    halo_p = jfs.make_ref_halo(ref, h, w, blk, span)
    if side == "bottom":
        tile = (cur_p[y0 : y0 + blk], halo_p[y0 : y0 + blk + 2 * span])
    else:
        tile = (cur_p[:, x0 : x0 + blk], halo_p[:, x0 : x0 + blk + 2 * span])
    _, want = jfs.full_search_tile(
        *tile, y0, x0, frame_height=h, frame_width=w, blk_dim=blk,
        span=span, metric=metric, return_cost_volume=True)
    want = np.asarray(want)
    assert got.shape == want.shape
    if metric == "ssim":
        np.testing.assert_array_equal(np.isneginf(got.numpy()),
                                      np.isneginf(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=SCORE_ATOL)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(cuda, h, w, span, seed):
    cur, ref = _pair(np.random.default_rng(seed), h, w, 2, -3)
    cur_t = torch.from_numpy(cur).to(cuda)
    halo = F.pad(torch.from_numpy(ref).to(cuda), (span, span, span, span))
    return cur_t, halo


def _assert_exact(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("fn,plain,blk,span,metric", [
    (kc.int_search, kc.search_plain, 8, 5, "mse"),
    (kc.int_search, kc.search_plain, 16, 15, "sad"),
    (kc.int_search, kc.search_plain, 40, 3, "mse"),
    (sc.ssim_search, sc.ssim_plain, 16, 15, None),
    (sc.ssim_search, sc.ssim_plain, 40, 3, None),
    (sc.ssim_fast_search, sc.ssim_plain, 16, 15, None),
    (sc.ssim_fast_search, sc.ssim_plain, 7, 4, None),
    (sc.ssim_fast_search, sc.ssim_plain, 32, 6, None),
])
def test_emit_matches_plain_cuda(cuda, fn, plain, blk, span, metric):
    """Each new emit mode on its tile (the whole blocks for the fast
    kernel, the whole truncated frame otherwise): cost or score, index and
    every volume entry, -inf / INT32_MAX included, exactly."""
    h, w = 90, 170
    cur_t, halo = _operands(cuda, h, w, span, blk + span)
    if fn is sc.ssim_fast_search:
        cur_t = cur_t[: h // blk * blk, : w // blk * blk]
    kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w,
              return_volume=True)
    if metric is not None:
        kw["metric"] = metric
    before = (fn.launches, fn.volume_launches)
    got = fn(cur_t, halo, **kw)
    assert (fn.launches, fn.volume_launches) == (before[0] + 1,
                                                 before[1] + 1)
    _assert_exact(got, plain(cur_t, halo, **kw))
    # Without a volume the search instances are launched, with equal results.
    kw.pop("return_volume")
    _assert_exact(fn(cur_t, halo, **kw), got[:2])
    assert fn.volume_launches == before[1] + 1


@pytest.mark.parametrize("h,w,blk,span,metric", [
    (90, 170, 16, 15, "ssim"), (45, 61, 8, 3, "ssim"), (70, 90, 32, 2, "ssim"),
    (37, 45, 4, 3, "ssim"), (90, 170, 16, 6, "mse"), (90, 170, 16, 15, "sad"),
    (47, 61, 7, 5, "sad"),
])
def test_volume_matches_golden_cuda(cuda, h, w, blk, span, metric):
    cur, ref = _pair(np.random.default_rng(h + blk), h, w, 1, -2)
    if metric == "ssim":
        got = sc.ssim_volume_cuda(cur, ref, blk_dim=blk, span=span,
                                  device=cuda)
    else:
        got = kc.full_search_volume_cuda(cur, ref, blk_dim=blk, span=span,
                                         metric=metric, device=cuda)
    _, want = tfs.full_search_frame(
        torch.from_numpy(cur).to(cuda), torch.from_numpy(ref).to(cuda),
        blk_dim=blk, span=span, metric=metric, return_cost_volume=True)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("metric,early,shift,policy", [
    ("mse", None, (2, -3), "canonical"), ("sad", None, (6, 5), "canonical"),
    ("ssim", None, (6, 5), "canonical"), ("mse", 40.0, (6, 5), "canonical"),
    ("mse", None, (13, -13), "crossover"),
])
def test_diamond_matches_cpu_cuda(cuda, metric, early, shift, policy):
    """Diamond on the card (staged volumes from the emit modes) equals
    diamond on the CPU (their plain versions), which the tests above hold
    against the JAX package."""
    cur, ref = _pair(np.random.default_rng(9), 90, 170, *shift)
    kw = dict(blk_dim=16, span=15, metric=metric, early_term=early,
              escape_policy=policy, volume_mode="staged",
              record_trajectory=policy == "canonical")
    got = td.diamond_search_frame(cur, ref, device=cuda, **kw)
    want = td.diamond_search_frame(cur, ref, device="cpu", **kw)
    if policy == "canonical":
        (got, got_traj), (want, want_traj) = got, want
        assert torch.equal(got_traj.cpu(), want_traj)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
