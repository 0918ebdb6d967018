"""Diamond search's lazy mode: the port against the JAX package, and its
kernel `me_diamond_walk` against its plain version.

On the CPU `search.diamond._diamond_lazy` runs `lazy_plain` (golden planes
near the trajectories, replayed by `replay_plain` pass by pass), which is
held on seeded frames (made with numpy; H and W not multiples of blk)
against

* JAX `diamond_search_frame(volume_mode="lazy")` (jitted) at max_steps >= 1:
  MVs, integer costs, flat indices and trajectories equal, SSIM scores
  within 1e-6 (jitted XLA fuses the float32 score arithmetic; ROADMAP.md
  "Held against");
* JAX `diamond_search_np` at every max_steps, 0 included (where JAX's lazy
  mode skips the SDSP step, a fault the port does not inherit): all equal,
  SSIM scores bit for bit, as against eager JAX (`jax.disable_jit()`);
* `volume_mode="auto"` at configs the staged path cannot take (blk 24 MSE,
  blk 40 SSIM, span 1), which must route to the lazy mode;
* an early threshold equal to a block's (0, 0) value, which stops that
  block there (the check is `<=` for MSE/SAD, `>=` for SSIM, before each
  round and after the last).

`walk_np` below is the kernel's per-block walk in numpy, with its memo of
evaluated candidates: it equals `lazy_plain`, and the candidates it
evaluates are those `bench/roofline.walk_evals` counts for the bound.

Tests whose names end in `_cuda` hold `walk_cuda` against `lazy_plain` on
the card, bit for bit (the early check stopping blocks in each early-term
case; at the equality threshold; on a walk longer than the kernel's memo),
hold the lazy mode on the card against `diamond_search_np` and JAX's lazy
mode, and check that it is one launch, with no golden plane, no replay and
no host sync; they skip where there is no card: `python -m pytest
--noconftest tests/test_torch_diamond_lazy.py -k cuda`.
"""
import jax
import numpy as np
import pytest
import torch

from motionestimation_tpu.search import diamond as jd
from motionestimation_tpu_torch.bench import roofline
from motionestimation_tpu_torch.kernels import diamond_cuda as dc
from motionestimation_tpu_torch.search import diamond as td
from motionestimation_tpu_torch.search import full_search as tfs

torch.set_num_threads(1)

SCORE_ATOL = 1e-6
EARLY = {"mse": 30.0, "sad": 4.0, "ssim": 0.8}


def _pair(seed, h, w, shift=(2, -3)):
    """A low-frequency reference and the current frame moved by `shift`
    with noise of +-2, as tests/test_diamond.py makes them."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float64)
    ref = np.clip(np.kron(small, np.ones((8, 8)))[:h, :w]
                  + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
    cur = np.roll(ref, shift, (0, 1)).astype(np.int32)
    cur = np.clip(cur + rng.integers(-2, 3, (h, w)), 0, 255).astype(np.uint8)
    return cur, ref


def _port(cur, ref, **kw):
    return td.diamond_search_frame(cur, ref, record_trajectory=True,
                                   device="cpu", **kw)


def _count(h, w, blk):
    """[nby, nbx] int64: each block's in-frame pixels."""
    return np.array([[min(blk, h - y) * min(blk, w - x)
                      for x in range(0, w, blk)] for y in range(0, h, blk)])


def _terminated(field, traj, *, early, h, w, blk, metric):
    """roofline.walk_terminated on a field and trajectory (any device)."""
    cost = field.score if metric == "ssim" else field.best_cost_i32
    return roofline.walk_terminated(
        field.mv_y.cpu().numpy(), field.mv_x.cpu().numpy(),
        cost.cpu().numpy(), traj.cpu().numpy(), early_term=early,
        count=_count(h, w, blk), minimise=metric != "ssim")


def _assert_matches_np(field, traj, golden, metric):
    """(field, traj) == diamond_search_np's: integer costs exactly, SSIM
    scores bit for bit."""
    mv_y, mv_x, best, g_traj = golden
    np.testing.assert_array_equal(traj.cpu().numpy(), g_traj)
    np.testing.assert_array_equal(field.mv_y.cpu().numpy(), mv_y)
    np.testing.assert_array_equal(field.mv_x.cpu().numpy(), mv_x)
    if metric == "ssim":
        np.testing.assert_array_equal(field.score.cpu().numpy(),
                                      best.astype(np.float32))
    else:
        np.testing.assert_array_equal(field.best_cost_i32.cpu().numpy(),
                                      best.astype(np.int64))


def _assert_matches_jax(field, traj, j_field, j_traj):
    """Every integer field and the trajectory equal, the float32 score
    exact for MSE/SAD and within SCORE_ATOL for SSIM."""
    for name in ("mv_y", "mv_x", "best_cost_i32"):
        want = np.asarray(getattr(j_field, name))
        got = getattr(field, name).cpu().numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_allclose(field.score.cpu().numpy(),
                               np.asarray(j_field.score), rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_array_equal(traj.cpu().numpy(), np.asarray(j_traj))


# --- the port's lazy mode against the JAX package --------------------------


@pytest.mark.parametrize("metric,early,steps", [
    ("mse", None, None), ("mse", "early", 3), ("sad", None, 2),
    ("sad", "early", None), ("ssim", None, None), ("ssim", "early", 1)])
def test_lazy_matches_jax_lazy(metric, early, steps):
    """The lazy mode against JAX's jitted lazy mode on a 44x70 frame (blk 8,
    truncated edge blocks), with and without the trajectory."""
    cur, ref = _pair(1, 44, 70)
    kw = dict(blk_dim=8, span=5, metric=metric, max_steps=steps,
              early_term=EARLY[metric] if early else None,
              volume_mode="lazy")
    field, traj = _port(cur, ref, **kw)
    j_field, j_traj = jd.diamond_search_frame(cur, ref,
                                              record_trajectory=True, **kw)
    _assert_matches_jax(field, traj, j_field, j_traj)
    bare = td.diamond_search_frame(cur, ref, device="cpu", **kw)
    for a, b in zip(bare, field):
        assert torch.equal(a, b)


@pytest.mark.parametrize("steps", [0, 1, 3, None])
@pytest.mark.parametrize("early", [None, "early"])
@pytest.mark.parametrize("metric", ["mse", "sad", "ssim"])
def test_lazy_matches_numpy_model(metric, early, steps):
    """The lazy mode against `diamond_search_np` at every max_steps, 0
    included (the SDSP step still runs)."""
    cur, ref = _pair(2, 44, 70, shift=(-3, 4))
    e = EARLY[metric] if early else None
    field, traj = _port(cur, ref, blk_dim=8, span=5, metric=metric,
                        early_term=e, max_steps=steps, volume_mode="lazy")
    _assert_matches_np(field, traj, jd.diamond_search_np(
        cur, ref, blk_dim=8, span=5, metric=metric, early_term=e,
        max_steps=steps), metric)


def test_ssim_bit_equal_to_eager_jax():
    """SSIM scores bit for bit against JAX's lazy mode run op by op."""
    cur, ref = _pair(3, 24, 36)
    kw = dict(blk_dim=8, span=3, metric="ssim", volume_mode="lazy")
    field, traj = _port(cur, ref, **kw)
    with jax.disable_jit():
        j_field, j_traj = jd.diamond_search_frame(
            cur, ref, record_trajectory=True, **kw)
    np.testing.assert_array_equal(field.score.numpy(),
                                  np.asarray(j_field.score))
    _assert_matches_jax(field, traj, j_field, j_traj)


@pytest.mark.parametrize("blk,span,metric,h,w", [
    (24, 5, "mse", 60, 80),    # blk 24: no emit mode takes it
    (40, 4, "ssim", 96, 80),   # SSIM above blk 32
    (8, 1, "mse", 44, 70),     # span < 2
    (8, 1, "ssim", 44, 70),
    (5, 1, "sad", 33, 47),
])
def test_auto_routes_unstaged_configs_to_lazy(monkeypatch, blk, span, metric,
                                              h, w):
    """volume_mode="auto" at a config `staged_supported` rejects runs the
    lazy mode, equal to JAX's auto mode and the numpy model."""
    assert not td.staged_supported(blk, span, metric)
    lazy_calls = []
    real = td._diamond_lazy

    def lazy(*a, **kw):
        lazy_calls.append(kw["blk_dim"])
        return real(*a, **kw)

    def staged(*a, **kw):
        raise AssertionError("the staged path ran")

    monkeypatch.setattr(td, "_diamond_lazy", lazy)
    monkeypatch.setattr(td, "_diamond_staged", staged)
    cur, ref = _pair(4, h, w, shift=(3, -2))
    kw = dict(blk_dim=blk, span=span, metric=metric)
    field, traj = _port(cur, ref, **kw)
    assert lazy_calls == [blk]
    j_field, j_traj = jd.diamond_search_frame(cur, ref,
                                              record_trajectory=True, **kw)
    _assert_matches_jax(field, traj, j_field, j_traj)
    _assert_matches_np(field, traj, jd.diamond_search_np(cur, ref, **kw),
                       metric)


def _threshold_at_a_centre(cur, ref, *, blk, span, metric, steps):
    """(threshold, (by, bx)): an early threshold equal to the check's value
    at (0, 0) for a block that the walk without the check moves away from
    (the float32 MSE/SAD per pixel, the least of such blocks', or the SSIM
    score, the greatest), so that the check passes there only by its
    equality."""
    h, w = cur.shape
    field = td.diamond_search_frame(cur, ref, blk_dim=blk, span=span,
                                    metric=metric, max_steps=steps,
                                    volume_mode="lazy", device="cpu")
    _, volume = tfs.full_search_frame(cur, ref, blk_dim=blk, span=span,
                                      metric=metric, return_cost_volume=True)
    centre = volume[span * (2 * span + 1) + span].numpy()
    moved = (field.mv_y.numpy() != 0) | (field.mv_x.numpy() != 0)
    assert moved.any()
    if metric == "ssim":
        flat = np.argmax(np.where(moved, centre, -np.inf))
        value = centre.flat[flat]
    else:
        per_px = (centre.astype(np.float32)
                  / _count(h, w, blk).astype(np.float32))
        flat = np.argmin(np.where(moved, per_px, np.inf))
        value = per_px.flat[flat]
    return float(value), np.unravel_index(flat, centre.shape)


EQUALITY_CASES = [(m, steps) for m in ("mse", "sad", "ssim")
                  for steps in (None, 0)]


@pytest.mark.parametrize("metric,steps", EQUALITY_CASES)
def test_early_check_passes_at_equality(metric, steps):
    """A block whose (0, 0) value equals the threshold stops there (before
    its first LDSP round, or with max_steps 0 before the SDSP step): the
    lazy mode equals `diamond_search_np` (and, for the integer costs,
    JAX's lazy mode at max_steps >= 1)."""
    cur, ref = _pair(10, 44, 70)
    blk, span = 8, 5
    steps = td.default_max_steps(span) if steps is None else steps
    thr, (by, bx) = _threshold_at_a_centre(cur, ref, blk=blk, span=span,
                                           metric=metric, steps=steps)
    kw = dict(blk_dim=blk, span=span, metric=metric, early_term=thr,
              max_steps=steps)
    field, traj = _port(cur, ref, volume_mode="lazy", **kw)
    assert (field.mv_y[by, bx], field.mv_x[by, bx]) == (0, 0)
    assert _terminated(field, traj, early=thr, h=44, w=70, blk=blk,
                       metric=metric)[by, bx]
    _assert_matches_np(field, traj, jd.diamond_search_np(cur, ref, **kw),
                       metric)
    if metric != "ssim" and steps >= 1:
        j_field, j_traj = jd.diamond_search_frame(
            cur, ref, record_trajectory=True, volume_mode="lazy", **kw)
        _assert_matches_jax(field, traj, j_field, j_traj)


def test_lazy_on_the_cpu_takes_the_plain_version(monkeypatch):
    """CPU frames run `lazy_plain` and launch no kernel."""
    calls = []
    real = td.lazy_plain
    monkeypatch.setattr(td, "lazy_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    before = (dc.walk_cuda.launches, dc.replay_cuda.launches)
    cur, ref = _pair(5, 32, 40)
    td.diamond_search_frame(cur, ref, blk_dim=8, span=4, volume_mode="lazy",
                            device="cpu")
    assert calls == [1]
    assert (dc.walk_cuda.launches, dc.replay_cuda.launches) == before


@pytest.mark.parametrize("metric", ["mse", "ssim"])
def test_walk_cuda_raises_on_cpu(metric):
    cur, ref = (torch.from_numpy(a) for a in _pair(5, 32, 40))
    with pytest.raises(ValueError, match="CUDA tensors"):
        dc.walk_cuda(cur, ref, blk_dim=8, span=4, metric=metric,
                     early_term=None, max_steps=6, record_trajectory=False)


# --- the kernel's walk in numpy, and the bound's count ----------------------


def walk_np(volume, *, blk_dim, span, metric, early_term, max_steps,
            frame_height, frame_width):
    """The kernel's walk, one block at a time, over the golden volume for
    the costs: (mv_y, mv_x, cost, trajectory, evaluated), `evaluated` the
    set of (block, flat displacement) it computed from pixels (in the
    window, valid for the block, each once: the memo)."""
    _, nby, nbx = volume.shape
    k = 2 * span + 1
    minimise = metric in ("mse", "sad")
    sentinel = volume.dtype.type(np.iinfo(np.int32).max if minimise
                                 else -np.inf)
    thr = None if early_term is None else np.float32(early_term)
    ldsp = [o for o in td.LDSP if o != (0, 0)]
    sdsp = [o for o in td.SDSP if o != (0, 0)]
    mv_y = np.zeros((nby, nbx), np.int32)
    mv_x = np.zeros((nby, nbx), np.int32)
    cost = np.zeros((nby, nbx), volume.dtype)
    traj = np.zeros((max_steps + 1, nby, nbx, 2), np.int32)
    evaluated = set()
    for by in range(nby):
        for bx in range(nbx):
            tl_y, tl_x = by * blk_dim, bx * blk_dim
            bh = min(blk_dim, frame_height - tl_y)
            bw = min(blk_dim, frame_width - tl_x)
            memo = {}

            def value(ty, tx):
                if abs(ty) > span or abs(tx) > span or not (
                        0 <= tl_y + ty <= frame_height - bh
                        and 0 <= tl_x + tx <= frame_width - bw):
                    return sentinel
                flat = (ty + span) * k + tx + span
                if flat not in memo:
                    memo[flat] = volume[flat, by, bx]
                    evaluated.add((by * nbx + bx, flat))
                return memo[flat]

            def early(c):
                if thr is None:
                    return False
                if minimise:
                    return np.float32(c) / np.float32(bh * bw) <= thr
                return c >= thr

            def step(cy, cx, c, pattern):
                wy = wx = 0
                for oy, ox in pattern:
                    v = value(cy + oy, cx + ox)
                    if (v < c) if minimise else (v > c):
                        wy, wx, c = oy, ox, v
                return wy, wx, c

            cy = cx = 0
            c = value(0, 0)
            for t in range(max_steps):
                if early(c):
                    traj[t + 1:, by, bx] = (cy, cx)
                    break
                wy, wx, c = step(cy, cx, c, ldsp)
                if (wy, wx) == (0, 0):
                    traj[t + 1:, by, bx] = (cy, cx)
                    break
                cy, cx = cy + wy, cx + wx
                traj[t + 1, by, bx] = (cy, cx)
            if not early(c):
                wy, wx, c = step(cy, cx, c, sdsp)
                cy, cx = cy + wy, cx + wx
            mv_y[by, bx], mv_x[by, bx], cost[by, bx] = cy, cx, c
    return mv_y, mv_x, cost, traj, evaluated


@pytest.mark.parametrize("metric,early,steps,blk,span,h,w", [
    ("mse", None, None, 8, 5, 44, 70),
    ("mse", 30.0, None, 8, 5, 44, 70),
    ("sad", 4.0, 2, 8, 7, 44, 70),
    ("ssim", None, 0, 8, 5, 44, 70),
    ("ssim", 0.8, None, 16, 4, 40, 56),
    ("mse", None, None, 24, 3, 60, 80),
])
def test_walk_model_equals_plain_and_its_evaluations_are_counted(
        metric, early, steps, blk, span, h, w):
    """`walk_np` (the kernel's walk) equals `lazy_plain` on MVs, costs or
    scores and trajectories; `walk_evals`, from that trajectory and
    `walk_terminated`, counts exactly the (block, candidate) pairs it
    evaluated, and their pixels."""
    cur, ref = _pair(6, h, w, shift=(4, -3))
    steps = td.default_max_steps(span) if steps is None else steps
    kw = dict(blk_dim=blk, span=span, metric=metric, early_term=early,
              max_steps=steps)
    field, traj = td.lazy_plain(torch.from_numpy(cur), torch.from_numpy(ref),
                                record_trajectory=True, **kw)
    _, volume = tfs.full_search_frame(cur, ref, blk_dim=blk, span=span,
                                      metric=metric, return_cost_volume=True)
    mv_y, mv_x, cost, m_traj, evaluated = walk_np(
        volume.numpy(), frame_height=h, frame_width=w, **kw)
    np.testing.assert_array_equal(field.mv_y.numpy(), mv_y)
    np.testing.assert_array_equal(field.mv_x.numpy(), mv_x)
    np.testing.assert_array_equal(traj.numpy(), m_traj)
    got_cost = field.score if metric == "ssim" else field.best_cost_i32
    np.testing.assert_array_equal(got_cost.numpy(), cost)

    count = _count(h, w, blk)
    terminated = roofline.walk_terminated(
        mv_y, mv_x, cost, m_traj, early_term=early, count=count,
        minimise=metric != "ssim")
    if early is not None:
        assert terminated.any()
    blocks, pixels = roofline.walk_evals(
        m_traj, span=span, blk_dim=blk, frame_height=h, frame_width=w,
        terminated=terminated)
    assert blocks == len(evaluated)
    assert pixels == sum(count.flat[b] for b, _ in evaluated)


def test_walk_bound_takes_the_larger_term():
    """Bytes: both frames once and the outputs; operations: 2 (SSD/SAD) or
    5 (SSIM) a pixel-candidate at the int8 peak, 34 float ops a
    block-candidate (SSIM) at the float32 rate."""
    ms, by = roofline.walk_bound(1080, 1920, nblocks=8160, block_evals=2e5,
                                 pixel_evals=5e7, metric="mse",
                                 trajectory_rows=18)
    nbytes = 2 * 1080 * 1920 + 8160 * (12 + 8 * 18)
    assert by == "bytes" and ms == pytest.approx(
        nbytes / roofline.HBM_BYTES_S * 1e3)
    ms, by = roofline.walk_bound(16, 16, nblocks=1, block_evals=1e9,
                                 pixel_evals=1e9, metric="ssim")
    assert by == "operations" and ms == pytest.approx(
        34e9 / roofline.FP32_OPS_S * 1e3)


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


CUDA_CASES = [
    # (h, w, blk, span, metric, early_term, max_steps, shift)
    (100, 180, 16, 15, "mse", None, None, (9, -11)),
    (100, 180, 16, 15, "sad", 3.0, None, (9, -11)),
    (100, 180, 16, 15, "ssim", None, None, (9, -11)),
    (100, 180, 16, 15, "ssim", 0.5, 4, (9, -11)),
    (97, 131, 8, 7, "mse", 600.0, 0, (2, -3)),
    (97, 131, 24, 15, "mse", None, None, (5, 7)),
    (130, 170, 40, 6, "ssim", None, None, (3, -2)),
    (61, 77, 5, 1, "sad", None, None, (1, 1)),
    (64, 64, 7, 31, "mse", None, None, (20, -17)),
]


@pytest.mark.parametrize("case", CUDA_CASES, ids=lambda c: "-".join(map(
    str, c[:7])))
@pytest.mark.parametrize("record", [True, False])
def test_walk_matches_plain_cuda(cuda, case, record):
    """me_diamond_walk == lazy_plain on the card: MVs, costs or scores
    (bit for bit) and trajectories, one launch."""
    h, w, blk, span, metric, early, steps, shift = case
    cur, ref = (torch.from_numpy(a).to(cuda)
                for a in _pair(7, h, w, shift=shift))
    kw = dict(blk_dim=blk, span=span, metric=metric, early_term=early,
              max_steps=td.default_max_steps(span) if steps is None
              else steps, record_trajectory=record)
    before = dc.walk_cuda.launches
    got, got_traj = dc.walk_cuda(cur, ref, **kw)
    torch.cuda.synchronize()
    assert dc.walk_cuda.launches == before + 1
    want, want_traj = td.lazy_plain(cur, ref, **kw)
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    if record:
        assert torch.equal(got_traj, want_traj)
        if early is not None:
            # The early check stopped blocks on the card.
            assert _terminated(got, got_traj, early=early, h=h, w=w,
                               blk=blk, metric=metric).any()
    else:
        assert got_traj is None and want_traj is None


@pytest.mark.parametrize("case", CUDA_CASES, ids=lambda c: "-".join(map(
    str, c[:7])))
def test_lazy_mode_equals_jax_cuda(cuda, case):
    """diamond_search_frame(volume_mode="lazy") on the card (the walk
    kernel) equals `diamond_search_np` at every max_steps and JAX's lazy
    mode at max_steps >= 1 on the same frames: MVs, integer costs and
    trajectories exactly, SSIM scores bit for bit against the numpy model
    and within SCORE_ATOL of jitted JAX."""
    h, w, blk, span, metric, early, steps, shift = case
    cur, ref = _pair(7, h, w, shift=shift)
    kw = dict(blk_dim=blk, span=span, metric=metric, early_term=early,
              max_steps=steps)
    before = dc.walk_cuda.launches
    field, traj = td.diamond_search_frame(cur, ref, record_trajectory=True,
                                          volume_mode="lazy", device=cuda,
                                          **kw)
    assert dc.walk_cuda.launches == before + 1
    _assert_matches_np(field, traj, jd.diamond_search_np(cur, ref, **kw),
                       metric)
    if steps != 0:
        j_field, j_traj = jd.diamond_search_frame(
            cur, ref, record_trajectory=True, volume_mode="lazy", **kw)
        _assert_matches_jax(field, traj, j_field, j_traj)


@pytest.mark.parametrize("metric,steps", EQUALITY_CASES)
def test_early_check_passes_at_equality_cuda(cuda, metric, steps):
    """The kernel's early check at a threshold equal to a block's (0, 0)
    value (`<=` for MSE/SAD, `>=` for SSIM; before the first round and,
    with max_steps 0, after the rounds): that block stops at (0, 0), and
    the result equals `lazy_plain`'s on the card bit for bit."""
    cur, ref = _pair(10, 44, 70)
    blk, span = 8, 5
    steps = td.default_max_steps(span) if steps is None else steps
    thr, (by, bx) = _threshold_at_a_centre(cur, ref, blk=blk, span=span,
                                           metric=metric, steps=steps)
    kw = dict(blk_dim=blk, span=span, metric=metric, early_term=thr,
              max_steps=steps, record_trajectory=True)
    cur_t, ref_t = (torch.from_numpy(a).to(cuda) for a in (cur, ref))
    got, got_traj = dc.walk_cuda(cur_t, ref_t, **kw)
    want, want_traj = td.lazy_plain(cur_t, ref_t, **kw)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
    assert torch.equal(got_traj, want_traj)
    assert (int(got.mv_y[by, bx]), int(got.mv_x[by, bx])) == (0, 0)
    assert _terminated(got, got_traj, early=thr, h=44, w=70, blk=blk,
                       metric=metric)[by, bx]


def test_walk_memo_overflow_cuda(cuda):
    """A walk longer than the kernel's memo of 256 evaluated candidates:
    on a horizontal ramp moved by 104 columns, the middle block row walks
    52 LDSP moves of (0, 2), each with 5 new valid candidates, so the memo
    fills and later candidates are computed again. The kernel equals
    `lazy_plain` on the card, `diamond_search_np` and JAX's lazy mode."""
    h, w, blk, span = 24, 240, 8, 104
    ref = np.tile(np.arange(w, dtype=np.uint8), (h, 1))
    cur = ref[:, np.minimum(np.arange(w) + 104, w - 1)].copy()
    kw = dict(blk_dim=blk, span=span, metric="mse", early_term=None,
              max_steps=td.default_max_steps(span))
    cur_t, ref_t = (torch.from_numpy(a).to(cuda) for a in (cur, ref))
    got, got_traj = dc.walk_cuda(cur_t, ref_t, record_trajectory=True, **kw)
    t = got_traj.cpu().numpy()
    moves = (np.abs(np.diff(t, axis=0)).sum(-1) > 0).sum(0)
    assert moves[1].max() >= 52  # 1 + 8 + 5 * 51 > 256 evaluations
    want, want_traj = td.lazy_plain(cur_t, ref_t, record_trajectory=True,
                                    **kw)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
    assert torch.equal(got_traj, want_traj)
    _assert_matches_np(got, got_traj, jd.diamond_search_np(cur, ref, **kw),
                       "mse")
    j_field, j_traj = jd.diamond_search_frame(
        cur, ref, record_trajectory=True, volume_mode="lazy", **kw)
    _assert_matches_jax(got, got_traj, j_field, j_traj)


def test_lazy_mode_frame_dtypes_cuda(cuda):
    """On the card the lazy mode takes integer frames in [0, 255] (int32
    gives the uint8 result) and raises on floating frames."""
    cur, ref = _pair(11, 40, 48)
    kw = dict(blk_dim=8, span=4, metric="sad", volume_mode="lazy",
              device=cuda, record_trajectory=True)
    field, traj = td.diamond_search_frame(cur, ref, **kw)
    f32, t32 = td.diamond_search_frame(cur.astype(np.int32),
                                       ref.astype(np.int32), **kw)
    assert torch.equal(traj, t32)
    for a, b in zip(field, f32):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="integer pixels"):
        td.diamond_search_frame(cur.astype(np.float32), ref, **kw)


def test_lazy_mode_is_one_launch_without_sync_cuda(cuda, monkeypatch):
    """volume_mode="lazy" and an auto call that falls back to lazy launch
    me_diamond_walk once each, evaluate no golden plane, replay nothing and
    sync the host with the card nowhere inside the lazy mode."""

    def forbidden(*a, **kw):
        raise AssertionError("a golden plane or a replay ran")

    cur, ref = (torch.from_numpy(a).to(cuda) for a in _pair(8, 97, 131))
    want = {m: td.lazy_plain(cur, ref, blk_dim=blk, span=7, metric="mse",
                             early_term=None, max_steps=9,
                             record_trajectory=True)
            for m, blk in (("lazy", 16), ("auto", 24))}
    for name in ("replay_cuda", "replay_plain"):
        monkeypatch.setattr(dc, name, forbidden)
    monkeypatch.setattr(tfs, "make_displacement_cost", forbidden)
    real = td._diamond_lazy

    def checked(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(td, "_diamond_lazy", checked)
    for mode, blk in (("lazy", 16), ("auto", 24)):
        before = dc.walk_cuda.launches
        field, traj = td.diamond_search_frame(
            cur, ref, blk_dim=blk, span=7, metric="mse",
            record_trajectory=True, volume_mode=mode, device=cuda)
        assert dc.walk_cuda.launches == before + 1
        w_field, w_traj = want[mode]
        assert torch.equal(traj, w_traj)
        for a, b in zip(field, w_field):
            assert torch.equal(a, b)


def test_walk_cuda_checks_frames_cuda(cuda):
    cur, ref = (torch.from_numpy(a).to(cuda) for a in _pair(9, 40, 48))
    kw = dict(blk_dim=8, span=4, metric="mse", early_term=None, max_steps=6,
              record_trajectory=False)
    with pytest.raises(ValueError, match="contiguous uint8"):
        dc.walk_cuda(cur.int(), ref, **kw)
    with pytest.raises(ValueError, match="contiguous uint8"):
        dc.walk_cuda(cur.t(), ref.t(), **kw)
    with pytest.raises(ValueError, match="shape"):
        dc.walk_cuda(cur, ref[:32].contiguous(), **kw)
