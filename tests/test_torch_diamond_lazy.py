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

`walk_np` below is the kernel's per-block walk in numpy, which skips the
targets the previous LDSP round evaluated (none can beat the centre it moved
to) and keeps no memo: it equals `lazy_plain`, the distinct candidates it
evaluates are those `bench/roofline.walk_evals` counts for the bound, and it
counts the evaluations the kernel makes. Frames whose pixels depend only on
y + x or y - x make LDSP candidates tie below the centre, and flat frames
make all of them tie with it: the tie rule (strictly better than the
centre, the first in pattern order among equals).

Tests whose names end in `_cuda` hold `walk_cuda` against `lazy_plain` on
the card, bit for bit, at every team shape of the kernel and its edges
(blk 1, 8, 9, 16, 17, 32, 33, 64, 70 and 130; walk counts that are not a
multiple of the walks a CUDA block; truncated blocks with bw not a multiple
of 4; span 0; the tie frames; frames at unaligned addresses; the early
check stopping blocks in each early-term case; at the equality threshold; a
52-move walk), hold the lazy mode on the card against `diamond_search_np`
and JAX's lazy mode, and check that it is one launch, with no golden plane,
no replay and no host sync; they skip where there is no card: `python -m
pytest --noconftest tests/test_torch_diamond_lazy.py -k cuda`.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from motionestimation_tpu.search import diamond as jd
from motionestimation_tpu_torch.bench import roofline
from motionestimation_tpu_torch.kernels import diamond_cuda as dc
from motionestimation_tpu_torch.search import diamond as td
from motionestimation_tpu_torch.search import full_search as tfs
from motionestimation_tpu_torch.tools import kernel_turns

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


def _tie_frames(kind, h, w):
    """(cur, ref) of a tie case: "flat" frames (every candidate ties with
    the centre), or a reference whose pixels depend only on y + x ("sum") or
    y - x ("diff") with the current frame moved two steps along that sum,
    so that the three LDSP candidates of that sum tie below the centre:
    (0, 2), (1, 1), (2, 0) for "sum+2", (-2, 0), (-1, -1), (0, -2) for
    "sum-2", (0, -2), (1, -1), (2, 0) for "diff+2"."""
    if kind == "flat":
        cur = np.full((h, w), 117, np.uint8)
        return cur, cur.copy()
    f = np.random.default_rng(12).integers(0, 256, h + w + 8).astype(np.uint8)
    y, x = np.mgrid[:h, :w]
    s = y + x if kind.startswith("sum") else y - x + w
    return f[s + 4 + int(kind[-2:])], f[s + 4]


# The first tied candidate in pattern order: the MV of a block the tie
# content leaves inside the frame.
TIE_MV = {"flat": (0, 0), "sum+2": (0, 2), "sum-2": (-2, 0),
          "diff+2": (0, -2)}
TIE_CASES = [(blk, metric, kind) for blk in (8, 24, 40, 70)
             for metric in ("mse", "sad", "ssim") for kind in TIE_MV]


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
    monkeypatch.setattr(td, "_staged_search", staged)
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


@pytest.mark.parametrize("blk,metric,kind", TIE_CASES)
def test_lazy_ties_match_numpy_model(blk, metric, kind):
    """On tie frames the lazy mode equals `diamond_search_np`, and a block
    inside the frame takes the first tied candidate in pattern order (or
    holds its centre on flat frames)."""
    cur, ref = _tie_frames(kind, 3 * blk + 5, 4 * blk + 3)
    kw = dict(blk_dim=blk, span=5, metric=metric)
    field, traj = _port(cur, ref, volume_mode="lazy", **kw)
    _assert_matches_np(field, traj, jd.diamond_search_np(cur, ref, **kw),
                       metric)
    assert (int(field.mv_y[1, 1]), int(field.mv_x[1, 1])) == TIE_MV[kind]


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


def test_kernel_turns_walk_groups_take_walk_labels():
    """tools/kernel_turns.py's walk cells are cases of `chip_smoke.py`'s
    lazy phase (content, blk, span, metric, early term); --group takes
    their labels beside GROUPS' and still refuses an unknown label before
    anything needs a card, and a walk cell asks for the card."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lazy = {run[2:7] for run in smoke.LAZY_RUNS}
    for label, *case in kernel_turns.WALK_GROUPS:
        assert tuple(case) in lazy, label
    with pytest.raises(ValueError, match="unknown groups"):
        kernel_turns.main(["--group", "lazy 4K 8x8 +-31 mse", "no such"])
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_turns.main(["--group", "lazy 1080p 24x24 +-15 mse"])


def test_walk_occupancy_rejects_what_the_kernel_does_not_take():
    for blk, metric in ((0, "mse"), (8, "psnr")):
        with pytest.raises(ValueError, match="no walk kernel"):
            dc.walk_occupancy(blk, metric)


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
    the costs: (mv_y, mv_x, cost, trajectory, evaluated, evaluations),
    `evaluated` the set of distinct (block, flat displacement) pairs it
    computed from pixels (in the window, valid for the block) and
    `evaluations` how many computations that took. Like the kernel it keeps
    no memo: after a move of m it skips the candidates p with |m + p|_1 in
    {0, 2}, which the previous round evaluated and which cannot beat the
    new centre (the sentinel stands in for them), and computes the rest,
    also where an older round saw them."""
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
    evaluations = 0
    for by in range(nby):
        for bx in range(nbx):
            tl_y, tl_x = by * blk_dim, bx * blk_dim
            bh = min(blk_dim, frame_height - tl_y)
            bw = min(blk_dim, frame_width - tl_x)

            def value(ty, tx):
                nonlocal evaluations
                if abs(ty) > span or abs(tx) > span or not (
                        0 <= tl_y + ty <= frame_height - bh
                        and 0 <= tl_x + tx <= frame_width - bw):
                    return sentinel
                flat = (ty + span) * k + tx + span
                evaluated.add((by * nbx + bx, flat))
                evaluations += 1
                return volume[flat, by, bx]

            def early(c):
                if thr is None:
                    return False
                if minimise:
                    return np.float32(c) / np.float32(bh * bw) <= thr
                return c >= thr

            def step(cy, cx, c, pattern, move=None):
                wy = wx = 0
                for oy, ox in pattern:
                    seen = move is not None and abs(move[0] + oy) + abs(
                        move[1] + ox) in (0, 2)
                    v = sentinel if seen else value(cy + oy, cx + ox)
                    if (v < c) if minimise else (v > c):
                        wy, wx, c = oy, ox, v
                return wy, wx, c

            cy = cx = 0
            c = value(0, 0)
            move = None
            for t in range(max_steps):
                if early(c):
                    traj[t + 1:, by, bx] = (cy, cx)
                    break
                wy, wx, c = step(cy, cx, c, ldsp, move)
                if (wy, wx) == (0, 0):
                    traj[t + 1:, by, bx] = (cy, cx)
                    break
                cy, cx, move = cy + wy, cx + wx, (wy, wx)
                traj[t + 1, by, bx] = (cy, cx)
            if not early(c):
                wy, wx, c = step(cy, cx, c, sdsp)
                cy, cx = cy + wy, cx + wx
            mv_y[by, bx], mv_x[by, bx], cost[by, bx] = cy, cx, c
    return mv_y, mv_x, cost, traj, evaluated, evaluations


MODEL_CASES = [
    ("mse", None, None, 8, 5, 44, 70, "pair"),
    ("mse", 30.0, None, 8, 5, 44, 70, "pair"),
    ("sad", 4.0, 2, 8, 7, 44, 70, "pair"),
    ("ssim", None, 0, 8, 5, 44, 70, "pair"),
    ("ssim", 0.8, None, 16, 4, 40, 56, "pair"),
    ("mse", None, None, 24, 3, 60, 80, "pair"),
    ("mse", None, None, 8, 9, 44, 70, "sum+2"),
    ("ssim", None, None, 8, 9, 44, 70, "diff+2"),
    ("sad", None, None, 8, 5, 44, 70, "flat"),
]


@pytest.mark.parametrize(
    "metric,early,steps,blk,span,h,w,content", MODEL_CASES,
    ids=["-".join(map(str, c[:7] if c[7] == "pair" else c))
         for c in MODEL_CASES])
def test_walk_model_equals_plain_and_its_evaluations_are_counted(
        metric, early, steps, blk, span, h, w, content):
    """`walk_np` (the kernel's walk, skipping the targets the previous
    round evaluated) equals `lazy_plain` on MVs, costs or scores and
    trajectories; `walk_evals`, from that trajectory and
    `walk_terminated`, counts exactly the distinct (block, candidate)
    pairs it evaluated, and their pixels; the kernel's evaluations, which
    compute a target an older round saw again, number at least as
    many."""
    cur, ref = (_pair(6, h, w, shift=(4, -3)) if content == "pair"
                else _tie_frames(content, h, w))
    steps = td.default_max_steps(span) if steps is None else steps
    kw = dict(blk_dim=blk, span=span, metric=metric, early_term=early,
              max_steps=steps)
    field, traj = td.lazy_plain(torch.from_numpy(cur), torch.from_numpy(ref),
                                record_trajectory=True, **kw)
    _, volume = tfs.full_search_frame(cur, ref, blk_dim=blk, span=span,
                                      metric=metric, return_cost_volume=True)
    mv_y, mv_x, cost, m_traj, evaluated, evaluations = walk_np(
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
    assert evaluations >= len(evaluated)


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
    # Every instance and its edges: blk 1 (667 walks, not a multiple of
    # the four one-warp walks a CUDA block), 8 (bw 5, bh 3), 9 (bw 2, bh
    # 2), 16 (bw 7); 17 and 32 (128 threads a walk, 35 and 15 walks for
    # two a CUDA block; bw 3 and 22), 33 and 64 (128 threads, four rows a
    # lane; bw 18, 11), 70 and 130 (256 threads, the block read from the
    # frame; bw 63, 30); span 0.
    (23, 29, 1, 3, "mse", None, None, (1, -1)),
    (23, 29, 1, 3, "ssim", None, None, (1, -1)),
    (99, 133, 8, 9, "ssim", 0.5, None, (2, -3)),
    (101, 137, 9, 7, "mse", None, None, (-3, 3)),
    (90, 183, 16, 7, "sad", None, None, (4, -5)),
    (80, 105, 17, 7, "mse", None, None, (5, 7)),
    (80, 105, 17, 7, "ssim", None, None, (5, 7)),
    (70, 150, 32, 9, "sad", 20.0, None, (3, -6)),
    (100, 150, 33, 6, "mse", None, None, (3, -2)),
    (100, 150, 33, 6, "ssim", None, None, (3, -2)),
    (150, 203, 64, 4, "sad", None, None, (2, 3)),
    (150, 203, 70, 4, "ssim", None, None, (2, 3)),
    (150, 290, 130, 2, "sad", None, None, (1, 1)),
    (61, 77, 8, 0, "mse", None, None, (1, 1)),
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
    """A long walk: on a horizontal ramp moved by 104 columns, the middle
    block row walks 52 LDSP moves of (0, 2), each with 5 new valid
    candidates (261 evaluations, past the 256-entry memo of an earlier
    design). The kernel equals `lazy_plain` on the card,
    `diamond_search_np` and JAX's lazy mode."""
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


@pytest.mark.parametrize("blk,metric,kind", TIE_CASES)
def test_walk_ties_cuda(cuda, blk, metric, kind):
    """The winner's reduction keeps the tie rule at each team shape (one
    warp at blk 8, 128 threads at 24 and 40, 256 at 70): on tie frames the
    kernel equals `lazy_plain` on the card bit for bit and
    `diamond_search_np`, and a block inside the frame takes the first tied
    candidate."""
    cur, ref = _tie_frames(kind, 3 * blk + 5, 4 * blk + 3)
    kw = dict(blk_dim=blk, span=5, metric=metric, early_term=None,
              max_steps=td.default_max_steps(5))
    cur_t, ref_t = (torch.from_numpy(a).to(cuda) for a in (cur, ref))
    got, got_traj = dc.walk_cuda(cur_t, ref_t, record_trajectory=True, **kw)
    want, want_traj = td.lazy_plain(cur_t, ref_t, record_trajectory=True,
                                    **kw)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
    assert torch.equal(got_traj, want_traj)
    _assert_matches_np(got, got_traj, jd.diamond_search_np(cur, ref, **kw),
                       metric)
    assert (int(got.mv_y[1, 1]), int(got.mv_x[1, 1])) == TIE_MV[kind]


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("blk,metric", [(5, "sad"), (8, "mse"), (17, "ssim"),
                                        (33, "mse"), (70, "sad")])
def test_walk_unaligned_frames_cuda(cuda, offset, blk, metric):
    """Frames that start `offset` bytes into their buffer and end at its
    last byte (word loads at both ends of the allocation) give the result
    of the same frames at an aligned address."""
    h, w = 3 * blk + 3, 4 * blk + 1
    cur, ref = _pair(13, h, w, shift=(2, -1))
    kw = dict(blk_dim=blk, span=4, metric=metric, early_term=None,
              max_steps=6, record_trajectory=True)
    frames = []
    for a in (cur, ref):
        buf = torch.zeros(offset + h * w, dtype=torch.uint8, device=cuda)
        buf[offset:] = torch.from_numpy(a.reshape(-1)).to(cuda)
        frames.append(buf[offset:].view(h, w))
    assert frames[0].data_ptr() % 4 == offset % 4
    got, got_traj = dc.walk_cuda(*frames, **kw)
    want, want_traj = dc.walk_cuda(
        *(torch.from_numpy(a).to(cuda) for a in (cur, ref)), **kw)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name
    assert torch.equal(got_traj, want_traj)


@pytest.mark.parametrize("metric", ["mse", "sad", "ssim"])
def test_walk_occupancy_cuda(cuda, metric):
    """The team shape the launcher picks from blk: one warp and four walks
    a CUDA block at blk <= 16, 128 threads and two walks at 17..64, 256
    threads and one walk above; each instance resident on the card."""
    for blk in (1, 8, 9, 16, 17, 32, 33, 64, 70, 130):
        occ = dc.walk_occupancy(blk, metric)
        team, walks = ((32, 4) if blk <= 16 else (128, 2) if blk <= 64
                       else (256, 1))
        assert (occ["team_threads"], occ["walks_per_block"]) == (team, walks)
        assert occ["blocks_per_sm"] >= 1 and occ["registers"] > 0, occ


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
