"""The port's diamond search against the benchmark's plain diamond
(`benchmark/yardstick/diamond.py`), on the CPU.

* `diamond_search_frame(device="cpu")`, the kernels' plain versions, in
  `volume_mode` "auto", "staged" and "lazy": MVs, int32 costs, scores and
  trajectories equal to the reference's, over seeds and shapes (frames
  that blocks do not divide; span 15 content moved past the first staged
  level's radius, so that the staged route escalates).
* The reference against a scalar loop over Zhu and Ma's LDSP/SDSP rules,
  with this project's order, ties, window and step cap, on tiny frames,
  and against the JAX package's numpy model `diamond_search_np`.
* The counters `diamond_search_frame.calls` and `_diamond_staged.levels`
  on cases with a known number of levels, and the spans `me.search`,
  `me.level` and `me.escape_wait` under a CPU profile: one `me.search` a
  call, the crossover's full search outside it, none recorded without a
  profiler.
* `yardstick/diamond_roofline.walk_evals` the same on the port's
  trajectories in every mode as on the reference's.
"""
import numpy as np
import pytest
import torch

from benchmark.yardstick import diamond as yd
from benchmark.yardstick import diamond_roofline
from benchmark.yardstick.trace import WINDOW, Trace
from motionestimation_tpu.search import diamond as jd
from motionestimation_tpu_torch.core import trace
from motionestimation_tpu_torch.search import diamond as td

torch.set_num_threads(1)

LDSP = ((-2, 0), (-1, -1), (-1, 1), (0, -2), (0, 0),
        (0, 2), (1, -1), (1, 1), (2, 0))
SDSP = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))


def _pair(seed, h, w, shift):
    """A low-frequency reference and the current frame moved by `shift`
    with noise of +-2, as tests/test_diamond.py makes them."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float64)
    ref = np.clip(np.kron(small, np.ones((8, 8)))[:h, :w]
                  + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
    cur = np.roll(ref, shift, (0, 1)).astype(np.int32)
    cur = np.clip(cur + rng.integers(-2, 3, (h, w)), 0, 255).astype(np.uint8)
    return cur, ref


def _reference(cur, ref, blk, span, metric="mse"):
    return yd.diamond_search(torch.from_numpy(cur), torch.from_numpy(ref),
                             blk=blk, span=span, metric=metric)


def _port(cur, ref, blk, span, metric="mse", **kw):
    return td.diamond_search_frame(cur, ref, blk_dim=blk, span=span,
                                   metric=metric, record_trajectory=True,
                                   device="cpu", **kw)


# (seed, h, w, blk, span, shift): 37 x 61 and 44 x 70 leave truncated
# blocks; at span 15 the (9, -10) move takes walks past the level-6 radius.
CASES = [
    (1, 37, 61, 8, 15, (9, -10)),
    (2, 44, 70, 8, 15, (-8, 11)),
    (3, 48, 64, 16, 15, (3, -4)),
    (4, 40, 56, 8, 7, (2, -3)),
]


@pytest.mark.parametrize("metric", ["mse", "sad"])
@pytest.mark.parametrize("mode", ["auto", "staged", "lazy"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(
    map(str, c[1:5])) + f"-s{c[0]}")
def test_port_equals_the_reference(case, mode, metric):
    seed, h, w, blk, span, shift = case
    cur, ref = _pair(seed, h, w, shift)
    field, traj = _port(cur, ref, blk, span, metric, volume_mode=mode)
    want = _reference(cur, ref, blk, span, metric)
    assert torch.equal(field.mv_y, want.mv_y)
    assert torch.equal(field.mv_x, want.mv_x)
    assert torch.equal(field.best_cost_i32, want.cost)
    assert torch.equal(field.score.view(torch.int32),
                       want.score.view(torch.int32))
    assert torch.equal(traj, want.trajectory)


def _scalar_diamond(cur, ref, blk, span, max_steps):
    """Zhu and Ma's diamond, one block at a time in plain Python: LDSP
    rounds from (0, 0) until the centre is best or `max_steps` rounds have
    run, then one SDSP step; a candidate outside +-span or the frame is
    skipped; only a cost strictly below the best so far moves the centre."""
    h, w = cur.shape
    nby, nbx = -(-h // blk), -(-w // blk)
    mv = np.zeros((nby, nbx, 2), np.int64)
    costs = np.zeros((nby, nbx), np.int64)
    traj = np.zeros((max_steps + 1, nby, nbx, 2), np.int64)
    for by in range(nby):
        for bx in range(nbx):
            y0, x0 = by * blk, bx * blk
            bh, bw = min(blk, h - y0), min(blk, w - x0)

            def cost(dy, dx):
                y, x = y0 + dy, x0 + dx
                if (abs(dy) > span or abs(dx) > span or y < 0 or x < 0
                        or y + bh > h or x + bw > w):
                    return None
                total = 0
                for i in range(bh):
                    for j in range(bw):
                        d = int(cur[y0 + i, x0 + j]) - int(ref[y + i, x + j])
                        total += d * d
                return total

            cy = cx = 0
            best = cost(0, 0)
            stopped = False
            for step in range(max_steps):
                if not stopped:
                    move = (0, 0)
                    for oy, ox in LDSP:
                        c = cost(cy + oy, cx + ox)
                        if c is not None and c < best:
                            best, move = c, (oy, ox)
                    cy, cx = cy + move[0], cx + move[1]
                    stopped = move == (0, 0)
                traj[step + 1, by, bx] = (cy, cx)
            move = (0, 0)
            for oy, ox in SDSP:
                c = cost(cy + oy, cx + ox)
                if c is not None and c < best:
                    best, move = c, (oy, ox)
            mv[by, bx] = (cy + move[0], cx + move[1])
            costs[by, bx] = best
    return mv, costs, traj


@pytest.mark.parametrize("case", [(5, 13, 19, 4, 3, (2, -1), 2),
                                  (6, 17, 14, 5, 4, (-3, 3), 6),
                                  (7, 12, 12, 4, 6, (4, 4), 0)])
def test_reference_equals_the_scalar_rules(case):
    seed, h, w, blk, span, shift, steps = case
    cur, ref = _pair(seed, h, w, shift)
    mv, costs, traj = _scalar_diamond(cur, ref, blk, span, steps)
    got = yd.diamond_search(torch.from_numpy(cur), torch.from_numpy(ref),
                            blk=blk, span=span, max_steps=steps)
    assert np.array_equal(got.mv_y.numpy(), mv[..., 0])
    assert np.array_equal(got.mv_x.numpy(), mv[..., 1])
    assert np.array_equal(got.cost.numpy(), costs)
    assert np.array_equal(got.trajectory.numpy(), traj)


def test_reference_ties_go_to_the_centre_then_pattern_order():
    """Flat frames tie every candidate with the centre: (0, 0) stays. A
    reference whose pixels depend only on y + x, and a current frame whose
    pixel (y, x) is the reference's (y + 1, x + 1), tie (0, 2), (1, 1) and
    (2, 0) below the centre: the first in pattern order, (0, 2), wins the
    first round."""
    flat = np.full((24, 24), 77, np.uint8)
    got = yd.diamond_search(torch.from_numpy(flat), torch.from_numpy(flat),
                            blk=8, span=4)
    assert not got.mv_y.any() and not got.mv_x.any()
    y, x = np.mgrid[:40, :40]
    ref = ((y + x) * 3 % 256).astype(np.uint8)
    cur = np.roll(ref, (-1, -1), (0, 1))
    got = yd.diamond_search(torch.from_numpy(cur), torch.from_numpy(ref),
                            blk=8, span=6)
    assert got.trajectory[1, 1, 1].tolist() == [0, 2]


@pytest.mark.parametrize("case", CASES[:2] + [(8, 30, 45, 7, 5, (1, 2))],
                         ids=lambda c: "x".join(map(str, c[1:5])))
def test_reference_equals_the_numpy_model(case):
    seed, h, w, blk, span, shift = case
    cur, ref = _pair(seed, h, w, shift)
    mv_y, mv_x, best, traj = jd.diamond_search_np(cur, ref, blk_dim=blk,
                                                  span=span)
    got = _reference(cur, ref, blk, span)
    assert np.array_equal(got.mv_y.numpy(), mv_y)
    assert np.array_equal(got.mv_x.numpy(), mv_x)
    assert np.array_equal(got.cost.numpy(), best.astype(np.int64))
    assert np.array_equal(got.trajectory.numpy(), traj)


def test_int16_costs_differ():
    """The control's precision: int16 costs wrap, and the walks change."""
    cur, ref = _pair(9, 37, 61, (9, -10))
    exact = _reference(cur, ref, 8, 15)
    low = yd.diamond_search(torch.from_numpy(cur), torch.from_numpy(ref),
                            blk=8, span=15, dtype=torch.int16)
    assert not torch.equal(exact.cost, low.cost)
    assert not torch.equal(exact.trajectory, low.trajectory)


# (shift, span, escape policy, levels run): still content stays inside the
# first level; a move past its radius escalates to the next.
LEVELS = [((0, 0), 15, "canonical", 1), ((9, -10), 15, "canonical", 2),
          ((9, -10), 15, "crossover", 1), ((1, 1), 5, "canonical", 1)]


@pytest.mark.parametrize("shift,span,policy,levels", LEVELS)
def test_counters(shift, span, policy, levels):
    cur, ref = _pair(10, 37, 61, shift)
    calls0 = td.diamond_search_frame.calls
    levels0 = td._diamond_staged.levels
    td.diamond_search_frame(cur, ref, blk_dim=8, span=span,
                            escape_policy=policy, device="cpu")
    assert td.diamond_search_frame.calls == calls0 + 1
    assert td._diamond_staged.levels == levels0 + levels
    td.diamond_search_frame(cur, ref, blk_dim=8, span=span,
                            volume_mode="lazy", device="cpu")
    assert td.diamond_search_frame.calls == calls0 + 2
    assert td._diamond_staged.levels == levels0 + levels


def _profiled(fn):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
    return out, Trace.record(prof)


def _inside(inner, outer):
    a, b, tid = inner
    return any(s <= a and b <= e and t == tid for s, e, t in outer)


@pytest.mark.parametrize("shift,span,policy,levels", LEVELS)
def test_spans(shift, span, policy, levels, monkeypatch):
    """One `me.search` a call around its `me.level` and `me.escape_wait`
    spans; the crossover's full search (on the card a search call with its
    own `me.search`, given one here around the plain search) after it."""
    real = td.fs.full_search_frame

    def full_search(*a, **kw):
        with trace.span("me.search"):
            return real(*a, **kw)

    monkeypatch.setattr(td.fs, "full_search_frame", full_search)
    cur, ref = _pair(10, 37, 61, shift)

    def call():
        return td.diamond_search_frame(cur, ref, blk_dim=8, span=span,
                                       escape_policy=policy, device="cpu")

    field, tr = _profiled(call)
    assert torch.equal(field.mv_y, call().mv_y)
    calls = tr.spans("me.search")
    for i, c in enumerate(calls):   # no search call inside another
        assert not _inside(c, calls[:i] + calls[i + 1:])
    diamond_call = calls[0]
    level_spans, waits = tr.spans("me.level"), tr.spans("me.escape_wait")
    assert len(level_spans) == levels
    assert all(_inside(s, [diamond_call]) for s in level_spans + waits)
    # Canonical: a wait before each level after the first, the last of
    # them none where the last level ran; crossover: one, after level 6.
    last_ran = levels == len(td._staged_levels(span))
    assert len(waits) == (1 if policy == "crossover" else levels - last_ran)
    if policy == "crossover":
        assert len(calls) == 2 and calls[1][0] >= diamond_call[1]
    else:
        assert len(calls) == 1


def test_no_span_recorded_without_a_profiler(monkeypatch):
    entered = []
    enter = torch._C._autograd._record_function_with_args_enter

    def counted(name, *args):
        entered.append(name)
        return enter(name, *args)

    monkeypatch.setattr(torch._C._autograd,
                        "_record_function_with_args_enter", counted)
    cur, ref = _pair(10, 37, 61, (9, -10))
    assert not torch.autograd.profiler._is_profiler_enabled
    td.diamond_search_frame(cur, ref, blk_dim=8, span=15, device="cpu")
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        td.diamond_search_frame(cur, ref, blk_dim=8, span=15, device="cpu")
    assert entered.count("me.search") == 1
    assert entered.count("me.level") == 2


def test_bound_is_the_same_whatever_runs_the_diamond():
    """The bound reads the reference's trajectories: the port's, in each
    mode, give the same count."""
    cur, ref = _pair(11, 37, 61, (9, -10))
    want = _reference(cur, ref, 8, 15).trajectory.numpy()
    kw = dict(span=15, blk_dim=8, frame_height=37, frame_width=61)
    for mode in ("staged", "lazy"):
        _, traj = _port(cur, ref, 8, 15, volume_mode=mode)
        assert (diamond_roofline.walk_evals(traj.numpy(), **kw)
                == diamond_roofline.walk_evals(want, **kw))
