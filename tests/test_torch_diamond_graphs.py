"""The staged diamond's CUDA graphs (`search/diamond._graph_level`).

On the card a staged level runs eagerly the first time its frame shape and
configuration come, and from a graph, captured the second time, every time
after that. Held here, against the staged route's plain versions on the
CPU:

* CPU frames make no graph and no input buffer; `_launch_counters` names
  the counters of every wrapper a level launches through.
* On the card (the `_cuda` cases, which skip without one): call after
  call on new frames, the MVs, costs, scores and trajectories equal the
  plain versions', in every metric, with an early check and under the
  crossover; each call moves the launch counters as the first, eager one
  did; a field that one call returned is not overwritten by the next; two
  configurations on one frame shape, in turns, share its graphs' memory
  pool and stay exact; two host threads on one stream, each searching its
  own frames, stay exact.

This file imports no JAX: `python -m pytest --noconftest
tests/test_torch_diamond_graphs.py` runs it on the card.
"""
import threading

import numpy as np
import pytest
import torch

from motionestimation_tpu_torch.kernels import diamond_cuda as dc
from motionestimation_tpu_torch.kernels import full_search_cuda as fsc
from motionestimation_tpu_torch.kernels import ssim_cuda as sc
from motionestimation_tpu_torch.search import diamond as td


def _pair(seed, h, w, shift):
    """A reference of 8x8 squares with noise, and the current frame moved
    by `shift` with noise of +-2: walks go as far as the move."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float64)
    ref = np.clip(np.kron(small, np.ones((8, 8)))[:h, :w]
                  + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
    cur = np.roll(ref, shift, (0, 1)).astype(np.int32)
    cur = np.clip(cur + rng.integers(-2, 3, (h, w)), 0, 255).astype(np.uint8)
    return cur, ref


def _counts():
    return {(fn.__name__, name): getattr(fn, name)
            for fn, name in td._launch_counters()}


def _moved(after, before):
    return {k: v - before[k] for k, v in after.items() if v != before[k]}


def _search(cur, ref, device, kw):
    out = td.diamond_search_frame(cur, ref, device=device, **kw)
    return out if kw["record_trajectory"] else (out, None)


def _assert_equal(got, want):
    (field, traj), (want_field, want_traj) = got, want
    for a, b in zip(field, want_field):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    if want_traj is not None:
        assert torch.equal(traj.cpu(), want_traj)


def test_cpu_frames_make_no_graph():
    cur, ref = _pair(1, 44, 62, (9, -10))
    inputs, graphs = dict(td._graph_inputs), dict(td._level_graphs)
    levels = td._diamond_staged.levels
    td.diamond_search_frame(cur, ref, blk_dim=8, span=15,
                            volume_mode="staged", device="cpu")
    assert td._diamond_staged.levels == levels + 2
    assert td._graph_inputs == inputs and td._level_graphs == graphs


def test_launch_counters_cover_the_level_wrappers():
    names = {(fn.__name__, name) for fn, name in td._launch_counters()}
    for fn in (fsc.phase_search, fsc.chunked_search, fsc.int_search,
               sc.ssim_fast_search, sc.ssim_search):
        assert {(fn.__name__, "launches"),
                (fn.__name__, "volume_launches")} <= names
    assert ("phase_search", "ring_launches") in names
    assert (dc.replay_cuda.__name__, "launches") in names


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs capture CUDA kernels")
    return torch.device("cuda")


# (metric, early_term, escape_policy) at 16x16 +-15 on 90x170 frames (a
# truncated block row and column); every move below takes walks past the
# first level's radius 6, so each call runs both levels (6, 15).
CASES = [("mse", None, "canonical"), ("sad", None, "canonical"),
         ("ssim", None, "canonical"), ("mse", 40.0, "canonical"),
         ("mse", None, "crossover")]


@pytest.mark.parametrize("metric,early,policy", CASES)
def test_replays_equal_the_plain_versions_cuda(cuda, metric, early, policy):
    kw = dict(blk_dim=16, span=15, metric=metric, early_term=early,
              escape_policy=policy, volume_mode="staged",
              record_trajectory=policy == "canonical")
    held, moved = [], []
    for seed in range(4):
        cur, ref = _pair(seed, 90, 170, (9 + seed, -10 + seed))
        before = _counts()
        got = _search(cur, ref, cuda, kw)
        torch.cuda.synchronize()
        moved.append(_moved(_counts(), before))
        want = _search(cur, ref, "cpu", kw)
        _assert_equal(got, want)
        held.append((got, want))
    for got, want in held:
        _assert_equal(got, want)
    assert moved[0] and all(m == moved[0] for m in moved)
    shape = [k for k in td._graph_inputs if k[-1] == (90, 170)]
    assert shape and any(k[0] in shape and v is not None
                         for k, v in td._level_graphs.items())


def test_two_configurations_share_a_shape_cuda(cuda):
    kws = [dict(blk_dim=bl, span=15, metric=m, volume_mode="staged",
                record_trajectory=True)
           for bl, m in ((16, "mse"), (8, "sad"), (16, "ssim"))]
    for seed in range(3):
        cur, ref = _pair(10 + seed, 90, 170, (8, -9))
        got = [_search(cur, ref, cuda, kw) for kw in kws]
        for g, kw in zip(got, kws):
            _assert_equal(g, _search(cur, ref, "cpu", kw))


def test_two_threads_on_one_stream_cuda(cuda):
    kw = dict(blk_dim=16, span=15, metric="mse", early_term=None,
              escape_policy="canonical", volume_mode="staged",
              record_trajectory=True)
    pairs = [_pair(20 + i, 90, 170, (9, -10 + i)) for i in range(2)]
    got, errors = ([], []), []
    start = threading.Barrier(2)

    def work(i):
        try:
            start.wait()
            for _ in range(4):
                got[i].append(_search(*pairs[i], cuda, kw))
        except Exception as e:   # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors
    for (cur, ref), results in zip(pairs, got):
        want = _search(cur, ref, "cpu", kw)
        assert len(results) == 4
        for g in results:
            _assert_equal(g, want)
