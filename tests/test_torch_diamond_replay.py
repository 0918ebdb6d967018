"""Diamond's trajectory replay (`kernels/diamond_cuda.py`) against a numpy
model of its kernel and against the JAX package.

`replay_np` below walks each block's trajectory on its own, as a thread of
`me_diamond_replay` does, and stops it on its own. On volumes made from a
seed with numpy (forced ties, sentinels inside the window and at its edge,
early termination per MSE pixel and at an SSIM threshold, escape tracking
on a cropped level, trajectories, tiles at a nonzero origin with truncated
frame edges), it is held against `replay_plain` (the port's lockstep
replay, the kernel's plain version) and JAX `_diamond_replay`: MVs, costs,
mean costs or flat indices, SSIM scores, trajectories and escape masks,
exactly (every value is an int32 cost, a volume entry or one IEEE float32
division on both sides). `bench/roofline.replay_reads`, which counts the
bytes of the kernel's bound, is held against the distinct volume entries
the model reads.

Then the dispatch in `search.diamond._replay`: a CPU volume takes
`replay_plain` and no kernel, and `replay_cuda` raises on a CPU tensor.
The lazy volume mode replays through `_replay` (so on the card through
the kernel) after each fill and equals the numpy model
`diamond_search_np`, `max_steps` 0 included, where JAX's lazy mode skips
the final SDSP step.

Tests whose names end in `_cuda` hold `me_diamond_replay` against
`replay_plain` on the card, bit for bit, and skip where there is no card:
`python -m pytest --noconftest tests/test_torch_diamond_replay.py -k cuda`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionestimation_tpu.search import diamond as jd
from motionestimation_tpu_torch.kernels import diamond_cuda as dc
from motionestimation_tpu_torch.search import diamond as td

torch.set_num_threads(1)

INT32_MAX = np.iinfo(np.int32).max


def replay_np(volume, *, blk_dim, span, metric, early_term, max_steps,
              frame_height, frame_width, track_escape=False, y_origin=0,
              x_origin=0):
    """The kernel's loop in numpy, one block at a time: (mv_y, mv_x, cost,
    trajectory [max_steps + 1, nby, nbx, 2], escaped)."""
    _, nby, nbx = volume.shape
    k = 2 * span + 1
    minimise = metric in ("mse", "sad")
    sentinel = volume.dtype.type(INT32_MAX if minimise else -np.inf)
    thr = None if early_term is None else np.float32(early_term)
    ldsp = [o for o in td.LDSP if o != (0, 0)]
    sdsp = [o for o in td.SDSP if o != (0, 0)]
    mv_y = np.zeros((nby, nbx), np.int32)
    mv_x = np.zeros((nby, nbx), np.int32)
    cost = np.zeros((nby, nbx), volume.dtype)
    esc = np.zeros((nby, nbx), bool)
    traj = np.zeros((max_steps + 1, nby, nbx, 2), np.int32)
    for by in range(nby):
        for bx in range(nbx):
            bh = min(max(frame_height - (y_origin + by * blk_dim), 0),
                     blk_dim)
            bw = min(max(frame_width - (x_origin + bx * blk_dim), 0),
                     blk_dim)
            count = np.float32(max(bh * bw, 1))

            def early(c):
                if thr is None:
                    return False
                if minimise:
                    return np.float32(c) / count <= thr
                return c >= thr

            def step(cy, cx, c, pattern):
                wy = wx = 0
                for oy, ox in pattern:
                    ty, tx = cy + oy, cx + ox
                    v = (volume[(ty + span) * k + tx + span, by, bx]
                         if abs(ty) <= span and abs(tx) <= span
                         else sentinel)
                    if (v < c) if minimise else (v > c):
                        c, wy, wx = v, oy, ox
                return wy, wx, c

            cy = cx = 0
            c = volume[span * k + span, by, bx]
            active, terminated, escaped = True, False, False
            for t in range(max_steps):
                if active:
                    if early(c):
                        terminated, active = True, False
                    else:
                        if track_escape and max(abs(cy), abs(cx)) > span - 2:
                            escaped = True
                        wy, wx, c = step(cy, cx, c, ldsp)
                        active = (wy, wx) != (0, 0)
                        cy, cx = cy + wy, cx + wx
                traj[t + 1, by, bx] = (cy, cx)
            if early(c):
                terminated = True
            if not terminated:
                if track_escape and max(abs(cy), abs(cx)) > span - 1:
                    escaped = True
                wy, wx, c = step(cy, cx, c, sdsp)
                cy, cx = cy + wy, cx + wx
            mv_y[by, bx], mv_x[by, bx], cost[by, bx] = cy, cx, c
            esc[by, bx] = escaped
    return mv_y, mv_x, cost, traj, esc


def make_volume(seed, nby, nbx, span, metric, sentinel_share=0.08):
    """A [K², nby, nbx] volume from `seed`: each block's costs fall toward
    a target displacement of its own (often at or past the window's edge),
    in coarse steps that force ties, with sentinels scattered inside the
    window; the centre is never a sentinel."""
    rng = np.random.default_rng(seed)
    k = 2 * span + 1
    d = np.arange(-span, span + 1)
    dy, dx = (a.reshape(k * k, 1, 1) for a in np.meshgrid(d, d,
                                                           indexing="ij"))
    target = rng.integers(-span - 2, span + 3, (2, 1, nby, nbx))
    dist = np.abs(dy - target[0]) + np.abs(dx - target[1])
    noise = rng.integers(0, 3, (k * k, nby, nbx))
    hole = rng.random((k * k, nby, nbx)) < sentinel_share
    hole[span * k + span] = False
    if metric == "ssim":
        vol = (1.0 - (dist + noise) / 16.0).astype(np.float32)
        vol[hole] = -np.inf
    else:
        vol = (4 * dist + noise).astype(np.int32)
        vol[hole] = INT32_MAX
    return vol


# (id, metric, span, nby, nbx, blk, frame (h, w), origin, early_term,
#  max_steps or None for span + 2, track_escape)
CASES = [
    ("mse", "mse", 4, 5, 7, 2, (10, 14), (0, 0), None, None, False),
    ("sad", "sad", 4, 5, 7, 2, (10, 14), (0, 0), None, None, False),
    ("ssim", "ssim", 4, 5, 7, 2, (10, 14), (0, 0), None, None, False),
    ("mse early per pixel", "mse", 4, 6, 6, 2, (12, 12), (0, 0), 2.0, None,
     False),
    ("sad early, truncated edges", "sad", 3, 6, 7, 2, (11, 13), (0, 0), 1.5,
     None, False),
    ("ssim early threshold", "ssim", 4, 6, 6, 2, (12, 12), (0, 0), 0.75,
     None, False),
    ("mse cropped level, escape", "mse", 3, 6, 8, 4, (24, 32), (0, 0), None,
     None, True),
    ("ssim cropped level, escape", "ssim", 3, 6, 8, 4, (24, 32), (0, 0),
     None, None, True),
    ("mse tile at an origin, truncated edges", "mse", 5, 4, 5, 4, (27, 38),
     (12, 20), 2.5, None, False),
    ("sad tile at an origin, escape", "sad", 3, 4, 5, 4, (27, 38), (12, 20),
     1.0, None, True),
    ("ssim tile at an origin, escape", "ssim", 3, 4, 5, 4, (27, 38),
     (12, 20), 0.8, None, True),
    ("tile wholly past the frame", "mse", 3, 2, 3, 4, (10, 10), (12, 0),
     1.0, None, True),
    ("max_steps 1", "mse", 4, 5, 5, 2, (10, 10), (0, 0), None, 1, True),
    ("max_steps 0", "ssim", 3, 4, 4, 2, (8, 8), (0, 0), None, 0, True),
    ("span 1", "sad", 1, 4, 6, 2, (8, 12), (0, 0), None, None, True),
    ("span 0", "mse", 0, 3, 3, 2, (6, 6), (0, 0), 0.5, None, False),
]


def _case_kwargs(case):
    (_, metric, span, nby, nbx, blk, (fh, fw), (y0, x0), early, steps,
     track) = case
    return dict(blk_dim=blk, span=span, metric=metric, early_term=early,
                max_steps=span + 2 if steps is None else steps,
                frame_height=fh, frame_width=fw, track_escape=track,
                y_origin=y0, x_origin=x0), (nby, nbx)


def _volume(case, seed):
    kw, (nby, nbx) = _case_kwargs(case)
    return make_volume(seed, nby, nbx, kw["span"], kw["metric"]), kw


def _numpy(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same(got, want):
    """(field, traj, escaped) of two replays: every field, dtypes
    included, bit for bit."""
    (gf, gt, ge), (wf, wt, we) = got, want
    for name, a, b in zip(wf._fields, gf, wf):
        a, b = _numpy(a), _numpy(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(_numpy(gt), _numpy(wt))
    np.testing.assert_array_equal(_numpy(ge), _numpy(we))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [0, 1])
def test_model_plain_and_jax_agree(case, seed):
    """The per-block numpy model == replay_plain == JAX _diamond_replay."""
    vol, kw = _volume(case, seed)
    mv_y, mv_x, cost, traj, esc = replay_np(vol, **kw)
    field, p_traj, p_esc = dc.replay_plain(torch.from_numpy(vol),
                                           record_trajectory=True, **kw)
    np.testing.assert_array_equal(field.mv_y.numpy(), mv_y)
    np.testing.assert_array_equal(field.mv_x.numpy(), mv_x)
    got_cost = field.score if kw["metric"] == "ssim" else field.best_cost_i32
    assert got_cost.numpy().dtype == cost.dtype
    np.testing.assert_array_equal(got_cost.numpy(), cost)
    np.testing.assert_array_equal(p_traj.numpy(), traj)
    np.testing.assert_array_equal(p_esc.numpy(), esc)

    jkw = dict(kw)
    y0, x0 = jkw.pop("y_origin"), jkw.pop("x_origin")
    j = jd._diamond_replay(jnp.asarray(vol), y0, x0, record_trajectory=True,
                           **jkw)
    _assert_same((field, p_traj, p_esc), j)


@pytest.mark.parametrize("case", CASES[:6] + CASES[8:9],
                         ids=[c[0] for c in CASES[:6] + CASES[8:9]])
def test_without_trajectory_same_field(case):
    """record_trajectory=False gives no trajectory and the same field and
    escape mask."""
    vol, kw = _volume(case, 7)
    v = torch.from_numpy(vol)
    field, traj, esc = dc.replay_plain(v, record_trajectory=False, **kw)
    want = dc.replay_plain(v, record_trajectory=True, **kw)
    assert traj is None
    _assert_same((field, want[1], esc), want)


def test_replay_matches_real_volume():
    """On a golden cost volume of real frames (truncated edges): the model
    equals replay_plain, as a volume of the search would give it."""
    from motionestimation_tpu_torch.search import full_search as tfs

    rng = np.random.default_rng(3)
    small = rng.integers(0, 256, (10, 12))
    ref = np.kron(small, np.ones((6, 6)))[:52, :60].astype(np.uint8)
    cur = np.roll(ref, (2, -3), (0, 1))
    _, vol = tfs.full_search_frame(torch.from_numpy(cur),
                                   torch.from_numpy(ref), blk_dim=8, span=5,
                                   metric="mse", return_cost_volume=True)
    kw = dict(blk_dim=8, span=5, metric="mse", early_term=None, max_steps=7,
              frame_height=52, frame_width=60)
    mv_y, mv_x, cost, traj, _ = replay_np(vol.numpy(), **kw)
    field, p_traj, _ = dc.replay_plain(vol, record_trajectory=True, **kw)
    np.testing.assert_array_equal(field.mv_y.numpy(), mv_y)
    np.testing.assert_array_equal(field.mv_x.numpy(), mv_x)
    np.testing.assert_array_equal(field.best_cost_i32.numpy(), cost)
    np.testing.assert_array_equal(p_traj.numpy(), traj)
    assert (mv_y != 0).any()


# --- the dispatch --------------------------------------------------------


def test_cpu_volume_takes_plain(monkeypatch):
    """search.diamond._replay on a CPU volume runs replay_plain and launches
    nothing."""
    calls = []
    real = dc.replay_plain

    def counting(*a, **kw):
        calls.append(kw["record_trajectory"])
        return real(*a, **kw)

    monkeypatch.setattr(dc, "replay_plain", counting)
    vol, kw = _volume(CASES[3], 0)
    before = dc.replay_cuda.launches
    got = td._replay(torch.from_numpy(vol), record_trajectory=True, **kw)
    assert calls == [True] and dc.replay_cuda.launches == before
    _assert_same(got, real(torch.from_numpy(vol), record_trajectory=True,
                           **kw))


def _lazy_pair():
    """A 40x56 pair whose blocks move up to 13 pixels: at span 15 some
    trajectories leave the first level (radius 6)."""
    rng = np.random.default_rng(4)
    small = rng.integers(0, 256, (8, 12))
    ref = np.clip(np.kron(small, np.ones((8, 8)))[:40, :56]
                  + rng.normal(0, 2, (40, 56)), 0, 255).astype(np.uint8)
    return np.roll(ref, (9, -11), (0, 1)), ref


@pytest.mark.parametrize("metric,early,steps", [
    ("mse", None, None), ("sad", 3.0, None), ("ssim", None, None),
    ("mse", None, 2), ("ssim", None, 0)])
def test_lazy_mode_replays_pass_by_pass(monkeypatch, metric, early, steps):
    """volume_mode="lazy" evaluates each golden plane at most once, fewer
    than the window's, replays the whole-span volume through `_replay`
    after each fill, and equals the numpy model: MVs, costs or scores and
    trajectories. With max_steps 0 the final SDSP step still reads its
    planes (JAX's lazy mode fills none before it and leaves every block
    at (0, 0); pinned below)."""
    from motionestimation_tpu_torch.search import full_search as tfs

    cur, ref = _lazy_pair()
    spans, planes = [], []
    real_replay, real_cost = td._replay, tfs.make_displacement_cost

    def replay(volume, **kw):
        spans.append(kw["span"])
        return real_replay(volume, **kw)

    def cost(*a, **kw):
        plane = real_cost(*a, **kw)
        return lambda idx: planes.append(idx) or plane(idx)

    monkeypatch.setattr(td, "_replay", replay)
    monkeypatch.setattr(tfs, "make_displacement_cost", cost)
    field, traj = td.diamond_search_frame(
        cur, ref, blk_dim=8, span=15, metric=metric, early_term=early,
        max_steps=steps, record_trajectory=True, volume_mode="lazy",
        device="cpu")
    assert spans and set(spans) == {15}
    assert len(set(planes)) == len(planes) < 31 * 31
    ms = td.default_max_steps(15) if steps is None else steps
    mv_y, mv_x, best, g_traj = jd.diamond_search_np(
        cur, ref, blk_dim=8, span=15, metric=metric, early_term=early,
        max_steps=ms)
    np.testing.assert_array_equal(field.mv_y.numpy(), mv_y)
    np.testing.assert_array_equal(field.mv_x.numpy(), mv_x)
    np.testing.assert_array_equal(traj.numpy(), g_traj)
    if metric == "ssim":
        np.testing.assert_array_equal(field.score.numpy(),
                                      best.astype(np.float32))
    else:
        np.testing.assert_array_equal(field.best_cost_i32.numpy(), best)
    if steps == 0:
        assert (mv_y != 0).any() or (mv_x != 0).any()
    else:
        assert len(spans) > 1


def test_jax_lazy_skips_sdsp_at_max_steps_0():
    """The reference fault the port does not inherit: JAX's lazy mode with
    max_steps 0 reads the SDSP planes unfilled and moves no block, where
    its full-volume mode and the numpy model take the SDSP step."""
    cur, ref = _lazy_pair()
    kw = dict(blk_dim=8, span=4, metric="mse", max_steps=0)
    lazy = jd.diamond_search_frame(cur, ref, volume_mode="lazy", **kw)
    full = jd.diamond_search_frame(cur, ref, volume_mode="full", **kw)
    port = td.diamond_search_frame(cur, ref, volume_mode="lazy",
                                   device="cpu", **kw)
    assert not np.asarray(lazy.mv_y).any() and not np.asarray(lazy.mv_x).any()
    np.testing.assert_array_equal(port.mv_y.numpy(), np.asarray(full.mv_y))
    np.testing.assert_array_equal(port.mv_x.numpy(), np.asarray(full.mv_x))
    assert np.asarray(full.mv_x).any()


@pytest.mark.parametrize("metric", ["mse", "ssim"])
def test_replay_cuda_raises_on_cpu(metric):
    vol, kw = _volume(CASES[0], 0)
    kw["metric"] = metric
    with pytest.raises(ValueError, match="CUDA tensors"):
        dc.replay_cuda(torch.from_numpy(vol), record_trajectory=False, **kw)


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("record", [True, False])
def test_kernel_matches_plain_cuda(cuda, case, record):
    """me_diamond_replay == replay_plain on the card: fields, trajectories
    and escape masks bit for bit, one launch."""
    vol, kw = _volume(case, 11)
    v = torch.from_numpy(vol).to(cuda)
    before = dc.replay_cuda.launches
    got = dc.replay_cuda(v, record_trajectory=record, **kw)
    torch.cuda.synchronize()
    assert dc.replay_cuda.launches == before + 1
    want = dc.replay_plain(v, record_trajectory=record, **kw)
    if not record:
        assert got[1] is None and want[1] is None
        got, want = (got[0], torch.zeros(1), got[2]), (want[0],
                                                       torch.zeros(1),
                                                       want[2])
    _assert_same(got, want)


def test_dispatch_launches_kernel_cuda(cuda):
    """_replay on a CUDA volume launches the kernel once and runs no
    replay_plain; it syncs the host with the card nowhere."""
    vol, kw = _volume(CASES[6], 2)
    v = torch.from_numpy(vol).to(cuda)
    before = dc.replay_cuda.launches
    real = dc.replay_plain
    dc.replay_plain = None  # any call would raise
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = td._replay(v, record_trajectory=True, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        dc.replay_plain = real
    assert dc.replay_cuda.launches == before + 1
    _assert_same(got, real(v, record_trajectory=True, **kw))


def test_replay_cuda_checks_volume_cuda(cuda):
    vol, kw = _volume(CASES[0], 0)
    v = torch.from_numpy(vol).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dc.replay_cuda(v.float(), record_trajectory=False, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        dc.replay_cuda(v.transpose(1, 2), record_trajectory=False, **kw)


@pytest.mark.parametrize("metric,early", [("mse", None), ("sad", 3.0),
                                          ("ssim", None)])
def test_diamond_frame_kernel_equals_jax_cuda(cuda, metric, early):
    """diamond_search_frame on the card (emit modes and the replay kernel)
    equals the JAX function on the same frames, trajectories included."""
    rng = np.random.default_rng(4)
    small = rng.integers(0, 256, (14, 24))
    ref = np.clip(np.kron(small, np.ones((8, 8)))[:100, :180]
                  + rng.normal(0, 2, (100, 180)), 0, 255).astype(np.uint8)
    cur = np.roll(ref, (9, -11), (0, 1))
    kw = dict(blk_dim=16, span=15, metric=metric, early_term=early,
              record_trajectory=True, volume_mode="staged")
    before = dc.replay_cuda.launches
    field, traj = td.diamond_search_frame(cur, ref, device=cuda, **kw)
    assert dc.replay_cuda.launches > before
    j_field, j_traj = jd.diamond_search_frame(cur, ref, **kw)
    np.testing.assert_array_equal(traj.cpu().numpy(), np.asarray(j_traj))
    for name in ("mv_y", "mv_x", "best_cost_i32"):
        np.testing.assert_array_equal(getattr(field, name).cpu().numpy(),
                                      np.asarray(getattr(j_field, name)))
    np.testing.assert_allclose(field.score.cpu().numpy(),
                               np.asarray(j_field.score), rtol=0, atol=1e-6)


class _CountingVolume:
    """A numpy volume that records the entries read from it."""

    def __init__(self, a):
        self.a, self.shape, self.dtype, self.read = a, a.shape, a.dtype, set()

    def __getitem__(self, i):
        self.read.add(i)
        return self.a[i]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_replay_reads_count_the_models_reads(case):
    """bench/roofline.replay_reads, from replay_plain's trajectory, counts
    the distinct volume entries the per-block model reads without early
    termination (the timed replay's): the bytes of the replay's bound."""
    from motionestimation_tpu_torch.bench.roofline import replay_reads

    vol, kw = _volume(case, 5)
    kw["early_term"] = None
    counting = _CountingVolume(vol)
    replay_np(counting, **kw)
    _, traj, _ = dc.replay_plain(torch.from_numpy(vol),
                                 record_trajectory=True, **kw)
    assert replay_reads(traj.numpy(), span=kw["span"]) == len(counting.read)
