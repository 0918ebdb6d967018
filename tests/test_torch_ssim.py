"""The port's SSIM path vs the JAX package.

* `ssim_from_sums` on random integer sums (flat blocks, truncated counts):
  bit-equal to the JAX function run eagerly (`jax.disable_jit()`), within
  1e-6 of it jitted. Jitted XLA fuses the float32 score arithmetic, so
  its scores differ from step-by-step IEEE evaluation in the last bits.
* The golden `full_search_frame(metric="ssim")`, and the kernels' plain
  versions behind `ssim_search_frame_cuda(device="cpu")`, against JAX's
  golden search and `ssim_search_frame_pallas(interpret=True)` (both
  jitted): equal MVs and flat indices, scores within 1e-6. Where an MV
  differs, JAX's own cost volume must show the two candidates within 1e-6
  of each other, a tie at float32 resolution.
* Where the pixel count is a power of two, the fast kernel divides by it
  as a multiplication by its reciprocal: every such step of
  `ssim_from_sums` gives the same bits either way.
* Tests whose names end in `_cuda` hold each CUDA kernel against its plain
  version on the card, exactly (both sides are IEEE step by step), and
  skip where there is none:
  `python -m pytest --noconftest tests/test_torch_ssim.py -k cuda`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from motionestimation_tpu.kernels import ssim_pallas as jsp
from motionestimation_tpu.metrics import cost as jcost
from motionestimation_tpu.search import full_search as jfs
from motionestimation_tpu_torch.core.config import SearchConfig
from motionestimation_tpu_torch.kernels import ssim_cuda as sc
from motionestimation_tpu_torch.metrics import cost as tcost
from motionestimation_tpu_torch.pipeline import runner
from motionestimation_tpu_torch.search import full_search as tfs

# The tests run in several worker processes on shared cores; one torch
# thread per worker keeps them from oversubscribing the machine.
torch.set_num_threads(1)

SCORE_ATOL = 1e-6


def random_pair(seed, h, w):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = np.roll(ref, (rng.integers(-3, 4), rng.integers(-3, 4)), (0, 1))
    cur = np.clip(
        cur.astype(np.int32) + rng.integers(-6, 7, (h, w)), 0, 255
    ).astype(np.uint8)
    return cur, ref


def random_sums(seed, blk, n=3000):
    """Consistent int32 sums of n (ref, cur) pixel-block pairs: half full,
    half truncated to a random count; every 7th pair flat."""
    rng = np.random.default_rng(seed)
    m = blk * blk
    count = rng.integers(1, m + 1, n).astype(np.int32)
    count[: n // 2] = m
    mask = np.arange(m)[None, :] < count[:, None]
    blocks = []
    for _ in range(2):
        base = rng.integers(0, 256, (n, 1))
        spread = rng.integers(0, 256, (n, 1))
        spread[::7] = 0
        noise = rng.integers(-128, 128, (n, m), dtype=np.int16)
        px = np.clip(base + noise * spread // 256, 0, 255) * mask
        blocks.append(px.astype(np.int32))
    r, c = blocks
    sums = [r.sum(1), (r * r).sum(1), c.sum(1), (c * c).sum(1),
            (r * c).sum(1), count]
    return [s.astype(np.int32) for s in sums]


@pytest.mark.parametrize("blk", [4, 7, 8, 12, 16, 32, 64])
def test_ssim_from_sums_matches_jax(blk):
    sums = random_sums(blk, blk)
    got = tcost.ssim_from_sums(*map(torch.from_numpy, sums)).numpy()
    with jax.disable_jit():
        eager = np.asarray(jcost.ssim_from_sums(*map(jnp.asarray, sums)))
    np.testing.assert_array_equal(got.view(np.uint32), eager.view(np.uint32))
    jitted = np.asarray(jax.jit(jcost.ssim_from_sums)(*map(jnp.asarray, sums)))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=SCORE_ATOL)


def _division_steps(sum_ref, sum_sq_ref, sum_cur, sum_sq_cur, sum_cross,
                    count, div):
    """The steps of `ssim_from_sums` that divide by the pixel count, with
    `div(x, n)` for x / n, and the score they lead to."""
    f32 = torch.float32
    n_i = torch.clamp(count, min=1)
    n = n_i.to(f32)
    steps = {"mean_ref": div(sum_ref.to(f32), n),
             "mean_cur": div(sum_cur.to(f32), n)}
    imean = {k: steps[f"mean_{k}"].to(torch.int32) for k in ("ref", "cur")}
    for k, sx, sq in (("ref", sum_ref, sum_sq_ref), ("cur", sum_cur,
                                                     sum_sq_cur)):
        csq = sq - 2 * imean[k] * sx + n_i * imean[k] * imean[k]
        cs = sx - n_i * imean[k]
        frac = steps[f"mean_{k}"] - imean[k].to(f32)
        num = csq.to(f32) - 2.0 * frac * cs.to(f32) + n * frac * frac
        steps[f"var_{k}"] = div(num, n)
    cross = (sum_cross - imean["cur"] * sum_ref - imean["ref"] * sum_cur
             + count * imean["ref"] * imean["cur"])
    steps["cross_var"] = div(cross.to(f32), n)
    std = {k: tcost._sqrt_rn(torch.clamp(steps[f"var_{k}"], min=0.0))
           for k in ("ref", "cur")}
    c1, c2, c3 = (torch.tensor(c, dtype=f32) for c in (
        tcost.SSIM_C1, tcost.SSIM_C2, tcost.SSIM_C3))
    mr, mc, sr, scur = steps["mean_ref"], steps["mean_cur"], std["ref"], std[
        "cur"]
    steps["score"] = (
        (2.0 * mr * mc + c1) / (mr * mr + mc * mc + c1)
        * ((2.0 * sr * scur + c2) / (sr * sr + scur * scur + c2))
        * ((steps["cross_var"] + c3) / (sr * scur + c3)))
    return steps


@pytest.mark.parametrize("count", [1, 4, 16, 64, 256, 1024])
def test_power_of_two_count_divides_by_multiplying(count):
    """x * (1 / n) equals x / n bit for bit at every step of
    `ssim_from_sums` where n is a power of two, on consistent block sums
    and on arbitrary int32 sums; the division form is `ssim_from_sums`
    itself."""
    blk = int(round(count ** 0.5))
    full = [a[:1500] for a in random_sums(count, blk)]  # whole blocks
    assert (full[5] == count).all()
    rng = np.random.default_rng(count)
    arbitrary = [rng.integers(-2**31, 2**31, 3000).astype(np.int32)
                 for _ in range(5)] + [np.full(3000, count, np.int32)]
    for sums in (full, arbitrary):
        t = list(map(torch.from_numpy, sums))
        divide = _division_steps(*t, div=lambda x, n: x / n)
        multiply = _division_steps(*t, div=lambda x, n: x * (1.0 / n))
        want = tcost.ssim_from_sums(t[0], t[1], t[2], t[3], t[4], t[5])
        assert torch.equal(divide["score"].view(torch.int32),
                           want.view(torch.int32))
        for name, got in multiply.items():
            assert torch.equal(got.view(torch.int32),
                               divide[name].view(torch.int32)), name


def assert_ssim_fields_match(jax_field, torch_field, cur, ref, blk, span):
    """Equal MVs and flat indices, scores within SCORE_ATOL; an index may
    differ only where JAX's cost volume ties the two candidates."""
    j_idx = np.asarray(jax_field.best_cost_i32)
    t_idx = torch_field.best_cost_i32.cpu().numpy()
    assert t_idx.dtype == j_idx.dtype == np.int32
    differ = j_idx != t_idx
    if differ.any():
        _, volume = jfs.full_search_frame(
            cur, ref, blk_dim=blk, span=span, metric="ssim",
            return_cost_volume=True,
        )
        volume = np.asarray(volume)
        by, bx = np.nonzero(differ)
        np.testing.assert_allclose(
            volume[t_idx[differ], by, bx], volume[j_idx[differ], by, bx],
            rtol=0, atol=SCORE_ATOL,
            err_msg="MV differs from JAX without a float32 tie",
        )
    for name in ("mv_y", "mv_x"):
        want = np.asarray(getattr(jax_field, name))[~differ]
        got = getattr(torch_field, name).cpu().numpy()[~differ]
        np.testing.assert_array_equal(got, want, err_msg=name)
    score = torch_field.score.cpu().numpy()
    assert score.dtype == np.float32
    np.testing.assert_allclose(
        score, np.asarray(jax_field.score), rtol=0, atol=SCORE_ATOL
    )


# (h, w, blk, span): tests/test_ssim_golden.py's shapes, blk 32, blk > 32.
GOLDEN_CASES = [
    (24, 32, 8, 3), (36, 52, 8, 5), (33, 45, 4, 4), (32, 32, 16, 5),
    (72, 96, 32, 4), (45, 45, 40, 3),
]


@pytest.mark.parametrize("h,w,blk,span", GOLDEN_CASES)
def test_golden_ssim_matches_jax(h, w, blk, span):
    cur, ref = random_pair(h * 100 + w + blk + span, h, w)
    kw = dict(blk_dim=blk, span=span, metric="ssim")
    want = jfs.full_search_frame(cur, ref, **kw)
    got = tfs.full_search_frame(torch.from_numpy(cur), torch.from_numpy(ref), **kw)
    assert_ssim_fields_match(want, got, cur, ref, blk, span)


# (h, w, blk, span, tile): tests/test_pallas_ssim.py's tiles, and span 0.
PALLAS_CASES = [
    (36, 52, 8, 5, 32), (33, 45, 4, 3, 24), (72, 96, 32, 4, 32),
    (96, 96, 12, 3, 32), (40, 36, 8, 0, 32),
]


@pytest.mark.parametrize("h,w,blk,span,tile", PALLAS_CASES)
def test_plain_kernels_match_pallas(h, w, blk, span, tile):
    cur, ref = random_pair(h * 3 + w + blk + span, h, w)
    want = jsp.ssim_search_frame_pallas(
        cur, ref, blk_dim=blk, span=span, tile=tile, interpret=True
    )
    launches = (sc.ssim_fast_search.launches, sc.ssim_search.launches)
    got = sc.ssim_search_frame_cuda(cur, ref, blk_dim=blk, span=span,
                                    device="cpu")
    assert_ssim_fields_match(want, got, cur, ref, blk, span)
    # The plain versions never count as launches.
    assert (sc.ssim_fast_search.launches, sc.ssim_search.launches) == launches


@pytest.mark.parametrize("h,w,blk,span", [
    (13, 17, 1, 2), (23, 29, 3, 4), (39, 53, 17, 3), (45, 62, 20, 4),
    (59, 83, 27, 2), (67, 95, 31, 3),
])
def test_fast_instances_match_pallas(h, w, blk, span):
    """The plain versions against `ssim_search_frame_pallas(interpret=True)`
    at block sizes that the fast kernel serves with compile-time instances
    of their own, interior and both truncated edges. On the CPU no kernel
    instance runs: `test_fast_kernel_matches_plain_cuda` holds them on the
    card."""
    cur, ref = random_pair(blk * 10 + span, h, w)
    want = jsp.ssim_search_frame_pallas(cur, ref, blk_dim=blk, span=span,
                                        interpret=True)
    got = sc.ssim_search_frame_cuda(cur, ref, blk_dim=blk, span=span,
                                    device="cpu")
    assert_ssim_fields_match(want, got, cur, ref, blk, span)


@pytest.mark.parametrize("h,w,blk,span", [(36, 52, 8, 5), (33, 45, 4, 3),
                                          (72, 100, 32, 4)])
def test_edge_slabs_match_pallas(h, w, blk, span):
    """The truncated-extent kernel's plain version on the bottom and right
    slabs vs `_ssim_edge_bottom` / `_ssim_edge_right` (`_kernel_ssim`)."""
    cur, ref = random_pair(h + w, h, w)
    halo = F.pad(torch.from_numpy(ref), (span, span, span, span))
    kw = dict(blk_dim=blk, span=span)
    nby, nbx = -(-h // blk), -(-w // blk)
    for name, axis, n in (("bottom", 0, nbx), ("right", 1, nby)):
        j_s, j_i = getattr(jsp, f"_ssim_edge_{name}")(
            cur, ref, interpret=True, **kw)
        t_s, t_i = getattr(sc, f"_ssim_edge_{name}")(
            torch.from_numpy(cur), halo, **kw)
        j_s, j_i = np.asarray(j_s), np.asarray(j_i)
        if axis == 0:
            j_s, j_i, t_s, t_i = j_s[0, :n], j_i[0, :n], t_s[0], t_i[0]
        else:
            j_s, j_i, t_s, t_i = j_s[:n, 0], j_i[:n, 0], t_s[:, 0], t_i[:, 0]
        np.testing.assert_array_equal(t_i.numpy(), j_i)
        np.testing.assert_allclose(t_s.numpy(), j_s, rtol=0, atol=SCORE_ATOL)


def test_constant_frames_raster_first_wins():
    """Every valid candidate scores 1.0: the first in raster order wins."""
    cur = np.full((40, 44), 77, np.uint8)
    want = jfs.full_search_frame(cur, cur, blk_dim=8, span=6, metric="ssim")
    for got in (
        tfs.full_search_frame(torch.from_numpy(cur), torch.from_numpy(cur),
                              blk_dim=8, span=6, metric="ssim"),
        sc.ssim_search_frame_cuda(cur, cur, blk_dim=8, span=6, device="cpu"),
    ):
        assert_ssim_fields_match(want, got, cur, cur, 8, 6)
        assert int(got.mv_y[2, 2]) == -6 and int(got.mv_x[2, 2]) == -6
        assert int(got.mv_y[0, 0]) == 0 and int(got.mv_x[0, 0]) == 0
        assert float(got.score.max()) == float(got.score.min()) == 1.0


def test_inverted_frame_span0_keeps_default():
    """cur = 255 - ref at span 0: the only candidate scores below 0, so
    every block keeps score 0.0 and the centre MV."""
    _, ref = random_pair(11, 32, 40)
    cur = (255 - ref).astype(np.uint8)
    want = jfs.full_search_frame(cur, ref, blk_dim=8, span=0, metric="ssim")
    got = sc.ssim_search_frame_cuda(cur, ref, blk_dim=8, span=0, device="cpu")
    assert_ssim_fields_match(want, got, cur, ref, 8, 0)
    assert not got.score.any() and not got.mv_y.any() and not got.mv_x.any()
    assert (got.best_cost_i32 == 0).all()  # the centre index at span 0


def test_ssim_supported_matches_jax():
    for blk in (1, 4, 7, 16, 24, 32, 33, 64):
        for span in (0, 1, 7):
            assert sc.ssim_supported(blk, span) == jsp.ssim_supported(blk, span)


@pytest.mark.parametrize("blk,span,nbx", [(0, 3, 80), (33, 3, 80),
                                          (16, -1, 80), (16, 7, 0)])
def test_fast_occupancy_rejects_what_the_kernel_does_not_cover(blk, span,
                                                               nbx):
    """The resource query checks its config before it reaches the card."""
    with pytest.raises(ValueError, match="no fast SSIM kernel"):
        sc.ssim_fast_occupancy(blk, span, nbx)


def test_fast_kernel_rejects_what_it_does_not_cover():
    cur, ref = random_pair(5, 40, 40)
    cur_t = torch.from_numpy(cur)
    halo = F.pad(torch.from_numpy(ref), (2, 2, 2, 2))
    kw = dict(span=2, frame_height=40, frame_width=40)
    with pytest.raises(ValueError, match="blk_dim <= 32"):
        sc.ssim_fast_search(cur_t, halo, blk_dim=40, **kw)
    with pytest.raises(ValueError, match="whole in-frame blocks"):
        sc.ssim_fast_search(cur_t[:36], halo, blk_dim=8, **kw)
    with pytest.raises(ValueError, match="cuts blocks"):
        sc.ssim_search(cur_t[:20], halo, blk_dim=8, **kw)


def test_run_pair_ssim_cpu_matches_golden():
    cur, ref = random_pair(4, 40, 56)
    config = SearchConfig(blk_dim=16, span=5, metric="ssim", frame_width=56,
                          frame_height=40)
    res = runner.run_pair(cur, ref, config, device="cpu")
    gold = tfs.full_search_frame(torch.from_numpy(cur), torch.from_numpy(ref),
                                 blk_dim=16, span=5, metric="ssim")
    for name in ("mv_y", "mv_x", "best_cost_i32", "score"):
        np.testing.assert_array_equal(getattr(res.field, name),
                                      getattr(gold, name).numpy())
    assert len(res.timing_row.split()) == 5


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(cuda, h, w, span, seed, inverted=False):
    cur, ref = random_pair(seed, h, w)
    if inverted:
        cur = (255 - ref).astype(np.uint8)
    cur_t = torch.from_numpy(cur).to(cuda)
    halo = F.pad(torch.from_numpy(ref).to(cuda), (span, span, span, span))
    return cur_t, halo


def _assert_exact(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# (h, w, blk, span, y0, x0): every blk at span 0 and at one span >= 3 (7 at
# blk % 4 == 0, as at the 4K cells; 15 at blk % 4 == 3, where blk 27 and
# 31 have warps share a macroblock), on a frame with ragged edges (64 / blk
# + 1 blocks a row, at least five, so tiles end short of their
# macroblocks), at odd blk on a tile off the frame's origin; then the
# earlier fixed cases, on the origin.
FAST_CASES = [
    (3 * blk + 5, max(5, 64 // blk + 1) * blk + 3, blk, span,
     *((blk, 2 * blk) if blk % 2 else (0, 0)))
    for blk in range(1, 33) for span in (0, (7, 3, 5, 15)[blk % 4])
] + [
    (h, w, blk, span, 0, 0)
    for h, w, blk, span in ((64, 96, 4, 5), (63, 98, 7, 3), (96, 200, 8, 12),
                            (96, 96, 12, 3), (96, 160, 16, 15),
                            (96, 96, 24, 3), (128, 256, 32, 7),
                            (64, 64, 8, 0))
]


@pytest.mark.parametrize("volume", [False, True])
@pytest.mark.parametrize("h,w,blk,span,y0,x0", FAST_CASES)
def test_fast_kernel_matches_plain_cuda(cuda, h, w, blk, span, y0, x0,
                                        volume):
    """Every blk the fast kernel serves, each its own compile-time
    instance, with and without its volume, on the whole blocks of the
    frame from (y0, x0)."""
    cur_t, halo = _operands(cuda, h, w, span, blk + span)
    kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w,
              y_origin=y0, x_origin=x0)
    nby, nbx = (h - y0) // blk, (w - x0) // blk
    tile = (cur_t[y0 : y0 + nby * blk, x0 : x0 + nbx * blk], halo[y0:, x0:])
    before = (sc.ssim_fast_search.launches,
              sc.ssim_fast_search.volume_launches)
    got = sc.ssim_fast_search(*tile, return_volume=volume, **kw)
    assert (sc.ssim_fast_search.launches,
            sc.ssim_fast_search.volume_launches) == (before[0] + 1,
                                                     before[1] + volume)
    _assert_exact(got, sc.ssim_plain(*tile, return_volume=volume, **kw))


def test_fast_occupancy_cuda(cuda):
    """K3 at the three SSIM cells: no spills, at least 16 warps resident
    per SM."""
    for h, w, blk, span in ((2160, 3840, 16, 7), (1080, 1920, 16, 15),
                            (2160, 3840, 32, 7)):
        occ = sc.ssim_fast_occupancy(blk, span, w // blk)
        assert occ["local_bytes"] == 0, occ
        assert occ["warps_per_sm"] >= 16, occ


@pytest.mark.parametrize(
    "h,w,blk,span",
    [(70, 90, 32, 8), (47, 61, 8, 5), (50, 77, 12, 7), (45, 45, 40, 3),
     (130, 130, 64, 2)],
)
def test_truncated_kernel_matches_plain_cuda(cuda, h, w, blk, span):
    cur_t, halo = _operands(cuda, h, w, span, blk * span)
    kw = dict(blk_dim=blk, span=span, frame_height=h, frame_width=w)
    before = sc.ssim_search.launches
    got = sc.ssim_search(cur_t, halo, **kw)
    assert sc.ssim_search.launches == before + 1
    _assert_exact(got, sc.ssim_plain(cur_t, halo, **kw))


@pytest.mark.parametrize("h,w,blk,span", [
    (36, 52, 8, 5), (33, 45, 4, 3), (72, 96, 32, 4), (96, 96, 12, 3),
    (45, 45, 40, 3),
])
def test_frame_matches_golden_cuda(cuda, h, w, blk, span):
    cur, ref = random_pair(h + w, h, w)
    got = sc.ssim_search_frame_cuda(cur, ref, blk_dim=blk, span=span,
                                    device=cuda)
    want = tfs.full_search_frame(
        torch.from_numpy(cur).to(cuda), torch.from_numpy(ref).to(cuda),
        blk_dim=blk, span=span, metric="ssim",
    )
    _assert_exact(got, want)


def test_inverted_frame_span0_keeps_default_cuda(cuda):
    cur_t, halo = _operands(cuda, 64, 96, 0, 12, inverted=True)
    kw = dict(blk_dim=16, span=0, frame_height=64, frame_width=96)
    score, idx = sc.ssim_fast_search(cur_t, halo, **kw)
    _assert_exact((score, idx), sc.ssim_plain(cur_t, halo, **kw))
    assert not score.any() and not idx.any()
