"""The port's cost volumes vs the JAX package.

* The golden `full_search_frame(..., return_cost_volume=True)` against
  JAX's: MSE and SAD volumes equal entry for entry (INT32_MAX at invalid
  candidates); SSIM volumes bit-equal to JAX run eagerly
  (`jax.disable_jit()`) and within 1e-6 of it jitted, -inf at invalid
  candidates.
* `full_search_volume_cuda(device="cpu")` (the plain versions of the
  kernels' emit modes, and the golden slabs) against the JAX golden tile
  volume on every entry, and against `full_search_volume_pallas
  (interpret=True)` on every valid entry. JAX's interpret-mode volume holds
  two sentinels where a candidate is invalid: 3e8 from `_kernel_f32`'s emit
  (cast to int32) and INT32_MAX from its golden edge slabs. The port holds
  INT32_MAX at every invalid entry.
* `volume_supported` equals JAX's.

Tests whose names end in `_cuda` hold the kernels' volumes against the
golden volume on the card and skip where there is none:
`python -m pytest --noconftest tests/test_torch_volume.py -k cuda`.
"""
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from motionestimation_tpu.kernels import full_search_pallas as kp
from motionestimation_tpu.search import full_search as jfs
from motionestimation_tpu_torch.kernels import full_search_cuda as kc
from motionestimation_tpu_torch.search import full_search as tfs

# The tests run in several worker processes on shared cores; one torch
# thread per worker keeps them from oversubscribing the machine.
torch.set_num_threads(1)

INT32_MAX = 2**31 - 1
SCORE_ATOL = 1e-6


def random_pair(seed, h, w):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = np.roll(ref, (rng.integers(-3, 4), rng.integers(-3, 4)), (0, 1))
    cur = np.clip(
        cur.astype(np.int32) + rng.integers(-6, 7, (h, w)), 0, 255
    ).astype(np.uint8)
    return cur, ref


def valid_mask(h, w, blk, span):
    """[K², nby, nbx]: is candidate c of block (by, bx) inside the frame?"""
    k = 2 * span + 1
    nby, nbx = -(-h // blk), -(-w // blk)
    tl_y = np.arange(nby) * blk
    tl_x = np.arange(nbx) * blk
    ext_y = np.clip(h - tl_y, 0, blk)
    ext_x = np.clip(w - tl_x, 0, blk)
    d = np.arange(-span, span + 1)
    ok_y = (tl_y[None] + d[:, None] >= 0) & (
        tl_y[None] + d[:, None] <= h - ext_y[None])
    ok_x = (tl_x[None] + d[:, None] >= 0) & (
        tl_x[None] + d[:, None] <= w - ext_x[None])
    return (ok_y[:, None, :, None] & ok_x[None, :, None, :]).reshape(
        k * k, nby, nbx)


def _torch_frames(cur, ref):
    return torch.from_numpy(cur), torch.from_numpy(ref)


@pytest.mark.parametrize("metric", ["mse", "sad"])
@pytest.mark.parametrize("h,w,blk,span", [(36, 52, 8, 5), (37, 51, 7, 3),
                                          (40, 56, 32, 3)])
def test_golden_volume_matches_jax(h, w, blk, span, metric):
    cur, ref = random_pair(h + w + blk, h, w)
    kw = dict(blk_dim=blk, span=span, metric=metric, return_cost_volume=True)
    j_field, j_vol = jfs.full_search_frame(cur, ref, **kw)
    t_field, t_vol = tfs.full_search_frame(*_torch_frames(cur, ref), **kw)
    assert t_vol.dtype == torch.int32
    np.testing.assert_array_equal(t_vol.numpy(), np.asarray(j_vol))
    assert (t_vol.numpy()[~valid_mask(h, w, blk, span)] == INT32_MAX).all()
    for name in ("mv_y", "mv_x", "best_cost_i32", "score"):
        np.testing.assert_array_equal(getattr(t_field, name).numpy(),
                                      np.asarray(getattr(j_field, name)))


@pytest.mark.parametrize("h,w,blk,span", [(24, 32, 8, 3), (21, 27, 5, 2)])
def test_golden_ssim_volume_matches_jax(h, w, blk, span):
    cur, ref = random_pair(h * w + blk, h, w)
    kw = dict(blk_dim=blk, span=span, metric="ssim", return_cost_volume=True)
    _, t_vol = tfs.full_search_frame(*_torch_frames(cur, ref), **kw)
    t_vol = t_vol.numpy()
    assert t_vol.dtype == np.float32
    with jax.disable_jit():
        _, eager = jfs.full_search_frame(cur, ref, **kw)
    eager = np.asarray(eager)
    np.testing.assert_array_equal(t_vol.view(np.uint32), eager.view(np.uint32))
    _, jitted = jfs.full_search_frame(cur, ref, **kw)
    np.testing.assert_allclose(t_vol, np.asarray(jitted), rtol=0,
                               atol=SCORE_ATOL)
    assert (t_vol[~valid_mask(h, w, blk, span)] == -np.inf).all()


# (h, w, blk, span, metric): phase configs (the phase kernel's emit on the
# card), MSE outside it (the chunked kernel's emit), SAD outside it (the
# golden volume, as the JAX package computes it in XLA).
VOLUME_CASES = [
    (64, 64, 8, 4, "mse"), (61, 75, 8, 5, "mse"), (36, 52, 12, 3, "mse"),
    (40, 56, 32, 3, "mse"), (36, 52, 8, 5, "sad"), (36, 52, 12, 3, "sad"),
    # SAD at blk 7: the int kernel's emit mode over the whole frame.
    (30, 44, 7, 1, "sad"), (37, 51, 7, 3, "sad"), (29, 45, 7, 5, "sad"),
]


@pytest.mark.parametrize("h,w,blk,span,metric", VOLUME_CASES)
def test_volume_matches_jax(h, w, blk, span, metric):
    cur, ref = random_pair(h * 5 + w + blk, h, w)
    launches = (kc.phase_search.launches, kc.chunked_search.launches)
    got = kc.full_search_volume_cuda(cur, ref, blk_dim=blk, span=span,
                                     metric=metric, device="cpu")
    assert (kc.phase_search.launches, kc.chunked_search.launches) == launches
    got = got.numpy()
    assert got.dtype == np.int32
    _, golden = jfs.full_search_frame(cur, ref, blk_dim=blk, span=span,
                                      metric=metric, return_cost_volume=True)
    np.testing.assert_array_equal(got, np.asarray(golden))
    valid = valid_mask(h, w, blk, span)
    assert (got[~valid] == INT32_MAX).all()
    pallas = np.asarray(kp.full_search_volume_pallas(
        cur, ref, blk_dim=blk, span=span, metric=metric, interpret=True))
    np.testing.assert_array_equal(got[valid], pallas[valid])


def test_jax_volume_mixes_sentinels():
    """The reference-side quirk the port does not inherit: at 36x52 blk 12
    +-3 the interpret-mode JAX volume holds 3e8 (`_kernel_f32`'s emit) and
    INT32_MAX (the golden edge slabs) at invalid candidates."""
    cur, ref = random_pair(36 * 5 + 52 + 12, 36, 52)
    pallas = np.asarray(kp.full_search_volume_pallas(
        cur, ref, blk_dim=12, span=3, metric="mse", interpret=True))
    invalid = pallas[~valid_mask(36, 52, 12, 3)]
    assert set(np.unique(invalid).tolist()) == {300_000_000, INT32_MAX}
    got = kc.full_search_volume_cuda(cur, ref, blk_dim=12, span=3,
                                     device="cpu").numpy()
    assert set(np.unique(got[~valid_mask(36, 52, 12, 3)]).tolist()) == {
        INT32_MAX}


def test_volume_supported_matches_jax():
    for blk in range(1, 34):
        for span in range(4):
            for metric in ("mse", "sad", "ssim"):
                assert kc.volume_supported(blk, span, metric) == (
                    kp.volume_supported(blk, span, metric)), (blk, span, metric)


def test_volume_rejects_unsupported():
    cur, ref = random_pair(3, 48, 48)
    for blk, span, metric in ((24, 3, "mse"), (8, 0, "mse"), (8, 3, "ssim"),
                              (20, 2, "sad")):
        with pytest.raises(ValueError, match="unsupported config"):
            kc.full_search_volume_cuda(cur, ref, blk_dim=blk, span=span,
                                       metric=metric, device="cpu")


def test_interior_volumes_match_golden():
    """The emit modes' plain versions on an interior tile at a global
    origin: the golden tile volume of the same blocks."""
    h, w, span = 64, 80, 4
    cur, ref = random_pair(12, h, w)
    cur_t, ref_t = _torch_frames(cur, ref)
    halo = F.pad(ref_t, (span, span, span, span))
    for fn, blk in ((kc.phase_search, 8), (kc.chunked_search, 12)):
        y0, x0 = blk, 2 * blk
        tile = cur_t[y0 : y0 + 3 * blk, x0 : x0 + 2 * blk]
        cost, idx, vol = fn(tile, halo[y0:, x0:], blk_dim=blk, span=span,
                            metric="mse", frame_height=h, frame_width=w,
                            y_origin=y0, x_origin=x0, return_volume=True)
        field, want = tfs.full_search_tile(
            tile, halo[y0 : y0 + 3 * blk + 2 * span,
                       x0 : x0 + 2 * blk + 2 * span],
            y0, x0, frame_height=h, frame_width=w, blk_dim=blk, span=span,
            return_cost_volume=True)
        assert torch.equal(vol, want) and torch.equal(cost, field.best_cost_i32)


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("h,w,blk,span,metric", VOLUME_CASES + [
    (96, 200, 16, 15, "mse"), (96, 200, 16, 15, "sad"), (70, 98, 7, 7, "mse"),
    (128, 160, 32, 31, "mse"), (64, 96, 1, 2, "sad"),
])
def test_volume_matches_golden_cuda(cuda, h, w, blk, span, metric):
    cur, ref = random_pair(h * 5 + w + blk, h, w)
    got = kc.full_search_volume_cuda(cur, ref, blk_dim=blk, span=span,
                                     metric=metric, device=cuda)
    _, want = tfs.full_search_frame(
        torch.from_numpy(cur).to(cuda), torch.from_numpy(ref).to(cuda),
        blk_dim=blk, span=span, metric=metric, return_cost_volume=True)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("fn,blk,metric", [
    (kc.phase_search, 8, "mse"), (kc.phase_search, 16, "sad"),
    (kc.chunked_search, 7, "mse"), (kc.chunked_search, 16, "mse"),
])
def test_emit_matches_plain_cuda(cuda, fn, blk, metric):
    h, w, span = 96, 160, 6
    cur, ref = random_pair(blk, h, w)
    cur_t = torch.from_numpy(cur).to(cuda)
    halo = F.pad(torch.from_numpy(ref).to(cuda), (span, span, span, span))
    tile = cur_t[: h // blk * blk, : w // blk * blk]
    kw = dict(blk_dim=blk, span=span, metric=metric, frame_height=h,
              frame_width=w, return_volume=True)
    before = fn.launches
    got = fn(tile, halo, **kw)
    assert fn.launches == before + 1
    for a, b in zip(got, kc.search_plain(tile, halo, **kw)):
        assert a.dtype == b.dtype and torch.equal(a, b)
