"""The port's halo exchange (`parallel/halo.halo_exchange_2d`) against the
single-card halo (`search.full_search.make_ref_halo`), tile by tile, and
against the JAX package's exchange on its virtual CPU mesh.

Every slot's exchanged halo must equal the window of the zero-padded
reference that `make_ref_halo` builds, bit for bit: single hops, halos
wider than a tile (several hops, tests/test_sharded.py:111-118), span 0,
and frames whose mesh padding leaves whole tiles outside the frame. A
started exchange has issued every transfer of both sweeps before its
`wait()`, counted with `torch.distributed` replaced by a recorder.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

from motionestimation_tpu.parallel import halo as jax_halo
from motionestimation_tpu.parallel import make_mesh as jax_make_mesh
from motionestimation_tpu_torch.parallel import halo, ingest, make_mesh
from motionestimation_tpu_torch.parallel import sharded
from motionestimation_tpu_torch.parallel.mesh import Mesh
from motionestimation_tpu_torch.search import full_search as fs

torch.set_num_threads(1)
CPU = torch.device("cpu")

# (dp, ty, tx, h, w, blk, span)
CASES = [
    (1, 2, 4, 64, 96, 8, 5),
    (1, 4, 2, 64, 96, 8, 12),
    (1, 1, 8, 48, 128, 8, 4),
    (1, 8, 1, 128, 48, 8, 4),
    (2, 2, 2, 64, 64, 16, 7),
    (1, 2, 2, 36, 52, 4, 5),
    (1, 1, 4, 32, 128, 8, 31),   # span == tile width
    (1, 4, 2, 64, 32, 8, 20),    # two hops vertically
    (1, 2, 4, 32, 64, 8, 20),    # and horizontally
    (1, 4, 1, 32, 32, 8, 31),    # nearly the whole frame
    (1, 4, 2, 20, 20, 8, 3),     # tiles wholly in the mesh padding
    (1, 2, 2, 64, 64, 8, 0),
]


def _want_halo(ref, hp, wp, blk, span):
    """`make_ref_halo`, zero-extended to the mesh-padded frame."""
    h, w = ref.shape
    halo_g = fs.make_ref_halo(ref, h, w, blk, span)
    return F.pad(halo_g, (0, wp + 2 * span - halo_g.shape[1],
                          0, hp + 2 * span - halo_g.shape[0]))


@pytest.mark.parametrize("dp,ty,tx,h,w,blk,span", CASES)
def test_halo_equals_make_ref_halo_tile_by_tile(dp, ty, tx, h, w, blk, span):
    rng = np.random.default_rng(h * w + span)
    refs = rng.integers(0, 256, (dp, h, w), dtype=np.uint8)
    mesh = make_mesh(dp, ty, tx, devices=[CPU] * (dp * ty * tx))
    hp, wp = sharded.padded_dims_for_mesh(h, w, blk, mesh)
    shards = ingest.put_frame_batch(
        np.pad(refs, ((0, 0), (0, hp - h), (0, wp - w))), mesh)
    got = halo.halo_exchange_2d(shards.tiles, span, mesh)
    th, tw = hp // ty, wp // tx
    assert sorted(got) == mesh.slots()
    for (d, iy, ix), t in got.items():
        assert t.dtype == torch.uint8
        assert tuple(t.shape) == (1, th + 2 * span, tw + 2 * span)
        want = _want_halo(refs[d], hp, wp, blk, span)[
            iy * th : iy * th + th + 2 * span,
            ix * tw : ix * tw + tw + 2 * span]
        assert torch.equal(t[0].to(torch.int32), want), (d, iy, ix)


@pytest.mark.parametrize("ty,tx,h,w,span", [(2, 4, 64, 96, 5),
                                            (4, 2, 64, 32, 20),
                                            (2, 4, 32, 64, 20)])
def test_halo_equals_jax_exchange(ty, tx, h, w, span):
    """The same tiles through JAX `halo_exchange_2d` under `shard_map`."""
    rng = np.random.default_rng(ty * tx + span)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    jmesh = jax_make_mesh(1, ty, tx)
    th, tw = h // ty, w // tx

    def exchange(t):
        return jax_halo.halo_exchange_2d(t, span, ty_size=ty, tx_size=tx)

    jgot = np.asarray(jax.shard_map(
        exchange, mesh=jmesh, in_specs=P("ty", "tx"),
        out_specs=P("ty", "tx"), check_vma=False,
    )(jnp.asarray(ref, jnp.int32)))
    mesh = make_mesh(1, ty, tx, devices=[CPU] * (ty * tx))
    got = halo.halo_exchange_2d(
        ingest.put_frame_batch(ref[None], mesh).tiles, span, mesh)
    hh, hw = th + 2 * span, tw + 2 * span
    for (_, iy, ix), t in got.items():
        np.testing.assert_array_equal(
            t[0].numpy().astype(np.int32),
            jgot[iy * hh : (iy + 1) * hh, ix * hw : (ix + 1) * hw])


def test_halo_keeps_leading_dims_and_devices():
    mesh = make_mesh(1, 2, 2, devices=[CPU] * 4)
    tiles = {s: torch.full((3, 8, 8), 10 * s[1] + s[2], dtype=torch.int32)
             for s in mesh.slots()}
    got = halo.halo_exchange_2d(tiles, 2, mesh)
    t = got[0, 0, 0]
    assert tuple(t.shape) == (3, 12, 12) and t.dtype == torch.int32
    assert (t[:, 2:10, 10:] == 1).all() and (t[:, 10:, 2:10] == 10).all()
    assert (t[:, 10:, 10:] == 11).all() and (t[:, :2] == 0).all()
    assert halo.halo_exchange_2d(tiles, 0, mesh) == tiles


@pytest.mark.parametrize("dp,ty,tx,h,w,blk,span", CASES)
def test_started_exchange_equals_exchange(dp, ty, tx, h, w, blk, span):
    """`start_halo_exchange_2d(...)()` gives `halo_exchange_2d`'s halos,
    with tiles computed on between the two calls."""
    rng = np.random.default_rng(h + w + span)
    refs = rng.integers(0, 256, (dp, h, w), dtype=np.uint8)
    mesh = make_mesh(dp, ty, tx, devices=[CPU] * (dp * ty * tx))
    hp, wp = sharded.padded_dims_for_mesh(h, w, blk, mesh)
    tiles = ingest.put_frame_batch(
        np.pad(refs, ((0, 0), (0, hp - h), (0, wp - w))), mesh).tiles
    want = halo.halo_exchange_2d(tiles, span, mesh)
    wait = halo.start_halo_exchange_2d(tiles, span, mesh)
    _ = [t.sum() for t in tiles.values()]  # work between issue and wait
    got = wait()
    assert sorted(got) == sorted(want)
    for slot, t in got.items():
        assert torch.equal(t, want[slot]), slot


class _P2PRecorder:
    """Stands in for `torch.distributed` in `parallel.halo` for one rank:
    records the shape of every send and receive each `batch_isend_irecv`
    issues; the receive buffers stay as allocated."""

    isend, irecv = "isend", "irecv"

    def __init__(self):
        self.issued = []

    def is_initialized(self):
        return True

    def get_backend(self):
        return "gloo"

    def P2POp(self, op, tensor, peer, tag=0):  # noqa: N802 - torch's name
        return op, tuple(tensor.shape)

    def batch_isend_irecv(self, ops):
        self.issued += ops
        return [types.SimpleNamespace(wait=lambda: None) for _ in ops]


# (ty, tx, h, w, blk, span): one hop, and two hops on either axis.
SWEEP_CASES = [
    (2, 2, 64, 64, 8, 5),
    (1, 4, 32, 128, 8, 31),
    (4, 1, 128, 48, 8, 4),
    (4, 2, 64, 32, 8, 20),
    (2, 4, 32, 64, 8, 20),
]


@pytest.mark.parametrize("ty,tx,h,w,blk,span", SWEEP_CASES)
def test_started_exchange_has_issued_both_sweeps(monkeypatch, ty, tx, h, w,
                                                 blk, span):
    """When `start_halo_exchange_2d` returns, every rank (one slot each)
    has issued every send and receive of both sweeps: the "tx" strips
    ([1, tile_h, k] columns) and the "ty" strips of the widened tile ([1,
    k, tile_w + 2*span] rows), one send and one receive a neighbour and
    hop; `wait()` issues none."""
    n = ty * tx
    devices = np.empty(n, dtype=object)
    devices[:] = [CPU] * n
    mesh = Mesh(devices.reshape(1, ty, tx), np.arange(n).reshape(1, ty, tx))
    hp, wp = sharded.padded_dims_for_mesh(h, w, blk, mesh)
    th, tw = hp // ty, wp // tx
    for rank, (_, iy, ix) in enumerate(mesh.slots()):
        rec = _P2PRecorder()
        monkeypatch.setattr(halo, "dist", rec)
        mesh.rank = rank
        tiles = {(0, iy, ix): torch.zeros((1, th, tw), dtype=torch.uint8)}
        wait = halo.start_halo_exchange_2d(tiles, span, mesh)
        issued = list(rec.issued)
        got = wait()
        assert rec.issued == issued, "wait() issued a transfer"
        assert tuple(got[0, iy, ix].shape) == (1, th + 2 * span,
                                               tw + 2 * span)

        def neighbours(p, size, axis_n):
            """Hops k with a neighbour before and after position p."""
            hops = -(-span // size)
            return sum((p - k >= 0) + (p + k < axis_n)
                       for k in range(1, hops + 1))

        want_tx, want_ty = neighbours(ix, tw, tx), neighbours(iy, th, ty)
        tx_ops = [o for o in issued if o[1][1] == th and o[1][2] != tw + 2
                  * span]
        ty_ops = [o for o in issued if o[1][2] == tw + 2 * span]
        assert len(issued) == 2 * (want_tx + want_ty)
        for ops, want in ((tx_ops, want_tx), (ty_ops, want_ty)):
            assert [op for op, _ in ops].count("isend") == want
            assert [op for op, _ in ops].count("irecv") == want
