"""The port's scaling model (`parallel/scaling.py`) against the bytes its
sharded step moves in a run, and against the JAX package's model.

* Bytes counted in a run: each rank of a mesh of one slot a rank runs
  `sharded_motion_step` alone, with `torch.distributed` replaced by a
  recorder. The busiest rank's `isend` bytes must equal
  `halo_bytes_per_chip`, and every rank's received `broadcast` bytes
  `model_step(...).gather_bytes`; `_reduce_stats` must run two
  all-reduces. Exact equality (integers).
* Against JAX's `scaling.py`, with the port's link constants patched to
  the JAX module's values, dtype_bytes=4 and frames the mesh divides:
  compute, halo bytes, halo seconds and host crossing equal JAX's, and
  the stats term is twice JAX's (two all-reduces where JAX charges one),
  exactly, on meshes where tx > 1 and every split axis has a card that
  sends both ways on every hop. Two JAX counts are pinned: with tx == 1
  the vertical strips are 2*span columns short (the port widens every
  tile), and on a 2-wide axis JAX charges a second direction that no card
  sends.
* Efficiencies lie in (0, 1]; `record_scaling` writes the card beside
  every number and has no default rate.
"""
import types

import numpy as np
import pytest
import torch

from motionestimation_tpu.parallel import scaling as jax_scaling
from motionestimation_tpu_torch.parallel import halo, ingest, scaling
from motionestimation_tpu_torch.parallel import sharded
from motionestimation_tpu_torch.parallel.mesh import Mesh
from motionestimation_tpu_torch.tools import record_scaling

torch.set_num_threads(1)
CPU = torch.device("cpu")


class _Recorder:
    """Stands in for `torch.distributed` in `parallel.halo` and
    `parallel.sharded` for one rank: records the bytes of each `isend`,
    of each `broadcast` from another rank, and the all-reduces; the
    receive buffers stay as allocated."""

    isend, irecv = "isend", "irecv"

    class ReduceOp:
        SUM, MAX = "sum", "max"

    def __init__(self, rank):
        self.rank = rank
        self.sent = 0
        self.received = 0
        self.all_reduces = []

    def is_initialized(self):
        return True

    def get_backend(self):
        return "gloo"

    def P2POp(self, op, tensor, peer, tag=0):  # noqa: N802 - torch's name
        if op == self.isend:
            self.sent += tensor.numel() * tensor.element_size()
        return op

    def batch_isend_irecv(self, ops):
        return [types.SimpleNamespace(wait=lambda: None) for _ in ops]

    def broadcast(self, tensor, src):
        if src != self.rank:
            self.received += tensor.numel() * tensor.element_size()

    def all_reduce(self, tensor, op):
        self.all_reduces.append(op)


def _run_rank(monkeypatch, rank, ty, tx, h, w, blk, span):
    """One rank's sharded step on a (1, ty, tx) mesh of one CPU slot a rank;
    returns its recorder."""
    rec = _Recorder(rank)
    monkeypatch.setattr(halo, "dist", rec)
    monkeypatch.setattr(sharded, "dist", rec)
    n = ty * tx
    devices = np.empty(n, dtype=object)
    devices[:] = [CPU] * n
    mesh = Mesh(devices.reshape(1, ty, tx), np.arange(n).reshape(1, ty, tx))
    mesh.rank = rank
    hp, wp = sharded.padded_dims_for_mesh(h, w, blk, mesh)
    th, tw = hp // ty, wp // tx
    rng = np.random.default_rng(rank)
    slot = mesh.local_slots()[0]
    cur, ref = (ingest.FrameShards((1, hp, wp), {slot: torch.from_numpy(
        rng.integers(0, 256, (1, th, tw), dtype=np.uint8))})
        for _ in range(2))
    sharded.sharded_motion_step(cur, ref, mesh=mesh, blk_dim=blk, span=span,
                                frame_height=h, frame_width=w)
    return rec


# (ty, tx, span) on a 30x37 frame at blk 4: tiles of 8 to 40 rows and
# columns after the mesh padding; span 9 exceeds the (4, 4) tiles
# (two hops on both axes) and the (1, 4) and (2, 2) tiles' widths.
RUN_CASES = [
    (1, 2, 3), (2, 1, 3), (2, 2, 3), (1, 4, 3), (4, 4, 3),
    (1, 2, 9), (2, 1, 9), (2, 2, 9), (1, 4, 9), (4, 4, 9),
]


@pytest.mark.parametrize("ty,tx,span", RUN_CASES)
def test_model_bytes_equal_bytes_counted_in_a_run(monkeypatch, ty, tx, span):
    h, w, blk = 30, 37, 4
    recs = [_run_rank(monkeypatch, r, ty, tx, h, w, blk, span)
            for r in range(ty * tx)]
    model = scaling.model_step(frame_height=h, frame_width=w, blk_dim=blk,
                               span=span, ty=ty, tx=tx,
                               measured_mblocks_per_s=1.0)
    assert max(r.sent for r in recs) == model.halo_bytes
    assert scaling.halo_bytes_per_chip(h, w, span, ty, tx,
                                       blk_dim=blk) == model.halo_bytes
    assert all(r.received == model.gather_bytes for r in recs)
    assert all(r.all_reduces == ["sum", "max"] for r in recs)
    assert model.halo_bytes > 0 and model.gather_bytes > 0


def test_one_card_moves_nothing():
    m = scaling.model_step(frame_height=2160, frame_width=3840, blk_dim=8,
                           span=12, ty=1, tx=1, measured_mblocks_per_s=400.0)
    assert (m.halo_bytes, m.halo_s, m.stats_s, m.gather_bytes,
            m.gather_s) == (0, 0.0, 0.0, 0, 0.0)
    assert m.step_s == m.compute_s == 2160 // 8 * 3840 // 8 / 400e6


@pytest.fixture
def jax_constants(monkeypatch):
    """The port's link constants set to the JAX module's values."""
    for port, jax_name in (("NVLINK_BYTES_PER_S", "ICI_LINK_BYTES_PER_S"),
                           ("NVLINK_HOP_LATENCY_S", "ICI_HOP_LATENCY_S"),
                           ("IB_BYTES_PER_S", "DCN_BYTES_PER_S"),
                           ("IB_LATENCY_S", "DCN_LATENCY_S"),
                           ("CHIPS_PER_HOST", "CHIPS_PER_HOST"),
                           ("HOST_TY", "HOST_TY"), ("HOST_TX", "HOST_TX")):
        monkeypatch.setattr(scaling, port, getattr(jax_scaling, jax_name))


# A 2304x4608 frame at blk 8 divides over every mesh below (no padding).
JAX_H, JAX_W = 2304, 4608


def _both(ty, tx, span, rate=14.41):
    kw = dict(frame_height=JAX_H, frame_width=JAX_W, blk_dim=8, span=span,
              ty=ty, tx=tx, measured_mblocks_per_s=rate, dtype_bytes=4)
    return scaling.model_step(**kw), jax_scaling.model_step(**kw)


@pytest.mark.parametrize("ty,tx,span", [
    (1, 4, 12), (1, 8, 12), (4, 4, 12), (4, 8, 12), (3, 6, 31),
    (6, 6, 500),   # two hops on both axes, across hosts
    (1, 8, 1200),  # three hops along "tx"
])
def test_terms_equal_jax_with_its_constants(jax_constants, ty, tx, span):
    port, jax = _both(ty, tx, span)
    assert port.compute_s == jax.compute_s
    assert port.halo_bytes == jax.halo_bytes
    assert port.halo_s == jax.halo_s
    assert port.crosses_hosts == jax.crosses_hosts
    assert port.stats_s == 2 * jax.stats_s
    assert scaling.halo_bytes_per_chip(
        JAX_H, JAX_W, span, ty, tx, blk_dim=8, dtype_bytes=4) == (
        jax_scaling.halo_bytes_per_chip(JAX_H, JAX_W, span, ty, tx))


@pytest.mark.parametrize("ty,span", [(4, 12), (8, 31), (6, 500)])
def test_jax_undercounts_vertical_strips_when_tx_is_1(jax_constants, ty,
                                                      span):
    port, jax = _both(ty, 1, span)
    rows = 2 * span if ty > 2 else span  # both directions: an inner card
    # Every vertical strip is 2*span columns wider than JAX counts it.
    assert port.halo_bytes - jax.halo_bytes == rows * 2 * span * 4
    assert port.compute_s == jax.compute_s


def test_jax_charges_a_second_direction_on_a_2_wide_axis(jax_constants):
    port, jax = _both(2, 4, 12)
    tile_w = JAX_W // 4
    # One vertical strip of the widened tile, which no card of a 2-row
    # mesh sends twice.
    assert jax.halo_bytes - port.halo_bytes == 12 * (tile_w + 24) * 4


def test_constants_are_derated_public_h100_numbers():
    assert scaling.NVLINK_BYTES_PER_S == 900e9 / 2 * 0.5
    assert scaling.IB_BYTES_PER_S == 400e9 / 8 * 0.5
    assert (scaling.CHIPS_PER_HOST, scaling.HOST_TY, scaling.HOST_TX) == (
        8, 2, 4)
    names = set(vars(scaling))
    assert not {n for n in names if n.startswith(("ICI", "DCN"))}


@pytest.mark.parametrize("blk,span,rate", [(8, 12, 424.0), (16, 15, 87.0),
                                           (8, 31, 5.0)])
def test_efficiencies_in_unit_interval(blk, span, rate):
    kw = dict(frame_height=2160, frame_width=3840, blk_dim=blk, span=span,
              measured_mblocks_per_s=rate)
    meshes = [(1, 2), (2, 2), (2, 4), (4, 4), (4, 8)]
    curves = [
        scaling.scaling_efficiency(meshes=meshes, **kw),
        scaling.spatial_gop_overlap_efficiency(meshes=meshes, **kw),
        scaling.gop_scaling_efficiency(n_hosts=[1, 2, 4, 16], **kw),
        scaling.gop_scaling_efficiency(n_hosts=[1, 2, 4, 16],
                                       host_ingest_mb_s=50.0, **kw),
    ]
    for curve in curves:
        assert all(0 < e <= 1 for e in curve.values()), curve
    assert curves[2][1] == 1.0
    # Slow ingest hides the step on every host count.
    assert curves[3][16] == 1.0


def test_gop_charges_the_gather_across_hosts():
    """Pairs over hosts: each card receives the other hosts' results
    through its InfiniBand port, which the per-pair time carries."""
    kw = dict(frame_height=2160, frame_width=3840, blk_dim=8, span=12,
              measured_mblocks_per_s=424.0)
    base = scaling.model_step(ty=2, tx=4, **kw)
    eff = scaling.gop_scaling_efficiency(n_hosts=[2], **kw)[2]
    tile = (2160 // 2) * (3840 // 4)
    slot = 4 * (3 * tile // 64 + tile)
    hops = 1
    t2 = (base.step_s + 2 * scaling.IB_LATENCY_S * hops
          + 8 * slot / scaling.IB_BYTES_PER_S
          + 4 * 2 * 8 * scaling.IB_LATENCY_S * hops)
    assert eff == pytest.approx(base.step_s / t2, rel=1e-12)


def test_record_scaling_writes_the_card_beside_every_number(tmp_path,
                                                            capsys):
    out = tmp_path / "scaling.txt"
    assert record_scaling.main([
        "--headline", "424.5", "--north", "87.6", "--ingest-mb-s", "52000",
        "--card", "Test card, 1.00 W", "--out", str(out)]) == 0
    lines = out.read_text().splitlines()
    numbered = [ln for ln in lines if ln.startswith(
        ("hosts", "chips", "compute", "halo", "stats", "gather", "step", "["))]
    assert len(numbered) == 3 * 6 + 2 * 6 + 3 * 6
    assert all(ln.endswith(("| Test card, 1.00 W", "| Test card, 1.00 W ]"))
               for ln in numbered)
    assert "424.5 M blocks/s" in out.read_text()
    capsys.readouterr()
    with pytest.raises(SystemExit):
        record_scaling.main(["--headline", "1", "--card", "x",
                             "--out", str(out)])
