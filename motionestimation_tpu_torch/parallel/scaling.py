"""Analytic 1 -> N scaling model of the port's sharded step on HGX H100 hosts.

The port of `motionestimation_tpu.parallel.scaling`, with its structure:
per-hop halo strips, the worst chip's time as the step time, an axis that
spans hosts charged at the inter-host link in its crossing direction, and
`max(ingest, step + sync)` per pair for a GOP. Compute comes from a
measured single-card rate (M blocks/s); every other term is computed from
the arrays the port's step moves, one process per card:

  compute = the busiest tile's blocks / the measured rate. Tiles are the
            mesh-padded tiles (`sharded.padded_dims_for_mesh`).
  halo    = the two sweeps of `halo._halo_1d`: strips of the raw tile
            along "tx", then strips of the widened tile along "ty". The
            tile is widened along "tx" even where tx == 1 (the pieces are
            then zeros made locally), so the vertical strips are always
            tile_w + 2*span wide. Per hop k a strip is min(size, span -
            (k-1)*size) deep, sent to the k-th neighbour on each side that
            exists: the busiest chip of the actual mesh is charged, and a
            2-wide axis has no chip that sends both ways.
  stats   = `sharded._reduce_stats`: two latency-bound all-reduces (SUM,
            then MAX), each a log2 tree over the cards of a host and then
            over the hosts.
  gather  = `sharded._assemble`: every slot's mv_y, mv_x and cost grids and
            its int32 compensated tile are broadcast to every rank, so each
            card receives the other N-1 slots' results; one collective per
            slot and grid. Reported apart (`gather_bytes`, `gather_s`). The
            JAX step leaves its results sharded and has no such term.
  ingest  = (GOP model) one new uint8 frame per pair per host at a
            measured host-to-card rate, overlapped with compute:
            max(ingest, step + sync).

The halo is not overlapped with the search: the step exchanges, then
searches. `dtype_bytes` defaults to 1: the port's tiles are uint8.

The model leaves out the host's issue of each tile's launches, which on
one card costs more than the kernels (PERF.md §5).

Link constants, from public specs, each derated 50% as the JAX module
derates its TPU ones:

* NVLink 4: an H100 SXM5 has 900 GB/s of NVLink bandwidth, counted both
  ways (NVIDIA H100 Tensor Core GPU datasheet), so 450 GB/s one way;
  charged at 225 GB/s. Every send of a card shares it: NVSwitch joins the
  eight GPUs of an HGX H100 board, so a card's sends to two neighbours
  share its links.
* InfiniBand NDR between hosts: one 400 Gb/s ConnectX-7 port per GPU (the
  DGX H100 system's compute fabric, DGX H100 user guide), so 50 GB/s one
  way; charged at 25 GB/s.
* Latencies: NCCL's own cost model (`src/graph/tuning.cc`, `hwLat`)
  charges one NVLink step below 1 µs and one network step a few µs, on
  top of a per-call base of several µs; we charge 2 µs a NVLink hop and
  10 µs an InfiniBand hop.
* `CHIPS_PER_HOST = 8` (HGX H100 8-GPU board), as a logical (HOST_TY,
  HOST_TX) = (2, 4) sub-mesh. NVSwitch gives every GPU pair of a host one
  hop, so the orientation rule kept from the JAX module (a mesh takes the
  fewest hosts, then the fewest crossing axes) is conservative: any
  eight-card mesh fits one host.
"""
from __future__ import annotations

import dataclasses

from motionestimation_tpu_torch.core.geometry import cdiv

NVLINK_BYTES_PER_S = 225e9
NVLINK_HOP_LATENCY_S = 2e-6
IB_BYTES_PER_S = 25e9
IB_LATENCY_S = 10e-6
CHIPS_PER_HOST = 8
HOST_TY, HOST_TX = 2, 4
# Result grids `_assemble` gathers besides the compensated frame (mv_y,
# mv_x, cost), each int32 or float32.
_GRIDS = 3
_RESULT_BYTES = 4


@dataclasses.dataclass(frozen=True)
class ShardedStepModel:
    """All model terms for one config, in seconds and bytes per frame
    pair."""

    mesh_ty: int
    mesh_tx: int
    compute_s: float
    halo_bytes: int          # bytes the busiest card sends for its halo
    halo_s: float
    stats_s: float
    gather_bytes: int        # bytes each card receives in `_assemble`
    gather_s: float
    crosses_hosts: bool

    @property
    def step_s(self) -> float:
        return self.compute_s + self.halo_s + self.stats_s + self.gather_s


def _tiles(frame_height, frame_width, blk_dim, ty, tx):
    """(tile_h, tile_w) of the mesh-padded frame."""
    return (cdiv(frame_height, blk_dim * ty) * blk_dim,
            cdiv(frame_width, blk_dim * tx) * blk_dim)


def _axis_strips(n: int, size: int, span: int, row_bytes: int):
    """(forward, backward) byte sizes of the strips that the busiest card of
    an axis of `n` tiles of `size` sends, one entry per hop (`_halo_1d`):
    card p sends hop k's strip to p+k and to p-k where those exist."""
    if n == 1 or span == 0:
        return [], []
    widths = [min(size, span - (k - 1) * size)
              for k in range(1, cdiv(span, size) + 1)]

    def sends(p):
        fwd = [w * row_bytes for k, w in enumerate(widths, 1) if p + k < n]
        bwd = [w * row_bytes for k, w in enumerate(widths, 1) if p - k >= 0]
        return fwd, bwd

    return max((sends(p) for p in range(n)), key=lambda s: sum(map(sum, s)))


def _strips(frame_height, frame_width, span, ty, tx, blk_dim, dtype_bytes):
    """((fwd, bwd) along "tx", (fwd, bwd) along "ty") of the busiest card."""
    tile_h, tile_w = _tiles(frame_height, frame_width, blk_dim, ty, tx)
    horizontal = _axis_strips(tx, tile_w, span, tile_h * dtype_bytes)
    vertical = _axis_strips(ty, tile_h, span,
                            (tile_w + 2 * span) * dtype_bytes)
    return horizontal, vertical


def halo_bytes_per_chip(
    frame_height: int,
    frame_width: int,
    span: int,
    ty: int,
    tx: int,
    *,
    blk_dim: int = 1,
    dtype_bytes: int = 1,
) -> int:
    """Bytes the busiest card SENDS during `halo_exchange_2d`, on the tiles
    of the frame padded for a (ty, tx) mesh at `blk_dim` (1: tiles of
    cdiv(H, ty) x cdiv(W, tx), the JAX module's)."""
    return sum(sum(map(sum, axis)) for axis in _strips(
        frame_height, frame_width, span, ty, tx, blk_dim, dtype_bytes))


def _hosts(ty: int, tx: int) -> tuple[int, int]:
    """Hosts along ("ty", "tx"): the orientation of the (HOST_TY, HOST_TX)
    board that takes the fewest hosts, then the fewest crossing axes."""
    if ty * tx <= CHIPS_PER_HOST:
        return 1, 1
    return min(
        (cdiv(ty, HOST_TY), cdiv(tx, HOST_TX)),
        (cdiv(ty, HOST_TX), cdiv(tx, HOST_TY)),
        key=lambda o: (o[0] * o[1], (o[0] > 1) + (o[1] > 1)),
    )


def _collective_latency_s(n_chips: int, n_hosts: int) -> float:
    """One latency-bound collective: a log2 tree over a host's cards, then
    over the hosts."""
    in_host = min(n_chips, CHIPS_PER_HOST)
    return (NVLINK_HOP_LATENCY_S * max(1, (in_host - 1).bit_length())
            + IB_LATENCY_S * (n_hosts - 1).bit_length())


def _slot_result_bytes(tile_h: int, tile_w: int, blk_dim: int, *,
                       with_comp: bool = True) -> int:
    """Bytes of one slot's results for one pair: three [tile_h/blk,
    tile_w/blk] grids and, with `with_comp`, the int32 compensated tile."""
    grid = (tile_h // blk_dim) * (tile_w // blk_dim)
    return _RESULT_BYTES * (_GRIDS * grid
                            + (tile_h * tile_w if with_comp else 0))


def _gather(frame_height, frame_width, blk_dim, ty, tx, *,
            with_comp: bool = True) -> tuple[int, float]:
    """(bytes each card receives, seconds) for `_assemble` of one pair's
    results on a (ty, tx) mesh, one rank a card."""
    n = ty * tx
    if n == 1:
        return 0, 0.0
    tile_h, tile_w = _tiles(frame_height, frame_width, blk_dim, ty, tx)
    slot = _slot_result_bytes(tile_h, tile_w, blk_dim, with_comp=with_comp)
    hosts_ty, hosts_tx = _hosts(ty, tx)
    n_hosts = hosts_ty * hosts_tx
    in_host = min(n, CHIPS_PER_HOST)
    collectives = (_GRIDS + with_comp) * n
    seconds = ((in_host - 1) * slot / NVLINK_BYTES_PER_S
               + (n - in_host) * slot / IB_BYTES_PER_S
               + collectives * _collective_latency_s(n, n_hosts))
    return (n - 1) * slot, seconds


def model_step(
    *,
    frame_height: int,
    frame_width: int,
    blk_dim: int,
    span: int,
    ty: int,
    tx: int,
    measured_mblocks_per_s: float,
    dtype_bytes: int = 1,
) -> ShardedStepModel:
    """Model one sharded frame-pair step on a ty*tx spatial mesh, one card a
    rank."""
    n_chips = ty * tx
    tile_h, tile_w = _tiles(frame_height, frame_width, blk_dim, ty, tx)
    nby, nbx = cdiv(frame_height, blk_dim), cdiv(frame_width, blk_dim)
    # The busiest card holds the first tile, whose blocks are in the frame.
    blocks = min(tile_h // blk_dim, nby) * min(tile_w // blk_dim, nbx)
    compute_s = blocks / (measured_mblocks_per_s * 1e6)

    horizontal, vertical = _strips(frame_height, frame_width, span, ty, tx,
                                   blk_dim, dtype_bytes)
    hosts_ty, hosts_tx = _hosts(ty, tx)
    n_hosts = hosts_ty * hosts_tx
    nv_bytes = ib_bytes = nv_hops = ib_hops = 0
    for (fwd, bwd), axis_hosts in ((horizontal, hosts_tx),
                                   (vertical, hosts_ty)):
        if axis_hosts > 1:
            # The boundary card's crossing direction rides InfiniBand.
            cross, inner = sorted((fwd, bwd), key=sum, reverse=True)
            ib_bytes += sum(cross)
            ib_hops += len(cross)
            nv_bytes += sum(inner)
            nv_hops += len(inner)
        else:
            nv_bytes += sum(fwd) + sum(bwd)
            nv_hops += len(fwd) + len(bwd)
    halo_s = (nv_bytes / NVLINK_BYTES_PER_S + ib_bytes / IB_BYTES_PER_S
              + nv_hops * NVLINK_HOP_LATENCY_S + ib_hops * IB_LATENCY_S)
    stats_s = (2 * _collective_latency_s(n_chips, n_hosts)
               if n_chips > 1 else 0.0)
    gather_bytes, gather_s = _gather(frame_height, frame_width, blk_dim,
                                     ty, tx)
    return ShardedStepModel(
        mesh_ty=ty,
        mesh_tx=tx,
        compute_s=compute_s,
        halo_bytes=nv_bytes + ib_bytes,
        halo_s=halo_s,
        stats_s=stats_s,
        gather_bytes=gather_bytes,
        gather_s=gather_s,
        crosses_hosts=n_hosts > 1,
    )


def gop_scaling_efficiency(
    *,
    frame_height: int,
    frame_width: int,
    blk_dim: int,
    span: int,
    n_hosts: list[int],
    measured_mblocks_per_s: float,
    host_mesh: tuple[int, int] = (2, 4),
    dtype_bytes: int = 1,
    host_ingest_mb_s: float | None = None,
) -> dict[int, float]:
    """Predicted 1 -> N **host** scaling efficiency of `run_gop_sharded`
    with pairs batched over hosts ("dp") and the `host_mesh` spatial tiling
    inside each host: no halo crosses hosts.

    What does cross hosts, per pair and host: the two stats all-reduces'
    inter-host steps (`sync`, 2 * IB_LATENCY_S * log2 tree, the JAX
    module's sync term), and `_assemble`'s broadcast of every other host's
    results to every card, N-1 hosts' slots over each card's InfiniBand
    port, one more inter-host tree step per collective.

    `host_ingest_mb_s` charges one new uint8 frame per pair per host at a
    measured host-to-card rate, overlapped with the step: the per-pair time
    is max(ingest, step + sync + gather across hosts). None models hosts
    whose ingest is faster than the step.

    Returns {n_hosts: efficiency}.
    """
    ty, tx = host_mesh
    base = model_step(
        frame_height=frame_height, frame_width=frame_width,
        blk_dim=blk_dim, span=span, ty=ty, tx=tx,
        measured_mblocks_per_s=measured_mblocks_per_s,
        dtype_bytes=dtype_bytes,
    )
    ingest_s = (
        frame_height * frame_width / (host_ingest_mb_s * 1e6)
        if host_ingest_mb_s
        else 0.0
    )
    tile_h, tile_w = _tiles(frame_height, frame_width, blk_dim, ty, tx)
    slot = _slot_result_bytes(tile_h, tile_w, blk_dim)
    out = {}
    for n in n_hosts:
        hops = max(0, n - 1).bit_length()
        sync = 2 * IB_LATENCY_S * hops
        cross_gather = ((n - 1) * ty * tx * slot / IB_BYTES_PER_S
                        + (_GRIDS + 1) * n * ty * tx * IB_LATENCY_S * hops)
        t1 = max(ingest_s, base.step_s)
        out[n] = t1 / max(ingest_s, base.step_s + sync + cross_gather)
    return out


def spatial_gop_overlap_efficiency(
    *,
    frame_height: int,
    frame_width: int,
    blk_dim: int,
    span: int,
    meshes: list[tuple[int, int]],
    measured_mblocks_per_s: float,
    dtype_bytes: int = 1,
) -> dict[int, float]:
    """Spatial-tiling efficiency of `sharded_gop_pipelined`'s schedule with
    the next pair's halo exchange hidden behind this pair's search:

        T_pair = max(compute, halo) + stats + gather

    where the gather holds the three result grids and no compensated frame
    (the pipelined step returns none). The port issues the next exchange
    before the search but waits for it there, so on the card the two do
    not overlap yet: this is the bound that schedule would reach. Returns
    {n_chips: efficiency} against the same one-card baseline as
    `scaling_efficiency`.
    """
    kw = dict(frame_height=frame_height, frame_width=frame_width,
              blk_dim=blk_dim, span=span,
              measured_mblocks_per_s=measured_mblocks_per_s,
              dtype_bytes=dtype_bytes)
    base = model_step(ty=1, tx=1, **kw)
    out = {}
    for ty, tx in meshes:
        m = model_step(ty=ty, tx=tx, **kw)
        _, gather_s = _gather(frame_height, frame_width, blk_dim, ty, tx,
                              with_comp=False)
        n = ty * tx
        t_pair = max(m.compute_s, m.halo_s) + m.stats_s + gather_s
        out[n] = base.step_s / (n * t_pair)
    return out


def scaling_efficiency(
    *,
    frame_height: int,
    frame_width: int,
    blk_dim: int,
    span: int,
    meshes: list[tuple[int, int]],
    measured_mblocks_per_s: float,
    dtype_bytes: int = 1,
) -> dict[int, float]:
    """Predicted efficiency T(1) / (N * T(N)) for each (ty, tx) mesh: one
    frame spread spatially over all N cards (past one host the halo and
    the gather cross InfiniBand). Returns {n_chips: efficiency}; 1.0 is
    linear scaling of frames/s with cards."""
    kw = dict(frame_height=frame_height, frame_width=frame_width,
              blk_dim=blk_dim, span=span,
              measured_mblocks_per_s=measured_mblocks_per_s,
              dtype_bytes=dtype_bytes)
    base = model_step(ty=1, tx=1, **kw)
    return {ty * tx: base.step_s / (ty * tx * model_step(ty=ty, tx=tx,
                                                         **kw).step_s)
            for ty, tx in meshes}
