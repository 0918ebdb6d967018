"""Halo exchange of reference-frame borders between mesh neighbours.

The port of `motionestimation_tpu.parallel.halo`. Each spatial shard
searches a +-span window around its blocks, so it needs `span` reference
pixels beyond every tile edge. Two sweeps, as the JAX package's two
`lax.ppermute` sweeps:

  1. along "tx": each tile widens to [h, w + 2*span];
  2. along "ty", on the widened tiles: corners arrive transitively, with no
     diagonal step.

When span exceeds a neighbour tile, hop k brings the k-th neighbour's
`min(size, span - (k-1)*size)` nearest rows or columns, so any span works.
A shard with no neighbour at a hop gets zeros, which is the zero padding
of the single-card path: the exchanged halo equals
`search.full_search.make_ref_halo`'s window of the tile, bit for bit, and
that is what keeps sharded == unsharded exact.

Slots of this process exchange by tensor copies (`.to(device)`; on a
one-card mesh, copies on that card). Slots of different ranks exchange
through `torch.distributed.batch_isend_irecv`: gloo with CPU tensors, NCCL
with CUDA tensors (`comm_device`). Every rank walks the same list of
transfers in the same order, so each send meets its receive.

`start_halo_exchange_2d` issues the whole exchange, both sweeps, before it
returns. Under NCCL it runs on a side stream of the card (the "ty" sweep's
strips wait there on the "tx" sweep's), so that work enqueued on the
current stream after it overlaps every transfer; its `wait()` makes the
current stream wait on the side stream. Under gloo the "tx" sweep is
finished on the host before the "ty" sweep is issued.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from motionestimation_tpu_torch.core import geometry
from motionestimation_tpu_torch.parallel.mesh import AXES, Mesh

# The torch.distributed calls this process has issued on the sharded path,
# by name: the halo's "batch_isend_irecv", the results' "gather" or
# "all_gather_into_tensor", the stats' "all_reduce". Read, and set to 0, by
# whoever counts them (chip_smoke.py, beside the kernels' launch counts).
COLLECTIVES: collections.Counter = collections.Counter()
# card -> the side stream its exchanges run on under NCCL.
_SIDE_STREAMS: dict = {}


def comm_device() -> torch.device:
    """Where tensors that cross ranks must lie: the current CUDA device
    under NCCL, the CPU otherwise (gloo)."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _halo_1d(tiles: dict, span: int, mesh: Mesh, axis: str):
    """Widen every local tile by `span` on both ends of its dimension for
    `axis` ("ty": rows, "tx": columns) with its neighbours' data. Issues
    the transfers and returns `finish()`, which waits on them and returns
    the widened tiles."""
    dim = -2 if axis == "ty" else -1
    pos = AXES.index(axis)
    n = mesh.shape[axis]
    ref = next(iter(tiles.values()), None)
    if ref is None:  # this rank owns no slot; it still joins no transfer
        return lambda: {}
    size = ref.shape[dim]
    hops = geometry.cdiv(span, size)

    def width(k):
        return min(size, span - (k - 1) * size)

    def take(t, start, stop):
        return t.narrow(dim, start, stop - start)

    # pieces[slot][("before"|"after", k)] -> tensor on the slot's device
    pieces = {s: {} for s in tiles}
    ops, recvs = [], []
    comm = None
    order = 0
    for dst in mesh.slots():
        for side, ks in (("before", range(hops, 0, -1)),
                         ("after", range(1, hops + 1))):
            for k in ks:
                wk = width(k)
                src = list(dst)
                src[pos] += -k if side == "before" else k
                src = tuple(src)
                local_dst = mesh.ranks[dst] == mesh.rank
                if not 0 <= src[pos] < n:
                    if local_dst:
                        shape = list(ref.shape)
                        shape[dim] = wk
                        pieces[dst][side, k] = torch.zeros(
                            shape, dtype=ref.dtype,
                            device=mesh.devices[dst])
                    continue
                local_src = mesh.ranks[src] == mesh.rank
                order += 1
                if not (local_src or local_dst):
                    continue
                if local_src:
                    t = tiles[src]
                    piece = (take(t, size - wk, size) if side == "before"
                             else take(t, 0, wk))
                    if local_dst:
                        pieces[dst][side, k] = piece.to(mesh.devices[dst])
                        continue
                    comm = comm or comm_device()
                    ops.append(dist.P2POp(
                        dist.isend, piece.contiguous().to(comm),
                        int(mesh.ranks[dst]), tag=order))
                else:
                    comm = comm or comm_device()
                    shape = list(ref.shape)
                    shape[dim] = wk
                    buf = torch.empty(shape, dtype=ref.dtype, device=comm)
                    ops.append(dist.P2POp(dist.irecv, buf,
                                          int(mesh.ranks[src]), tag=order))
                    recvs.append((dst, (side, k), buf))
    if ops:
        COLLECTIVES["batch_isend_irecv"] += 1
    reqs = dist.batch_isend_irecv(ops) if ops else []

    def finish() -> dict:
        for req in reqs:
            req.wait()
        ops.clear()  # the send buffers lived until here
        for dst, key, buf in recvs:
            pieces[dst][key] = buf.to(mesh.devices[dst])
        out = {}
        for s, t in tiles.items():
            before = [pieces[s]["before", k] for k in range(hops, 0, -1)]
            after = [pieces[s]["after", k] for k in range(1, hops + 1)]
            out[s] = torch.cat(before + [t] + after, dim=dim)
        return out

    return finish


def _side_stream(tiles: dict):
    """The side stream of NCCL's card when every tile lies on that card,
    else None (gloo, or no process group: the exchange runs where the
    caller's work does)."""
    if not (dist.is_initialized() and dist.get_backend() == "nccl"):
        return None
    comm = comm_device()
    if not tiles or any(t.device != comm for t in tiles.values()):
        return None
    if comm not in _SIDE_STREAMS:
        _SIDE_STREAMS[comm] = torch.cuda.Stream(comm)
    return _SIDE_STREAMS[comm]


def start_halo_exchange_2d(tiles: dict, span: int, mesh: Mesh, *,
                           ready=None):
    """`halo_exchange_2d` issued now and waited on later: when the call
    returns, every transfer of both sweeps has been issued (module
    docstring); the returned `wait()` completes them and returns the
    halos, ready on the caller's current stream. Every rank of the mesh
    calls both together and issues no other transfer between them.

    `ready`: a CUDA event after which the tiles may be read. On the side
    stream the exchange waits on it, or by default on all the work queued
    on the current stream so far."""
    if span == 0:
        return lambda: dict(tiles)
    side = _side_stream(tiles)
    if side is None:
        return _halo_1d(_halo_1d(tiles, span, mesh, "tx")(), span, mesh,
                        "ty")
    if ready is None:
        side.wait_stream(torch.cuda.current_stream(side.device))
    else:
        side.wait_event(ready)
    for t in tiles.values():
        t.record_stream(side)  # read there; the caller may drop it
    with torch.cuda.stream(side):
        finish = _halo_1d(_halo_1d(tiles, span, mesh, "tx")(), span, mesh,
                          "ty")

    def wait() -> dict:
        with torch.cuda.stream(side):
            out = finish()
        current = torch.cuda.current_stream(side.device)
        current.wait_stream(side)
        for t in out.values():
            t.record_stream(current)  # made on the side stream
        return out

    return wait


def halo_exchange_2d(tiles: dict, span: int, mesh: Mesh) -> dict:
    """Widen each local [..., h, w] tile (`tiles`: slot (d, iy, ix) ->
    tensor on the slot's device, every one of the same shape) to [..., h +
    2*span, w + 2*span] with its neighbours' data, zeros beyond the frame:
    the port of `halo_exchange_2d` (halo.py:81). Every rank of the mesh
    calls it together. Any span works, halos wider than a tile included
    (multi-hop)."""
    return start_halo_exchange_2d(tiles, span, mesh)()
