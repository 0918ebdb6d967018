"""Frame ingest onto a mesh, for one process or several.

The port of `motionestimation_tpu.parallel.ingest`:

* `distributed_init` joins a `torch.distributed` process group (NCCL where
  CUDA is available, gloo otherwise), the counterpart of
  `jax.distributed.initialize`;
* `put_frame_batch` scatters a [B, Hp, Wp] batch to the slots' devices,
  each slot receiving only its tile (`FrameShards`); under several
  processes the batch holds this process's rows (`local_row_range`), so
  each process reads only those from disk (`core.frames.load_yuv_rows`);
* `ShardedPrefetcher` stages the next batch while the current one
  computes, as `pipeline.runner.run_gop` stages frames: pinned host
  buffers, a copy stream per card, an event after each batch's copies,
  and a buffer back in the pool only once its event has completed.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch
import torch.distributed as dist

from motionestimation_tpu_torch.core.device import to_tensor
from motionestimation_tpu_torch.kernels.full_search_cuda import as_u8
from motionestimation_tpu_torch.parallel.mesh import Mesh, process_group


class FrameShards(NamedTuple):
    """A [B, Hp, Wp] frame batch on a mesh: `tiles` maps each of this
    process's slots (d, iy, ix) to its uint8 tile [B / dp, Hp / ty, Wp /
    tx] on the slot's device (batch entries d*B/dp onwards)."""

    shape: tuple[int, int, int]
    tiles: dict


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str | None = None) -> None:
    """Join a process group of `num_processes` at `coordinator_address`
    ("host:port"; the port of `distributed_init`, ingest.py:27). Does
    nothing when `num_processes` is None (one process, no group) or a group
    exists. `backend` defaults to "nccl" where CUDA is available, with this
    process on card `process_id % device_count`, else "gloo". A group of
    one runs the collective path on one card."""
    if num_processes is None or dist.is_initialized():
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a process group needs coordinator_address and "
                         "process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _local_ty(mesh: Mesh) -> tuple[int, int]:
    """[first, last + 1) of the "ty" indices of this process's slots."""
    iys = [iy for _, iy, _ in mesh.local_slots()]
    if not iys:
        raise ValueError(f"rank {mesh.rank} owns no slot of {mesh}")
    return min(iys), max(iys) + 1


def local_row_range(mesh: Mesh, frame_rows: int) -> tuple[int, int]:
    """[start, end) of the padded frame rows this process provides (the
    port of `local_row_range`, ingest.py:62): the rows of its "ty" slots
    under several processes, (0, frame_rows) on one."""
    if process_group()[1] == 1:
        return 0, frame_rows
    tile_h = frame_rows // mesh.shape["ty"]
    lo, hi = _local_ty(mesh)
    return lo * tile_h, hi * tile_h


def _tile_views(t: torch.Tensor, mesh: Mesh):
    """(slot, view of `t` that is its tile) for this process's slots; `t`
    is [B, rows, Wp] holding every batch entry and this process's rows."""
    b, rows, wp = t.shape
    dp, tx = mesh.shape["dp"], mesh.shape["tx"]
    lo, hi = _local_ty(mesh)
    if b % dp or rows % (hi - lo) or wp % tx:
        raise ValueError(f"batch {tuple(t.shape)} does not split over "
                         f"{mesh.shape} (local tile rows {lo}..{hi - 1})")
    bl, th, tw = b // dp, rows // (hi - lo), wp // tx
    for d, iy, ix in mesh.local_slots():
        r0 = (iy - lo) * th
        yield (d, iy, ix), t[d * bl : (d + 1) * bl, r0 : r0 + th,
                             ix * tw : (ix + 1) * tw]


def _global_shape(t: torch.Tensor, mesh: Mesh) -> tuple[int, int, int]:
    lo, hi = _local_ty(mesh)
    return (t.shape[0], t.shape[1] // (hi - lo) * mesh.shape["ty"],
            t.shape[2])


def put_frame_batch(batch, mesh: Mesh) -> FrameShards:
    """Scatter a [B, Hp, Wp] batch (dims padded for the mesh,
    `sharded.padded_dims_for_mesh`; pixels in [0, 255]) to the slots'
    devices: the port of `put_frame_batch` (ingest.py:47). Under several
    processes `batch` holds every batch entry and this process's rows
    (`local_row_range`), as `make_array_from_process_local_data` takes
    them. Each tile is a copy on its slot's device."""
    t = as_u8(to_tensor(batch))
    if t.dim() != 3:
        raise ValueError(f"expected a [B, H, W] batch, got {tuple(t.shape)}")
    tiles = {slot: view.to(mesh.devices[slot], copy=True)
             for slot, view in _tile_views(t, mesh)}
    return FrameShards(_global_shape(t, mesh), tiles)


class ShardedPrefetcher:
    """Double-buffered ingest over a GOP (the port of `ShardedPrefetcher`,
    ingest.py:85).

    Wraps an iterator of host [B, rows, Wp] batches (as `put_frame_batch`
    takes them) and yields `FrameShards`, staging up to `depth` batches
    ahead. On a CUDA mesh each batch is copied into a pinned buffer of a
    pool and from there to every slot's card on a copy stream (once per
    card, the rows of its slots), with an event after the copies;
    `__next__` makes each card's current stream wait on its event, and a
    buffer goes back to the pool only once its events have completed. On
    a CPU mesh a batch is scattered as `put_frame_batch` scatters it.
    """

    def __init__(self, host_batches, mesh: Mesh, depth: int = 2):
        self._it = iter(host_batches)
        self._mesh = mesh
        self._depth = max(1, depth)
        self._queue = collections.deque()  # (FrameShards, events, buffer)
        self._on_card = mesh.platform == "cuda"
        cards = {mesh.devices[s] for s in mesh.local_slots()}
        self._streams = ({d: torch.cuda.Stream(d) for d in cards}
                         if self._on_card else {})
        self._free: list[torch.Tensor] = []
        self._in_flight = collections.deque()  # (events, buffer)
        self._fill()

    def _buffer(self, shape) -> torch.Tensor:
        """A free pinned buffer of `shape`, recycling those whose copies
        have completed (waiting for the oldest when none has)."""
        while self._in_flight and (
                not self._free or all(e.query() for e in self._in_flight[0][0])):
            events, buf = self._in_flight.popleft()
            for e in events:
                e.synchronize()
            self._free.append(buf)
        for i, buf in enumerate(self._free):
            if tuple(buf.shape) == tuple(shape):
                return self._free.pop(i)
        return torch.empty(shape, dtype=torch.uint8, pin_memory=True)

    def _stage(self, batch):
        if not self._on_card:
            return put_frame_batch(batch, self._mesh), (), None
        mesh = self._mesh
        host = as_u8(to_tensor(batch))
        buf = self._buffer(host.shape)
        buf.copy_(host)
        views = dict(_tile_views(buf, mesh))
        bl, th, tw = next(iter(views.values())).shape
        lo = _local_ty(mesh)[0]
        # One full-width band a card and batch range, over the rows of its
        # slots, copied one batch entry at a time (a contiguous run of the
        # pinned buffer, so each copy is asynchronous); tiles are its views.
        rows = {}
        for slot in views:
            d, iy, _ = slot
            a, z = rows.get((mesh.devices[slot], d), (iy, iy + 1))
            rows[mesh.devices[slot], d] = (min(a, iy), max(z, iy + 1))
        bands = {}
        for (dev, d), (a, z) in rows.items():
            r0, r1 = (a - lo) * th, (z - lo) * th
            with torch.cuda.stream(self._streams[dev]):
                band = torch.empty((bl, r1 - r0, buf.shape[2]),
                                   dtype=torch.uint8, device=dev)
                for j in range(bl):
                    band[j].copy_(buf[d * bl + j, r0:r1], non_blocking=True)
            bands[dev, d] = band, a
        tiles = {}
        for slot in views:
            d, iy, ix = slot
            band, a = bands[mesh.devices[slot], d]
            r = (iy - a) * th
            tiles[slot] = band[:, r : r + th, ix * tw : (ix + 1) * tw]
        events = []
        for dev, stream in self._streams.items():
            done = torch.cuda.Event()
            done.record(stream)
            events.append((dev, done))
        return (FrameShards(_global_shape(host, mesh), tiles), events, buf)

    def _fill(self):
        while len(self._queue) < self._depth:
            try:
                batch = next(self._it)
            except StopIteration:
                return
            self._queue.append(self._stage(batch))

    def __iter__(self):
        return self

    def __next__(self) -> FrameShards:
        if not self._queue:
            raise StopIteration
        shards, events, buf = self._queue.popleft()
        for dev, done in events:
            torch.cuda.current_stream(dev).wait_event(done)
        for slot, t in shards.tiles.items():
            # Made on a copy stream: its memory may be reused only after
            # the consuming stream's last use.
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))
        if buf is not None:
            self._in_flight.append(([e for _, e in events], buf))
        self._fill()
        return shards
