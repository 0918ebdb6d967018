"""Motion estimation over a ("dp", "ty", "tx") mesh.

The port of `motionestimation_tpu.parallel.sharded`. The JAX package runs
one SPMD program under `shard_map`; here every process walks its own slots
of the mesh, and the exchanges between slots are `parallel.halo`'s. The
step for each slot's tile: the reference halo from the neighbours, the
search on the tile at its global origin, compensation from the halo, and
the exact residual statistics of its true frame pixels, reduced over the
mesh.

Backends:

* "cuda": the tile entries of the ported kernels
  (`full_search_cuda.full_search_tile_cuda`,
  `ssim_cuda.ssim_search_tile_cuda`, and for diamond the tile volume
  entries). They search the frame's truncated last block row and column
  inside the tile that holds them (the int and truncated-extent SSIM
  kernels), where the JAX package repairs them with a golden slab pass
  after the mesh step. On CPU tensors the entries run their kernels' plain
  versions.
* "golden": the plain tile search (`search.full_search.full_search_tile`,
  or the golden tile volume for diamond), only when the caller asks.
* "auto": "cuda" on a CUDA mesh, for every config; "golden" on a CPU mesh.

The steps leave their results on the slots that computed them, as the
JAX step's `shard_map` outputs stay sharded (sharded.py:222, :451);
`gather` assembles them, in one collective, on the rank or ranks that read
them. Only the stats are reduced inside a step (two all-reduces, the JAX
`psum` and `pmax`).

The JAX package carries the sum of squared errors as two int32 halves, a
TPU workaround; here it is one int64 per batch entry.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from motionestimation_tpu_torch.core import geometry
from motionestimation_tpu_torch.core.device import resolve_device, to_tensor
from motionestimation_tpu_torch.kernels import full_search_cuda as fsc
from motionestimation_tpu_torch.kernels import ssim_cuda as sc
from motionestimation_tpu_torch.parallel import halo as halo_lib
from motionestimation_tpu_torch.parallel import ingest
from motionestimation_tpu_torch.parallel.mesh import Mesh
from motionestimation_tpu_torch.search import diamond
from motionestimation_tpu_torch.search import full_search as fs

BACKENDS = ("auto", "cuda", "golden")


class ShardedStepResult(NamedTuple):
    """The results of one step for a batch of frame pairs as `gather`
    assembles them on a receiving rank, every tensor on that process's
    first slot's device (ranks that `gather` does not send to receive
    none).

    mv_y / mv_x: [B, nby_p, nbx_p] int32 on the mesh-padded block grid
      (only [:, :nby, :nbx] is contract);
    best_cost:   [B, nby_p, nbx_p] int32 SSD/SAD, or float32 SSIM score;
    comp:        [B, Hp, Wp] int32 motion-compensated frames (None where
      the caller asked for no compensated frame);
    sum_sq:      [B] int64 Σerr² over the true frame pixels;
    frame_max:   [B] int32 max(comp, cur) over them, so that
      `frames.psnr_from_stats(sum_sq, H*W, frame_max)` equals
      `image_psnr(comp, cur)` bit for bit.
    """

    mv_y: torch.Tensor
    mv_x: torch.Tensor
    best_cost: torch.Tensor
    comp: torch.Tensor
    sum_sq: torch.Tensor
    frame_max: torch.Tensor


class SlotResults(NamedTuple):
    """A step's results where they were computed, before any gather.

    mesh:       the mesh the step ran on;
    tiles:      this process's slot (d, iy, ix) -> its [B/dp, nby_p/ty,
      nbx_p/tx] mv_y, mv_x and cost tiles and, where `frame` is set, its
      [B/dp, Hp/ty, Wp/tx] int32 compensated tile, on the slot's device;
    grid:       (B, nby_p, nbx_p);
    frame:      (B, Hp, Wp) where the step kept the compensated frame, else
      None;
    cost_dtype: torch.int32 (SSD/SAD) or torch.float32 (SSIM score);
    sum_sq, frame_max: the stats, already reduced over the mesh, on this
      process's first slot's device (every rank holds them).
    """

    mesh: Mesh
    tiles: dict
    grid: tuple
    frame: tuple | None
    cost_dtype: torch.dtype
    sum_sq: torch.Tensor
    frame_max: torch.Tensor


def padded_dims_for_mesh(frame_height: int, frame_width: int, blk_dim: int,
                         mesh: Mesh) -> tuple[int, int]:
    """Frame dims padded so every ("ty", "tx") slot holds whole blocks (the
    port of `padded_dims_for_mesh`, sharded.py:64)."""
    ty, tx = mesh.shape["ty"], mesh.shape["tx"]
    hp = geometry.cdiv(frame_height, blk_dim * ty) * blk_dim * ty
    wp = geometry.cdiv(frame_width, blk_dim * tx) * blk_dim * tx
    return hp, wp


def _resolve_backend(backend: str, mesh: Mesh) -> str:
    """"cuda" or "golden" for `backend` on `mesh` (the port of
    `_resolve_backend`, sharded.py:86): "auto" takes the kernels on a CUDA
    mesh, whatever the config (their routes cover every block size and
    span), and the plain tile search on a CPU mesh. A CUDA mesh on a
    machine without CUDA raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown sharded backend {backend!r}")
    platform = mesh.platform
    if platform == "cuda":
        resolve_device("cuda")
    if backend == "auto":
        return "cuda" if platform == "cuda" else "golden"
    return backend


def _home(mesh: Mesh) -> torch.device:
    """Where this process assembles results: its first slot's device."""
    local = mesh.local_slots()
    return mesh.devices[local[0]] if local else halo_lib.comm_device()


def _as_shards(batch, mesh: Mesh, hp: int, wp: int) -> ingest.FrameShards:
    """`batch` on the mesh: `FrameShards` as they are; else a global [B, H,
    W] (or already padded [B, Hp, Wp]) batch, numpy or a tensor on any
    device, zero-padded to (Hp, Wp) where it lies, of which this process
    scatters its own rows."""
    if isinstance(batch, ingest.FrameShards):
        if tuple(batch.shape[1:]) != (hp, wp):
            raise ValueError(f"frame shards of {batch.shape}, expected "
                             f"padded dims {(hp, wp)}")
        return batch
    t = fsc.as_u8(to_tensor(batch))
    if t.dim() != 3:
        raise ValueError(f"expected a [B, H, W] batch, got {tuple(t.shape)}")
    t = F.pad(t, (0, wp - t.shape[2], 0, hp - t.shape[1]))
    lo, hi = ingest.local_row_range(mesh, hp)
    return ingest.put_frame_batch(t[:, lo:hi], mesh)


def _search_tile(cur_t, halo, y0, x0, *, backend, algorithm, blk_dim, span,
                 metric, frame_height, frame_width, early_term):
    """(mv_y, mv_x, cost) of one 2-D tile against its halo."""
    kw = dict(frame_height=frame_height, frame_width=frame_width,
              blk_dim=blk_dim, span=span)
    if algorithm == "diamond":
        return diamond.diamond_search_tile(
            cur_t, halo, y0, x0, metric=metric, early_term=early_term,
            use_kernels=backend == "cuda", **kw)
    if backend == "golden":
        field = fs.full_search_tile(cur_t, halo, y0, x0, metric=metric, **kw)
        cost = field.score if metric == "ssim" else field.best_cost_i32
        return field.mv_y, field.mv_x, cost
    if metric == "ssim":
        cost, idx = sc.ssim_search_tile_cuda(cur_t, halo, y0, x0, **kw)
    else:
        cost, idx = fsc.full_search_tile_cuda(cur_t, halo, y0, x0,
                                              metric=metric, **kw)
    return (*geometry.mv_from_flat_index(idx, span), cost)


def _tile_stats(comp, cur_t, y0, x0, frame_height, frame_width):
    """(Σerr² int64, max(comp, cur) int32) over the tile's true frame
    pixels; (0, 0) for a tile wholly in the padding."""
    h_in = max(0, min(cur_t.shape[0], frame_height - y0))
    w_in = max(0, min(cur_t.shape[1], frame_width - x0))
    c = comp[:h_in, :w_in]
    u = cur_t[:h_in, :w_in].to(torch.int32)
    if not c.numel():
        zero = torch.zeros((), dtype=torch.int64, device=comp.device)
        return zero, zero.to(torch.int32)
    err = c - u
    return (torch.sum(err * err, dtype=torch.int64),
            torch.maximum(c, u).max())


def _step_slot(cur_tiles, halo_tiles, y0, x0, **kw):
    """Search, compensate and count each 2-D pair of a slot's tiles; the
    per-kind outputs stacked along the batch: (mv_y, mv_x, cost, comp,
    sum_sq, fmax)."""
    outs = []
    for cur_t, halo in zip(cur_tiles, halo_tiles):
        mv_y, mv_x, cost = _search_tile(cur_t, halo, y0, x0, **kw)
        comp = fs.compensate_tile(halo, mv_y, mv_x, blk_dim=kw["blk_dim"],
                                  span=kw["span"]).to(torch.int32)
        outs.append((mv_y, mv_x, cost, comp, *_tile_stats(
            comp, cur_t, y0, x0, kw["frame_height"], kw["frame_width"])))
    return [torch.stack(kind) for kind in zip(*outs)]


def _kinds(results: SlotResults):
    """(global shape, dtype) of each kind of result tile, in tile order."""
    grid = results.grid
    kinds = [(grid, torch.int32), (grid, torch.int32),
             (grid, results.cost_dtype)]
    if results.frame is not None:
        kinds.append((results.frame, torch.int32))
    return kinds


def _tile_shape(shape, mesh: Mesh):
    return (shape[0] // mesh.shape["dp"], shape[1] // mesh.shape["ty"],
            shape[2] // mesh.shape["tx"])


def _place(out: torch.Tensor, slot, tile: torch.Tensor, mesh: Mesh):
    """Copy `slot`'s tile into its place in the global `out`."""
    d, iy, ix = slot
    bl, a, b = _tile_shape(out.shape, mesh)
    out[d * bl : (d + 1) * bl, iy * a : (iy + 1) * a,
        ix * b : (ix + 1) * b] = tile


def gather(results: SlotResults, dst: int | None = None):
    """A step's results assembled where they are read: the counterpart of
    the JAX caller's `fetch` (`process_allgather`, runner.py:670).

    Returns a ShardedStepResult on rank `dst`, or on every rank when `dst`
    is None, and None on the ranks it does not send to. Under a process
    group it is one collective for every result of every slot: each rank
    packs its slots' tiles (the compensated ones too where the step kept
    them) into one int32 buffer, the SSIM score as its bits, padded to the
    largest rank's share; `dist.gather` sends the buffers to `dst` (the
    other ranks receive no result bytes) and `dist.all_gather_into_tensor`
    to every rank. Outside a process group every slot is this process's,
    and the gather is a local copy. Every rank of the mesh calls it
    together.
    """
    mesh = results.mesh
    home = _home(mesh)
    kinds = _kinds(results)

    def empty_outs():
        return [torch.empty(shape, dtype=dtype, device=home)
                for shape, dtype in kinds]

    if not dist.is_initialized():
        outs = empty_outs()
        for slot, tiles in results.tiles.items():
            for out, tile in zip(outs, tiles):
                _place(out, slot, tile.to(home), mesh)
        return _result(outs, results.sum_sq, results.frame_max)
    world = dist.get_world_size()
    tile_shapes = [_tile_shape(shape, mesh) for shape, _ in kinds]
    sizes = [math.prod(t) for t in tile_shapes]
    slot_words = sum(sizes)
    per_rank = int(max(np.bincount(mesh.ranks.ravel(), minlength=world)))
    comm = halo_lib.comm_device()
    send = torch.empty((per_rank, slot_words), dtype=torch.int32,
                       device=comm)
    for k, slot in enumerate(mesh.local_slots()):
        for piece, tile, t_shape, (_, dtype) in zip(
                send[k].split(sizes), results.tiles[slot], tile_shapes,
                kinds):
            piece.view(dtype).view(t_shape).copy_(tile)
    halo_lib.COLLECTIVES["gather" if dst is not None
                         else "all_gather_into_tensor"] += 1
    if dst is None:
        recv = torch.empty((world, per_rank, slot_words), dtype=torch.int32,
                           device=comm)
        dist.all_gather_into_tensor(recv.view(-1), send.view(-1))
    else:
        recv = (torch.empty((world, per_rank, slot_words),
                            dtype=torch.int32, device=comm)
                if mesh.rank == dst else None)
        dist.gather(send, None if recv is None else list(recv.unbind(0)),
                    dst=dst)
        if recv is None:
            return None
    outs = empty_outs()
    taken = {}
    for slot in mesh.slots():  # a rank's k-th slot in mesh order: share k
        r = int(mesh.ranks[slot])
        k = taken[r] = taken.get(r, -1) + 1
        for out, piece, t_shape, (_, dtype) in zip(
                outs, recv[r, k].split(sizes), tile_shapes, kinds):
            _place(out, slot, piece.view(dtype).view(t_shape), mesh)
    return _result(outs, results.sum_sq.to(home), results.frame_max.to(home))


def _result(outs, sum_sq, frame_max) -> ShardedStepResult:
    mv_y, mv_x, cost, *comp = outs
    return ShardedStepResult(mv_y, mv_x, cost, comp[0] if comp else None,
                             sum_sq, frame_max)


def _reduce_stats(local_sq: dict, local_max: dict, mesh: Mesh, batch: int,
                  home):
    """[B] int64 Σerr² and [B] int32 max over every slot: summed and maxed
    over this process's slots, then over the ranks (all_reduce)."""
    bl = batch // mesh.shape["dp"]
    sq = torch.zeros(batch, dtype=torch.int64, device=home)
    fmax = torch.zeros(batch, dtype=torch.int32, device=home)
    for (d, _, _), s in local_sq.items():
        sq[d * bl : (d + 1) * bl] += s.to(home)
    for (d, _, _), m in local_max.items():
        part = fmax[d * bl : (d + 1) * bl]
        torch.maximum(part, m.to(home), out=part)
    if dist.is_initialized():
        comm = halo_lib.comm_device()
        sq_c, max_c = sq.to(comm), fmax.to(comm)
        halo_lib.COLLECTIVES["all_reduce"] += 2
        dist.all_reduce(sq_c, op=dist.ReduceOp.SUM)
        dist.all_reduce(max_c, op=dist.ReduceOp.MAX)
        sq, fmax = sq_c.to(home), max_c.to(home)
    return sq, fmax


def sharded_motion_step(cur_batch, ref_batch, *, mesh: Mesh, blk_dim: int,
                        span: int, metric: str = "mse", frame_height: int,
                        frame_width: int, backend: str = "auto",
                        algorithm: str = "full",
                        early_term: float | None = None,
                        with_comp: bool = True) -> ShardedStepResult:
    """One full motion-estimation step for a batch of frame pairs (the
    port of `sharded_motion_step`, sharded.py:109).

    cur_batch / ref_batch: [B, H, W] integer frames (numpy or torch; B
    divisible by the mesh's "dp"), or `FrameShards` from
    `ingest.put_frame_batch` of the mesh-padded batch. Every rank of the
    mesh calls it together.

    algorithm: "full" (exhaustive) or "diamond" (per-tile staged diamond,
    `search.diamond.diamond_search_tile`, with `early_term`; its
    candidates reach at most +-span, so the same halo serves). backend:
    "auto", "cuda" or "golden" (module docstring). Returns the
    `SlotResults`, left on their slots and the stats reduced over the mesh;
    `gather` assembles a ShardedStepResult, and sharded == unsharded holds
    exactly. Without `with_comp`, each slot still compensates its tile for
    the stats but keeps no compensated tile, and a gather's `comp` is None.
    """
    if algorithm not in ("full", "diamond"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if metric not in ("mse", "sad", "ssim"):
        raise ValueError(f"unknown metric {metric!r}")
    backend = _resolve_backend(backend, mesh)
    hp, wp = padded_dims_for_mesh(frame_height, frame_width, blk_dim, mesh)
    cur = _as_shards(cur_batch, mesh, hp, wp)
    ref = _as_shards(ref_batch, mesh, hp, wp)
    if cur.shape != ref.shape:
        raise ValueError(f"current batch {cur.shape} vs reference batch "
                         f"{ref.shape}")
    batch = cur.shape[0]
    tile_h, tile_w = hp // mesh.shape["ty"], wp // mesh.shape["tx"]
    halos = halo_lib.halo_exchange_2d(ref.tiles, span, mesh)
    kw = dict(backend=backend, algorithm=algorithm, blk_dim=blk_dim,
              span=span, metric=metric, frame_height=frame_height,
              frame_width=frame_width, early_term=early_term)
    parts = {slot: _step_slot(cur.tiles[slot], halos[slot], slot[1] * tile_h,
                              slot[2] * tile_w, **kw)
             for slot in mesh.local_slots()}
    sq, fmax = _reduce_stats({s: p[4] for s, p in parts.items()},
                             {s: p[5] for s, p in parts.items()}, mesh,
                             batch, _home(mesh))
    return SlotResults(
        mesh, {s: p[:4] if with_comp else p[:3] for s, p in parts.items()},
        (batch, hp // blk_dim, wp // blk_dim),
        (batch, hp, wp) if with_comp else None,
        torch.float32 if metric == "ssim" else torch.int32, sq, fmax)


def sharded_gop_pipelined(frames, *, mesh: Mesh, blk_dim: int, span: int,
                          metric: str = "mse", frame_height: int,
                          frame_width: int, backend: str = "auto",
                          phase=None) -> SlotResults:
    """Full search over the consecutive pairs of a [P+1, H, W] frame stack
    on a spatial mesh (dp = 1), carrying the exchanged halo (the port of
    `sharded_gop_pipelined`, sharded.py:318): step i searches pair
    (frames[i+1], frames[i]) against the carried halo of frames[i], and
    frames[i+1]'s halo, whose exchange is issued whole before that search
    (`halo.start_halo_exchange_2d`), is carried to step i+1. Each frame's
    halo is exchanged once, where per-pair steps exchange every reference
    anew, and under NCCL its transfers overlap the search.

    frames: [P+1, H, W] integer frames, or `FrameShards` of the padded
    stack (dp = 1: every slot holds every frame's tile). Returns the
    `SlotResults` of the P pairs without compensated tiles; `gather` gives
    what `sharded_motion_step` gives per pair. `phase(name)`, a context
    manager factory, is entered around each part of the schedule ("halo"
    for the first frame's exchange, then per pair "halo issue", "search"
    and "halo wait", and "stats" once), for timing.
    """
    if mesh.shape["dp"] != 1:
        raise ValueError(
            "sharded_gop_pipelined runs on dp = 1 meshes (the JAX program "
            "replicates the stack over 'dp'; per-pair steps batch over it)")
    if metric not in ("mse", "sad", "ssim"):
        raise ValueError(f"unknown metric {metric!r}")
    backend = _resolve_backend(backend, mesh)
    hp, wp = padded_dims_for_mesh(frame_height, frame_width, blk_dim, mesh)
    stack = _as_shards(frames, mesh, hp, wp)
    pairs = stack.shape[0] - 1
    if pairs < 1:
        raise ValueError("a stack of pairs needs at least two frames")
    tile_h, tile_w = hp // mesh.shape["ty"], wp // mesh.shape["tx"]
    kw = dict(backend=backend, algorithm="full", blk_dim=blk_dim, span=span,
              metric=metric, frame_height=frame_height,
              frame_width=frame_width, early_term=None)
    phase = phase or (lambda name: contextlib.nullcontext())
    local = mesh.local_slots()
    outs = {slot: [] for slot in local}

    # Every frame's tiles can be read once the work queued so far is done,
    # so an exchange need not wait for the searches queued after this.
    ready = None
    if any(t.is_cuda for t in stack.tiles.values()):
        ready = torch.cuda.Event()
        ready.record()

    def exchange(i):
        return halo_lib.start_halo_exchange_2d(
            {s: t[i] for s, t in stack.tiles.items()}, span, mesh,
            ready=ready)

    with phase("halo"):
        carried = exchange(0)()
    for i in range(1, pairs + 1):
        # The next pair's reference halo does not depend on this pair's
        # search: every transfer of its exchange is issued before the
        # search, and waited on before the next pair's.
        with phase("halo issue"):
            nxt = exchange(i)
        with phase("search"):
            for slot in local:
                outs[slot].append(_step_slot(
                    stack.tiles[slot][i : i + 1], [carried[slot]],
                    slot[1] * tile_h, slot[2] * tile_w, **kw))
        with phase("halo wait"):
            carried = nxt()
    parts = {s: [torch.cat(kind) for kind in zip(*o)]
             for s, o in outs.items()}
    with phase("stats"):
        sq, fmax = _reduce_stats({s: p[4] for s, p in parts.items()},
                                 {s: p[5] for s, p in parts.items()}, mesh,
                                 pairs, _home(mesh))
    return SlotResults(mesh, {s: p[:3] for s, p in parts.items()},
                       (pairs, hp // blk_dim, wp // blk_dim), None,
                       torch.float32 if metric == "ssim" else torch.int32,
                       sq, fmax)


def sharded_full_search(cur, ref, *, mesh: Mesh, blk_dim: int, span: int,
                        metric: str = "mse", backend: str = "auto",
                        algorithm: str = "full",
                        early_term: float | None = None):
    """One frame pair (a batch of 1) on the mesh (the port of
    `sharded_full_search`, sharded.py:456): (mv_y, mv_x, cost, comp)
    cropped to the frame's block grid and pixels, gathered to every rank."""
    frame_height, frame_width = cur.shape
    res = gather(sharded_motion_step(
        to_tensor(cur)[None], to_tensor(ref)[None], mesh=mesh,
        blk_dim=blk_dim, span=span, metric=metric,
        frame_height=frame_height, frame_width=frame_width, backend=backend,
        algorithm=algorithm, early_term=early_term))
    nby, nbx = geometry.grid_shape(frame_height, frame_width, blk_dim)
    return (res.mv_y[0, :nby, :nbx], res.mv_x[0, :nby, :nbx],
            res.best_cost[0, :nby, :nbx],
            res.comp[0, :frame_height, :frame_width])
