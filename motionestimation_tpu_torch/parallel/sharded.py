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

The JAX package carries the sum of squared errors as two int32 halves, a
TPU workaround; here it is one int64 per batch entry.
"""
from __future__ import annotations

from typing import NamedTuple

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
    """The results of one step for a batch of frame pairs, every tensor on
    this process's first slot's device (every rank receives all of them).

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


def _assemble(local: dict, mesh: Mesh, shape, dtype, home):
    """The global [B, ty*a, tx*b] tensor on `home` from each slot's [B/dp,
    a, b] tile (`local`: this process's slots), every rank receiving the
    tiles of the others by a broadcast from their owner."""
    out = torch.empty(shape, dtype=dtype, device=home)
    bl = shape[0] // mesh.shape["dp"]
    a, b = shape[1] // mesh.shape["ty"], shape[2] // mesh.shape["tx"]
    multi = dist.is_initialized()
    comm = halo_lib.comm_device() if multi else None
    for slot in mesh.slots():
        d, iy, ix = slot
        tile = local.get(slot)  # every slot's, outside a process group
        if multi:
            buf = (tile.to(comm).contiguous() if tile is not None else
                   torch.empty((bl, a, b), dtype=dtype, device=comm))
            dist.broadcast(buf, src=int(mesh.ranks[slot]))
            tile = buf
        out[d * bl : (d + 1) * bl, iy * a : (iy + 1) * a,
            ix * b : (ix + 1) * b] = tile.to(home)
    return out


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
    "auto", "cuda" or "golden" (module docstring). Returns a
    ShardedStepResult; sharded == unsharded holds exactly. Without
    `with_comp`, each slot still compensates its tile for the stats but
    the compensated frame is not gathered, and `comp` is None.
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
    home = _home(mesh)
    grid = (batch, hp // blk_dim, wp // blk_dim)
    cost_dtype = torch.float32 if metric == "ssim" else torch.int32
    gathered = [(0, grid, torch.int32), (1, grid, torch.int32),
                (2, grid, cost_dtype)]
    if with_comp:
        gathered.append((3, (batch, hp, wp), torch.int32))
    mv_y, mv_x, cost, *comp = (
        _assemble({s: p[i] for s, p in parts.items()}, mesh, shape, dtype,
                  home)
        for i, shape, dtype in gathered)
    sq, fmax = _reduce_stats({s: p[4] for s, p in parts.items()},
                             {s: p[5] for s, p in parts.items()}, mesh,
                             batch, home)
    return ShardedStepResult(mv_y, mv_x, cost, comp[0] if comp else None,
                             sq, fmax)


def sharded_gop_pipelined(frames, *, mesh: Mesh, blk_dim: int, span: int,
                          metric: str = "mse", frame_height: int,
                          frame_width: int, backend: str = "auto"):
    """Full search over the consecutive pairs of a [P+1, H, W] frame stack
    on a spatial mesh (dp = 1), carrying the exchanged halo (the port of
    `sharded_gop_pipelined`, sharded.py:318): step i searches pair
    (frames[i+1], frames[i]) against the carried halo of frames[i], and
    frames[i+1]'s halo, exchanged before that search, is carried to step
    i+1. Each frame's halo is exchanged once, where per-pair steps
    exchange every reference anew.

    frames: [P+1, H, W] integer frames, or `FrameShards` of the padded
    stack (dp = 1: every slot holds every frame's tile). Returns (mv_y,
    mv_x, cost, sum_sq, frame_max): [P, nby_p, nbx_p] each of the first
    three, [P] the stats; equal to `sharded_motion_step` run per pair
    (the compensated frames stay per tile and are not returned).
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
    local = mesh.local_slots()
    outs = {slot: [] for slot in local}

    def exchange(i):
        return halo_lib.start_halo_exchange_2d(
            {s: t[i] for s, t in stack.tiles.items()}, span, mesh)

    carried = exchange(0)()
    for i in range(1, pairs + 1):
        # The next pair's reference halo does not depend on this pair's
        # search: its "tx" sweep is issued first; the wait before the next
        # pair's search finishes it and runs the "ty" sweep.
        nxt = exchange(i)
        for slot in local:
            outs[slot].append(_step_slot(
                stack.tiles[slot][i : i + 1], [carried[slot]],
                slot[1] * tile_h, slot[2] * tile_w, **kw))
        carried = nxt()
    parts = {s: [torch.cat(kind) for kind in zip(*o)]
             for s, o in outs.items()}
    home = _home(mesh)
    grid = (pairs, hp // blk_dim, wp // blk_dim)
    cost_dtype = torch.float32 if metric == "ssim" else torch.int32
    mv_y, mv_x, cost = (
        _assemble({s: p[i] for s, p in parts.items()}, mesh, grid, dtype,
                  home)
        for i, dtype in ((0, torch.int32), (1, torch.int32),
                         (2, cost_dtype)))
    sq, fmax = _reduce_stats({s: p[4] for s, p in parts.items()},
                             {s: p[5] for s, p in parts.items()}, mesh,
                             pairs, home)
    return mv_y, mv_x, cost, sq, fmax


def sharded_full_search(cur, ref, *, mesh: Mesh, blk_dim: int, span: int,
                        metric: str = "mse", backend: str = "auto",
                        algorithm: str = "full",
                        early_term: float | None = None):
    """One frame pair (a batch of 1) on the mesh (the port of
    `sharded_full_search`, sharded.py:456): (mv_y, mv_x, cost, comp)
    cropped to the frame's block grid and pixels."""
    frame_height, frame_width = cur.shape
    res = sharded_motion_step(
        to_tensor(cur)[None], to_tensor(ref)[None], mesh=mesh,
        blk_dim=blk_dim, span=span, metric=metric,
        frame_height=frame_height, frame_width=frame_width, backend=backend,
        algorithm=algorithm, early_term=early_term)
    nby, nbx = geometry.grid_shape(frame_height, frame_width, blk_dim)
    return (res.mv_y[0, :nby, :nbx], res.mv_x[0, :nby, :nbx],
            res.best_cost[0, :nby, :nbx],
            res.comp[0, :frame_height, :frame_width])
