"""End-to-end pipelines: one frame pair (`run_pair`) and a GOP (`run_gop`).

`run_pair` mirrors the reference GPU binary: both frames are copied to the
card, the fused search runs there, and only the MV field comes back;
compensation, PSNR and residual scores run on the host. The timing split
is the reference's machine-parsable `total h2d kernel d2h psnr` row, each
phase bracketed by CUDA events on the card (host clock on the CPU).

`run_gop` processes a frame sequence pairwise, pipelined: a reader thread
reads frames into a pool of pinned host buffers and copies each to the
card on a copy stream, chunks of pairs are dispatched on the compute
stream (search, compensation and exact PSNR stats on the card), one
readback per chunk lands in pinned memory, and a writer thread dumps one
`mv_%05d.npz` per pair, which doubles as a frame-granular checkpoint.

`run_gop_sharded` processes a GOP over a device mesh (`parallel/`): pairs
batched along "dp", frame tiles over ("ty", "tx"), the same dumps.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import queue
import threading
import time
from typing import Sequence

import numpy as np
import torch

from motionestimation_tpu_torch.core import frames as frames_lib
from motionestimation_tpu_torch.core import geometry
from motionestimation_tpu_torch.core.config import SearchConfig
from motionestimation_tpu_torch.core.device import resolve_device, to_tensor
from motionestimation_tpu_torch.kernels.full_search_cuda import (
    full_search_frame_cuda,
)
from motionestimation_tpu_torch.kernels.ssim_cuda import ssim_search_frame_cuda
from motionestimation_tpu_torch.parallel import ingest
from motionestimation_tpu_torch.parallel import sharded
from motionestimation_tpu_torch.search import full_search as fs
from motionestimation_tpu_torch.search.diamond import diamond_search_frame
from motionestimation_tpu_torch.search.full_search import MotionField


@dataclasses.dataclass
class PairResult:
    """Everything one frame pair produces."""

    field: MotionField  # numpy arrays, [nby, nbx]
    comp: np.ndarray  # [H, W] int32 motion-compensated frame
    psnr: float  # compensated vs current (observed-max rules)
    original_score: float  # residual MSE cur-vs-ref, C float32 accumulation
    compensated_score: float  # residual MSE cur-vs-comp
    total_ms: float
    h2d_ms: float
    kernel_ms: float
    d2h_ms: float

    @property
    def timing_row(self) -> str:
        """`total h2d kernel d2h psnr`."""
        return (
            f"{self.total_ms:.6f} {self.h2d_ms:.6f} {self.kernel_ms:.6f} "
            f"{self.d2h_ms:.6f} {self.psnr:.4f}"
        )


def _mark(device: torch.device):
    """A timing mark: a recorded CUDA event on the card, the host clock
    on the CPU."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def _search(cur, ref, config: SearchConfig, dev: torch.device) -> MotionField:
    """The search of one pair on `dev`, routed as `run_pair` and `run_gop`
    route it: `diamond_search_frame` (with the config's `early_term` and
    `escape_policy`), `ssim_search_frame_cuda` (SSIM) or
    `full_search_frame_cuda` (MSE, SAD)."""
    kw = dict(blk_dim=config.blk_dim, span=config.span, device=dev)
    if config.algorithm == "diamond":
        return diamond_search_frame(
            cur, ref, metric=config.metric, early_term=config.early_term,
            escape_policy=config.escape_policy, **kw,
        )
    if config.metric == "ssim":
        return ssim_search_frame_cuda(cur, ref, **kw)
    return full_search_frame_cuda(cur, ref, metric=config.metric, **kw)


def run_pair(
    cur: np.ndarray,
    ref: np.ndarray,
    config: SearchConfig,
    *,
    device=None,
) -> PairResult:
    """Run one frame pair end to end with a 4-phase timing split.

    h2d = both frames to the card; kernel = the search (and the int8 MV
    packing); d2h = the MV field back to the host. Compensation, PSNR and
    scores are untimed host post-processing. `device` defaults to "cuda".
    Full search runs `full_search_frame_cuda` (MSE, SAD) or
    `ssim_search_frame_cuda` (SSIM); diamond search runs
    `diamond_search_frame` with the config's `early_term` and
    `escape_policy`.
    """
    dev = resolve_device(device)
    on_card = torch.cuda.device(dev) if dev.type == "cuda" else None
    with on_card or contextlib.nullcontext():
        t0 = _mark(dev)
        cur_d = to_tensor(cur, dev)
        ref_d = to_tensor(ref, dev)
        t1 = _mark(dev)
        field = _search(cur_d, ref_d, config, dev)
        mv_dtype = torch.int8 if config.span <= 127 else torch.int32
        mv_d = torch.stack([field.mv_y, field.mv_x]).to(mv_dtype)
        t2 = _mark(dev)
        mv = mv_d.cpu().numpy()
        t3 = _mark(dev)
        if dev.type == "cuda":
            t3.synchronize()

    # Host post-processing (untimed, reference parity).
    mv_y = mv[0].astype(np.int32)
    mv_x = mv[1].astype(np.int32)
    host_field = MotionField(
        mv_y, mv_x, field.best_cost_i32.cpu().numpy(),
        field.score.cpu().numpy(),
    )
    comp = frames_lib.compensate_frame_np(ref, mv_y, mv_x, config.blk_dim)
    cur_i = np.asarray(cur).astype(np.int32)
    return PairResult(
        field=host_field,
        comp=comp,
        psnr=frames_lib.image_psnr(comp, cur_i),
        original_score=frames_lib.residual_mse_c_float32(cur, ref),
        compensated_score=frames_lib.residual_mse_c_float32(cur_i, comp),
        total_ms=_elapsed_ms(t0, t3),
        h2d_ms=_elapsed_ms(t0, t1),
        kernel_ms=_elapsed_ms(t1, t2),
        d2h_ms=_elapsed_ms(t2, t3),
    )


def write_artifacts(
    result: PairResult,
    cur: np.ndarray,
    ref: np.ndarray,
    config: SearchConfig,
    output_dir: str | os.PathLike,
) -> str:
    """Write the 5-frame stacked YUV; returns the path."""
    os.makedirs(output_dir, exist_ok=True)
    stack = frames_lib.stack_output(ref, cur, result.comp)
    path = frames_lib.output_filename(output_dir, config.blk_dim, config.span)
    frames_lib.save_yuv(path, stack)
    return path


def _mv_dump_path(output_dir, i: int) -> str:
    return os.path.join(os.fspath(output_dir), f"mv_{i:05d}.npz")


def _block_area(config: SearchConfig) -> np.ndarray:
    """float32 [nby, nbx]: each block's true (truncated) pixel count, for
    the dumps' score (the float32 division of metrics.cost.mse_from_ssd)."""
    h, w, blk = config.frame_height, config.frame_width, config.blk_dim
    nby, nbx = geometry.grid_shape(h, w, blk)
    bh = np.minimum(blk, h - np.arange(nby) * blk).astype(np.float32)
    bw = np.minimum(blk, w - np.arange(nbx) * blk).astype(np.float32)
    return bh[:, None] * bw[None, :]


def _dump(output_dir, i: int, paths, config: SearchConfig, area, mv_y, mv_x,
          cost, sum_sq: int, frame_max: int) -> None:
    """Write pair i's `mv_%05d.npz`: int32 MVs, best_cost (the integer
    SSD/SAD, or the SSIM score), score (cost / area in float32, or the SSIM
    score), psnr from the exact stats, and the two frames' paths."""
    psnr = frames_lib.psnr_from_stats(
        sum_sq, config.frame_height * config.frame_width, frame_max)
    if config.metric == "ssim":
        score = cost
    else:
        score = cost.astype(np.float32) / area
    np.savez(
        _mv_dump_path(output_dir, i),
        mv_y=mv_y.astype(np.int32),
        mv_x=mv_x.astype(np.int32),
        best_cost=cost,
        score=score,
        psnr=psnr,
        cur=paths[i + 1],
        ref=paths[i],
    )


def _runs(todo: list[int]) -> list[list[int]]:
    """`todo`'s runs of consecutive pair indices (resume can leave
    holes)."""
    runs: list[list[int]] = []
    for i in todo:
        if runs and runs[-1][-1] == i - 1:
            runs[-1].append(i)
        else:
            runs.append([i])
    return runs


def _gop_pack_kk(config: SearchConfig) -> int | None:
    """(cost, mv) -> single uint32 packing spec for the GOP readback.

    When cost * K² + flat_mv_index fits uint32 (blk-8 MSE, SAD at every
    block size), MVs and integer costs come back as ONE 32-bit plane per
    pair instead of an int8 MV pair + int32 cost plane. Returns K² (the
    pack modulus) or None when packing does not apply."""
    if config.metric not in ("mse", "sad"):
        return None
    k = 2 * config.span + 1
    max_cost = (
        65025 if config.metric == "mse" else 255
    ) * config.blk_dim * config.blk_dim
    if (max_cost + 1) * k * k <= 2**32:
        return k * k
    return None


def _gop_chunk(frames, config: SearchConfig, dev: torch.device):
    """The device work of one chunk, enqueued on the current stream: pair j
    is (frames[j + 1] as current, frames[j] as reference).

    For each pair: the search (`_search`), compensation on the device,
    exact stats Σerr² (int64) and fmax = max(comp, cur), and the field as
    the `_gop_pack_kk` payload cost·K² + flat (its low 32 bits as an int32
    bit pattern; the host reads them as uint32) or else the int8 (span <=
    127) MV pair and the int32 cost (SSIM: the float32 score). Returns the
    chunk's outputs stacked per kind: (payload, sq, fmax) or (mv, cost, sq,
    fmax)."""
    h, w = config.frame_height, config.frame_width
    span, k = config.span, 2 * config.span + 1
    kk = _gop_pack_kk(config)
    mv_dtype = torch.int8 if span <= 127 else torch.int32
    outs = []
    for ref, cur in zip(frames[:-1], frames[1:]):
        field = _search(cur, ref, config, dev)
        comp = fs.compensate_frame(
            ref, field, frame_height=h, frame_width=w,
            blk_dim=config.blk_dim, span=span,
        )
        cur_i = cur.to(torch.int32)
        err = comp - cur_i
        stats = (torch.sum(err * err, dtype=torch.int64),
                 torch.maximum(comp, cur_i).max())
        if kk is not None:
            flat = (field.mv_y + span) * k + (field.mv_x + span)
            payload = field.best_cost_i32.to(torch.int64) * kk + flat
            payload = torch.where(payload >= 2**31, payload - 2**32, payload)
            outs.append((payload.to(torch.int32), *stats))
        else:
            mv = torch.stack([field.mv_y, field.mv_x]).to(mv_dtype)
            cost = (field.score if config.metric == "ssim"
                    else field.best_cost_i32)
            outs.append((mv, cost, *stats))
    return tuple(torch.stack(kind) for kind in zip(*outs))


def _to_host(outs, dev: torch.device):
    """(host tensors, event): on the card each output copied once with
    `non_blocking=True` into pinned memory, and an event recorded after
    the copies; on the CPU the outputs themselves and None."""
    if dev.type == "cpu":
        return outs, None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in outs)
    for dst, src in zip(host, outs):
        dst.copy_(src, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def run_gop(
    frame_paths: Sequence[str | os.PathLike],
    config: SearchConfig,
    *,
    output_dir: str | os.PathLike,
    device=None,
    resume: bool = True,
    chunk_pairs: int = 8,
    stats_out: dict | None = None,
) -> list[str]:
    """Process a GOP: pair i = (frames[i+1] as current, frames[i] as ref).

    Pipelined end to end. A reader thread reads frames (window-bounded)
    into a pool of pinned host buffers and copies each to the card on a
    copy stream (`non_blocking=True`, an event after each copy); the
    compute stream waits on that event before the frame's first use. A
    buffer goes back to the pool only once its copy's event has completed.
    Steady state ships one new frame per pair. `chunk_pairs` consecutive
    pairs are dispatched per chunk (`_gop_chunk`), their outputs read back
    once into pinned memory, and a writer thread waits on each chunk's
    event and dumps `mv_%05d.npz` off the dispatch path. On the CPU
    (device="cpu", the plain versions of the kernels) the staged frame is
    a copy of its buffer, so the reader may refill the buffer at once.

    Each pair's `mv_%05d.npz` (mv_y, mv_x, best_cost, score, psnr, cur,
    ref) doubles as a frame-granular checkpoint: existing dumps are
    skipped when `resume`, so a killed run restarts where it stopped.

    `stats_out`, when given, receives a wall-clock phase split: load_s
    (host YUV reads), h2d_enqueue_s (enqueueing the copies, which overlap
    downstream), dispatch_s (enqueueing chunks and their readbacks),
    d2h_wait_s (writer blocked on results: the h2d + compute + d2h
    pipeline depth), dump_s (npz writes), wall_s, pairs and chunks.

    `device` defaults to "cuda" and raises where CUDA is absent. Returns
    the list of dump paths (one per pair, including skipped).
    """
    dev = resolve_device(device)
    if chunk_pairs < 1:
        raise ValueError("chunk_pairs must be >= 1")
    os.makedirs(output_dir, exist_ok=True)
    h, w = config.frame_height, config.frame_width
    area = _block_area(config)

    paths = [os.fspath(p) for p in frame_paths]
    if len(paths) < 2:
        raise ValueError("a GOP needs at least two frames")

    todo = [
        i for i in range(len(paths) - 1)
        if not (resume and os.path.exists(_mv_dump_path(output_dir, i)))
    ]
    out = [_mv_dump_path(output_dir, i) for i in range(len(paths) - 1)]
    if not todo:
        return out

    stats = {
        "load_s": 0.0, "h2d_enqueue_s": 0.0, "dispatch_s": 0.0,
        "d2h_wait_s": 0.0, "dump_s": 0.0, "wall_s": 0.0,
        "pairs": len(todo), "chunks": 0,
    }
    t_wall = time.perf_counter()

    # Consecutive runs of todo indices (resume can leave holes); pairs in
    # a run share boundary frames. Runs are pairwise disjoint in frame
    # indices, so the concatenated per-run frame ranges list each needed
    # frame once, in consumption order.
    runs = _runs(todo)
    frame_order: list[int] = []
    for run in runs:
        frame_order.extend(range(run[0], run[-1] + 2))

    on_card = dev.type == "cuda"
    card = torch.cuda.device(dev) if on_card else contextlib.nullcontext()
    with card:
        # Pinned (page-locked) on the card, so each copy is one DMA that
        # returns at once. Every read fills its buffer whole or raises.
        pool = [torch.empty((h, w), dtype=torch.uint8, pin_memory=on_card)
                for _ in range(min(3 * chunk_pairs + 6, len(frame_order)))]
        copy_stream = torch.cuda.Stream(dev) if on_card else None
        compute = torch.cuda.current_stream(dev) if on_card else None
    host_q: queue.Queue = queue.Queue()
    read_window = threading.Semaphore(2 * chunk_pairs + 2)
    reader_err: list[BaseException] = []
    cancel = threading.Event()

    def stage(buf):
        """(the frame on `dev`, owning its memory; the event after its
        copy, or None on the CPU)."""
        if not on_card:
            return buf.clone(), None
        with torch.cuda.stream(copy_stream):
            d = torch.empty((h, w), dtype=torch.uint8, device=dev)
            d.copy_(buf, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(copy_stream)
        return d, copied

    def reader():
        free = list(pool)
        in_flight = collections.deque()  # (event, buffer) its copy reads
        try:
            with (torch.cuda.device(dev) if on_card
                  else contextlib.nullcontext()):
                for i in frame_order:
                    read_window.acquire()
                    if cancel.is_set():
                        return
                    # Recycle the buffers whose copies have completed;
                    # with none free, wait for the oldest copy.
                    while in_flight and (not free or in_flight[0][0].query()):
                        copied, buf = in_flight.popleft()
                        copied.synchronize()
                        free.append(buf)
                    buf = free.pop()
                    t0 = time.perf_counter()
                    frames_lib.load_yuv_into(paths[i], buf.numpy())
                    t1 = time.perf_counter()
                    d, copied = stage(buf)
                    stats["load_s"] += t1 - t0
                    stats["h2d_enqueue_s"] += time.perf_counter() - t1
                    if copied is None:
                        free.append(buf)
                    else:
                        in_flight.append((copied, buf))
                    host_q.put((i, d, copied))
        except BaseException as e:  # noqa: BLE001 — re-raised in main
            reader_err.append(e)
            host_q.put((None, None, None))

    rt = threading.Thread(target=reader, name="gop-reader", daemon=True)
    rt.start()

    staged: dict[int, torch.Tensor] = {}

    def frame_dev(i):
        if i not in staged:
            j, d, copied = host_q.get()
            if d is None:
                raise reader_err[0]
            assert j == i, f"reader order skew: wanted {i}, got {j}"
            if copied is not None:
                compute.wait_event(copied)
                # Made on the copy stream: its memory may be reused only
                # after the compute stream's last use.
                d.record_stream(compute)
            staged[i] = d
            read_window.release()
        return staged[i]

    kk = _gop_pack_kk(config)
    k = 2 * config.span + 1

    def dump_chunk(idxs, nps):
        if kk is not None:
            payload, sq, fmax = nps
            payload = payload.view(np.uint32)
            cost = (payload // kk).astype(np.int32)
            flat = (payload % kk).astype(np.int32)
            mv = np.stack([flat // k - config.span,
                           flat % k - config.span], axis=1)
        else:
            mv, cost, sq, fmax = nps
        t0 = time.perf_counter()
        for slot, i in enumerate(idxs):
            _dump(output_dir, i, paths, config, area, mv[slot, 0],
                  mv[slot, 1], cost[slot], int(sq[slot]), int(fmax[slot]))
        stats["dump_s"] += time.perf_counter() - t0

    # Writer thread: waiting on results and writing npz files happen off
    # the dispatch path.
    work: queue.Queue = queue.Queue(maxsize=4)
    writer_err: list[BaseException] = []

    def writer():
        while True:
            item = work.get()
            if item is None:
                return
            if writer_err:
                continue  # drain mode: keep consuming so puts never block
            idxs, host, done = item
            try:
                t0 = time.perf_counter()
                if done is not None:
                    done.synchronize()
                nps = [t.numpy() for t in host]
                stats["d2h_wait_s"] += time.perf_counter() - t0
                dump_chunk(idxs, nps)
            except BaseException as e:  # noqa: BLE001 — re-raised in main
                writer_err.append(e)

    wt = threading.Thread(target=writer, name="gop-writer", daemon=True)
    wt.start()

    try:
        with card:
            for run in runs:
                for c0 in range(0, len(run), chunk_pairs):
                    idxs = run[c0 : c0 + chunk_pairs]
                    frame_idx = [idxs[0]] + [i + 1 for i in idxs]
                    frames = [frame_dev(i) for i in frame_idx]
                    t0 = time.perf_counter()
                    host, done = _to_host(_gop_chunk(frames, config, dev),
                                          dev)
                    stats["dispatch_s"] += time.perf_counter() - t0
                    stats["chunks"] += 1
                    work.put((idxs, host, done))
                    if writer_err:
                        break
                    # Evict everything but the boundary frame shared with
                    # the next chunk.
                    for i in frame_idx[:-1]:
                        staged.pop(i, None)
                if writer_err:
                    break
    finally:
        work.put(None)
        wt.join()
        cancel.set()
        read_window.release()  # unblock a reader waiting on the window
        rt.join()
        staged.clear()
        stats["wall_s"] = time.perf_counter() - t_wall
        if stats_out is not None:
            stats_out.update(stats)
    if writer_err:
        raise writer_err[0]
    return out


def run_gop_sharded(
    frame_paths: Sequence[str | os.PathLike],
    config: SearchConfig,
    *,
    mesh,
    output_dir: str | os.PathLike,
    resume: bool = True,
    pipelined: bool | str = "auto",
    chunk_pairs: int = 8,
) -> list[str]:
    """Process a GOP over a device mesh (the port of `run_gop_sharded`,
    runner.py:574): pair i = (frames[i+1] as current, frames[i] as ref).

    Consecutive pairs are batched along the mesh's "dp" axis, each batch
    one `parallel.sharded.sharded_motion_step` (halo exchange, search on
    the ported kernels' tile entries on a CUDA mesh, compensation, exact
    stats; the compensated frame, which no dump holds, is not gathered),
    frame tiles over ("ty", "tx"); the next batch is staged while
    the current one computes (`parallel.ingest.ShardedPrefetcher`). On a
    dp = 1 mesh, full search runs `sharded_gop_pipelined` over runs of
    `chunk_pairs` consecutive pairs instead, which exchanges each frame's
    halo once: `pipelined="auto"` (default) takes it wherever it applies,
    True requires it (raising where it does not apply), False keeps the
    per-pair path. Both give the same dumps.

    The dumps are `run_gop`'s, key for key and value for value: `score` is
    cost / area in float32 for MSE and SAD, where the JAX sharded path
    writes the integer cost (ROADMAP Queue 3, reference fault 5). Existing
    dumps are skipped when `resume`. `escape_policy="crossover"` raises
    ValueError: the JAX path drops the policy and runs canonical diamond
    without a word (reference fault 2), and the sharded diamond has no
    crossover.

    Under a process group every rank calls it with the same arguments.
    Each reads only its own frame rows from disk
    (`ingest.local_row_range`, `frames.load_yuv_rows`); every rank
    receives the results (`sharded.ShardedStepResult`) and rank 0 writes
    the dumps. Resume needs every rank to see the same `output_dir`.
    Returns the dump paths, one per pair, skipped ones included.
    """
    if config.escape_policy != "canonical":
        raise ValueError(
            f"escape_policy={config.escape_policy!r}: the sharded diamond "
            f"runs the canonical policy only")
    if chunk_pairs < 1:
        raise ValueError("chunk_pairs must be >= 1")
    is_lead = mesh.rank == 0
    if is_lead:
        os.makedirs(output_dir, exist_ok=True)
    h, w = config.frame_height, config.frame_width
    paths = [os.fspath(p) for p in frame_paths]
    if len(paths) < 2:
        raise ValueError("a GOP needs at least two frames")
    npairs = len(paths) - 1
    todo = [
        i for i in range(npairs)
        if not (resume and os.path.exists(_mv_dump_path(output_dir, i)))
    ]
    out = [_mv_dump_path(output_dir, i) for i in range(npairs)]
    if torch.distributed.is_initialized():
        torch.distributed.barrier()  # every rank has read the dump state
    if not todo:
        return out

    dp = mesh.shape["dp"]
    hp, wp = sharded.padded_dims_for_mesh(h, w, config.blk_dim, mesh)
    row_lo, row_hi = ingest.local_row_range(mesh, hp)
    nby, nbx = geometry.grid_shape(h, w, config.blk_dim)
    area = _block_area(config)
    step_kw = dict(mesh=mesh, blk_dim=config.blk_dim, span=config.span,
                   metric=config.metric, frame_height=h, frame_width=w)
    frames_cache: dict[int, np.ndarray] = {}

    def frame_local(i):
        """This process's padded rows [row_lo, row_hi) of frame i (the
        padding rows lie below the frame)."""
        if i not in frames_cache:
            r0, r1 = min(row_lo, h), min(row_hi, h)
            rows = frames_lib.load_yuv_rows(paths[i], h, w, r0, r1)
            frames_cache[i] = np.pad(
                rows, ((0, (row_hi - row_lo) - (r1 - r0)), (0, wp - w)))
        return frames_cache[i]

    def readback(idxs, mv_y, mv_x, cost, sq, fmax):
        """Enqueue a chunk's results' copies to (pinned) host memory: its
        MV and cost grids cut to the frame's blocks, and the stats."""
        outs = tuple(t[:, :nby, :nbx] for t in (mv_y, mv_x, cost))
        home = mv_y.device
        with (torch.cuda.device(home) if home.type == "cuda"
              else contextlib.nullcontext()):
            host, done = _to_host(outs + (sq, fmax), home)
        return idxs, host, done

    def dump(idxs, host, done):
        if done is not None:
            done.synchronize()
        if not is_lead:
            return
        mv_y, mv_x, cost, sq, fmax = (t.numpy() for t in host)
        for slot, i in enumerate(idxs):
            _dump(output_dir, i, paths, config, area, mv_y[slot],
                  mv_x[slot], cost[slot], int(sq[slot]), int(fmax[slot]))

    can_pipeline = dp == 1 and config.algorithm == "full"
    if pipelined is True and not can_pipeline:
        raise ValueError(
            "pipelined=True requires a dp = 1 mesh and algorithm='full'")

    def chunk_results():
        """(pair indices, results) of each chunk, its device work enqueued,
        the next chunk's frames staged meanwhile."""
        if can_pipeline and pipelined in (True, "auto"):
            work = []
            for run in _runs(todo):
                for c0 in range(0, len(run), chunk_pairs):
                    idxs = run[c0 : c0 + chunk_pairs]
                    work.append((idxs, [idxs[0]] + [i + 1 for i in idxs]))
            stacks = ingest.ShardedPrefetcher(
                (np.stack([frame_local(j) for j in frames_i])
                 for _, frames_i in work), mesh)
            for (idxs, frames_i), stack in zip(work, stacks):
                yield idxs, sharded.sharded_gop_pipelined(stack, **step_kw)
                for j in frames_i[:-1]:
                    frames_cache.pop(j, None)
            return
        chunks = [todo[i : i + dp] for i in range(0, len(todo), dp)]

        def host_batches(which):
            for chunk in chunks:
                idxs = chunk + [chunk[-1]] * (dp - len(chunk))  # pad
                sel = [i + 1 for i in idxs] if which == "cur" else idxs
                yield np.stack([frame_local(i) for i in sel])

        cur_stream = ingest.ShardedPrefetcher(host_batches("cur"), mesh)
        ref_stream = ingest.ShardedPrefetcher(host_batches("ref"), mesh)
        for chunk, cur_b, ref_b in zip(chunks, cur_stream, ref_stream):
            res = sharded.sharded_motion_step(
                cur_b, ref_b, algorithm=config.algorithm,
                early_term=config.early_term, with_comp=False, **step_kw)
            yield chunk, (res.mv_y, res.mv_x, res.best_cost, res.sum_sq,
                          res.frame_max)
            for i in chunk:
                frames_cache.pop(i, None)

    # Chunk k's dumps are written while chunk k+1 runs on the card.
    pending = None
    for idxs, outs in chunk_results():
        staged = readback(idxs, *outs)
        if pending is not None:
            dump(*pending)
        pending = staged
    if pending is not None:
        dump(*pending)
    return out
