"""Fused SSIM full search on the CUDA kernels of csrc/ssim.cu and
csrc/ssim_search.cu.

The PyTorch counterpart of `motionestimation_tpu.kernels.ssim_pallas` on
the SSIM path:

* `ssim_fast_search` launches `me_ssim_fast_search`, the port of the
  Pallas kernel `_kernel_ssim_fast` (ssim_pallas.py:214): all full
  interior blocks, blk <= 32, span >= 0; optionally with the score volume
  (its `emit_volume` mode). It is the SSIM instance of the
  warp-per-macroblock body (csrc/warp_search.cuh) that K1, K5, K6 and K7
  run; `ssim_fast_occupancy` reports its resources.
* `ssim_search` launches `me_ssim_search`, the port of `_kernel_ssim`
  (:48): blocks with truncated extents, any blk; optionally with the score
  volume. `ssim_occupancy` reports its resources.
* `ssim_search_frame_cuda` (the port of `ssim_search_frame_pallas`, :560)
  runs the interior, then the bottom and right edge slabs, merges them in
  the same order and decodes MVs.
* `ssim_volume_cuda` (the port of `ssim_volume_pallas`, :690) returns the
  whole-frame float32 [K², nby, nbx] score volume from the two emit modes.
* `ssim_search_tile_cuda` and `ssim_volume_tile_cuda` (the ports of
  `ssim_search_tile_pallas`, :878, and `ssim_volume_tile_pallas`, :724)
  search one mesh shard's tile at its global origin with the same two
  kernels (`full_search_cuda.shard_tile`).

Beside the two kernels stands their plain PyTorch version, `ssim_plain`,
built on `search.full_search.make_displacement_cost(metric="ssim")` and
`scan_argmax` over the same inputs and output layout. A wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches
its kernel or raises. Each wrapper counts its launches in its `launches`
attribute, and those that write a volume in `volume_launches` as well.
Kernels and plain version evaluate the score one IEEE float32 operation at
a time in the same order, so they agree bit for bit.

Operands (both wrappers), as in kernels/full_search_cuda.py:
  cur       uint8 [tile_h, tile_w], unit column stride; pixel (0, 0) is
            global (y_origin, x_origin).
  ref_halo  uint8, at least [tile_h + 2*span, tile_w + 2*span], unit
            column stride; global reference pixel
            (y_origin + r - span, x_origin + c - span) at [r, c], zero
            outside the frame.
Returns (float32 score, int32 flat index) block grids.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from motionestimation_tpu_torch.core import geometry
from motionestimation_tpu_torch.core.device import resolve_device
from motionestimation_tpu_torch.kernels import _build
from motionestimation_tpu_torch.kernels import full_search_cuda as fsc
from motionestimation_tpu_torch.search import full_search as fs

FAST_MAX_BLK = 32
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# Launcher argument types per source: pointers (cur, ref, score, idx, vol),
# ints (strides, grid, blk, span, frame, origin), the stream; occupancy
# queries take ints and the output pointer.
_SIGNATURES = {
    "ssim": {
        "me_ssim_fast_search": [_PTR] * 5 + [_INT] * 11 + [_PTR],
        "me_ssim_fast_occupancy": [_INT] * 3 + [_PTR],
    },
    "ssim_search": {
        "me_ssim_search": [_PTR] * 5 + [_INT] * 11 + [_PTR],
        "me_ssim_occupancy": [_INT] * 4 + [_PTR],
    },
}
# The source of each wrapper's launcher.
_SOURCE = {"ssim_fast_search": "ssim", "ssim_search": "ssim_search"}


@functools.cache
def _lib(source: str) -> ctypes.CDLL:
    lib = _build.load(source)
    for name, argtypes in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def ssim_supported(blk_dim: int, span: int) -> bool:
    """Whether the fast kernel serves a tile entry for this config (as
    `ssim_supported`, ssim_pallas.py:682): blk <= 32 and span >= 1. The
    whole-frame search also runs span 0 through it."""
    return blk_dim <= FAST_MAX_BLK and span >= 1


def ssim_fast_occupancy(blk_dim: int, span: int, nbx: int) -> dict:
    """`me_ssim_fast_search`'s resources (no volume) for a grid of `nbx`
    macroblocks a row, as `full_search_cuda.occupancy` reports them."""
    if not 1 <= blk_dim <= FAST_MAX_BLK or span < 0 or nbx < 1:
        raise ValueError(f"no fast SSIM kernel for blk_dim={blk_dim} "
                         f"span={span} nbx={nbx}")
    return fsc.occupancy(_lib("ssim").me_ssim_fast_occupancy, blk_dim, span,
                         nbx)


def ssim_occupancy(blk_dim: int, span: int, nby: int, nbx: int) -> dict:
    """`me_ssim_search`'s resources (no volume) for an [nby, nbx] grid, as
    `full_search_cuda.occupancy` reports them."""
    if min(blk_dim, nby, nbx) < 1 or span < 0:
        raise ValueError(f"no truncated-extent SSIM kernel for blk_dim="
                         f"{blk_dim} span={span} grid={nby}x{nbx}")
    return fsc.occupancy(_lib("ssim_search").me_ssim_occupancy, blk_dim,
                         span, nby, nbx)


def _launch(fn, cur, ref_halo, nby, nbx, *, blk_dim, span, frame_height,
            frame_width, y_origin, x_origin, volume=None):
    """Run one of the two CUDA launchers on a CUDA tensor pair; `volume`, a
    float32 [K², nby, nbx] tensor or None, receives every score."""
    fsc.check_kernel_operands(cur, ref_halo)
    score = torch.empty((nby, nbx), dtype=torch.float32, device=cur.device)
    idx = torch.empty((nby, nbx), dtype=torch.int32, device=cur.device)
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            cur.data_ptr(), ref_halo.data_ptr(),
            score.data_ptr(), idx.data_ptr(),
            None if volume is None else volume.data_ptr(),
            cur.stride(0), ref_halo.stride(0), nbx, nby, nbx,
            blk_dim, span, frame_height, frame_width, y_origin, x_origin,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{fn.__name__} failed with CUDA error {err} "
            f"(blk_dim={blk_dim} span={span} grid={nby}x{nbx})"
        )
    return score, idx


def ssim_plain(cur, ref_halo, *, blk_dim: int, span: int, frame_height: int,
               frame_width: int, y_origin: int = 0, x_origin: int = 0,
               return_volume: bool = False):
    """Plain PyTorch version of both kernels over the same operands.

    Block grid cdiv(tile, blk_dim), truncated extents from the frame, the
    raster scan with strict `>` from (0.0, centre). For the full in-frame
    blocks `ssim_fast_search` accepts, the extents are full and this is
    the fast kernel's arithmetic too. With `return_volume`, also the
    float32 [K², nby, nbx] volume of every score (-inf at invalid
    candidates).
    """
    fsc.check_operand_shapes(cur, ref_halo, span)
    tile_h, tile_w = cur.shape
    nby, nbx = geometry.grid_shape(tile_h, tile_w, blk_dim)
    pad = (0, nbx * blk_dim - tile_w, 0, nby * blk_dim - tile_h)
    cur_p = F.pad(cur.to(torch.int32), pad)
    halo_p = F.pad(
        ref_halo[: tile_h + 2 * span, : tile_w + 2 * span].to(torch.int32),
        pad,
    )
    cost_fn = fs.make_displacement_cost(
        cur_p, halo_p, y_origin, x_origin,
        frame_height=frame_height, frame_width=frame_width,
        blk_dim=blk_dim, span=span, metric="ssim",
    )
    return fs.scan_argmax(cost_fn, span, (nby, nbx), cur.device,
                          return_volume=return_volume)


def ssim_fast_search(cur, ref_halo, *, blk_dim: int, span: int,
                     frame_height: int, frame_width: int, y_origin: int = 0,
                     x_origin: int = 0, return_volume: bool = False):
    """SSIM search of full interior blocks (`me_ssim_fast_search`, the port
    of `_kernel_ssim_fast`). Every block of the tile must lie inside the
    frame; returns (float32 score, int32 idx), [tile_h // blk, tile_w //
    blk], and with `return_volume` the float32 [K², nby, nbx] volume of
    every candidate's score (-inf at invalid candidates; the kernel's emit
    mode)."""
    fsc.check_operand_shapes(cur, ref_halo, span)
    if not 1 <= blk_dim <= FAST_MAX_BLK or span < 0:
        raise ValueError(
            f"fast SSIM kernel requires 1 <= blk_dim <= {FAST_MAX_BLK} and "
            f"span >= 0, got blk_dim={blk_dim} span={span}"
        )
    fsc.check_interior_tile(cur.shape, blk_dim, frame_height, frame_width,
                            y_origin, x_origin)
    return _run(ssim_fast_search, cur, ref_halo,
                (cur.shape[0] // blk_dim, cur.shape[1] // blk_dim),
                return_volume, blk_dim=blk_dim, span=span,
                frame_height=frame_height, frame_width=frame_width,
                y_origin=y_origin, x_origin=x_origin)


ssim_fast_search.launches = ssim_fast_search.volume_launches = 0


def ssim_search(cur, ref_halo, *, blk_dim: int, span: int, frame_height: int,
                frame_width: int, y_origin: int = 0, x_origin: int = 0,
                return_volume: bool = False):
    """SSIM search with truncated block extents (`me_ssim_search`, the port
    of `_kernel_ssim`): packed bytes, a warp per macroblock over its valid
    candidates, warps sharing a macroblock on thin slabs. The tile must
    hold every in-frame pixel of its blocks; returns (float32 score, int32
    idx), [cdiv(tile_h, blk), cdiv(tile_w, blk)], and with `return_volume`
    the float32 [K², nby, nbx] score volume (the kernel's emit mode)."""
    fsc.check_operand_shapes(cur, ref_halo, span)
    fsc.check_edge_tile(cur.shape, blk_dim, frame_height, frame_width,
                        y_origin, x_origin)
    return _run(ssim_search, cur, ref_halo,
                geometry.grid_shape(*cur.shape, blk_dim), return_volume,
                blk_dim=blk_dim, span=span, frame_height=frame_height,
                frame_width=frame_width, y_origin=y_origin, x_origin=x_origin)


ssim_search.launches = ssim_search.volume_launches = 0


def _run(wrapper, cur, ref_halo, grid, return_volume, **kw):
    """A wrapper's body: the plain version for CPU tensors, else one launch
    of `wrapper`'s kernel (`me_<wrapper name>`) on the [nby, nbx] `grid`,
    counted by `count_launch`."""
    if cur.device.type == "cpu":
        return ssim_plain(cur, ref_halo, return_volume=return_volume, **kw)
    nby, nbx = grid
    k = 2 * kw["span"] + 1
    volume = (torch.empty((k * k, nby, nbx), dtype=torch.float32,
                          device=cur.device) if return_volume else None)
    if nby == 0 or nbx == 0:
        out = (torch.empty((nby, nbx), dtype=torch.float32, device=cur.device),
               torch.empty((nby, nbx), dtype=torch.int32, device=cur.device))
    else:
        lib = _lib(_SOURCE[wrapper.__name__])
        out = _launch(getattr(lib, f"me_{wrapper.__name__}"), cur, ref_halo,
                      nby, nbx, volume=volume, **kw)
        fsc.count_launch(wrapper, volume)
    return (*out, volume) if return_volume else out


def _ssim_edge_bottom(cur, ref_halo, *, blk_dim: int, span: int,
                      return_volume: bool = False, frame_height=None,
                      frame_width=None, y_origin: int = 0, x_origin: int = 0):
    """SSIM search of the last (truncated) block row: `ssim_search` on the
    slab of rows [y_org, H) (the port of `_ssim_edge_bottom`, :958), of
    the whole frame or of a tile as `full_search_cuda._edge_slab_bottom`.
    Returns [1, nbx] block grids (and a [K², 1, nbx] volume)."""
    cur_s, halo_s, y_org = fsc.bottom_slab(cur, ref_halo, blk_dim, span)
    h, w = fsc.frame_of(cur, frame_height, frame_width)
    return ssim_search(cur_s, halo_s, blk_dim=blk_dim, span=span,
                       frame_height=h, frame_width=w,
                       y_origin=y_origin + y_org, x_origin=x_origin,
                       return_volume=return_volume)


def _ssim_edge_right(cur, ref_halo, *, blk_dim: int, span: int,
                     return_volume: bool = False, frame_height=None,
                     frame_width=None, y_origin: int = 0, x_origin: int = 0):
    """SSIM search of the last (truncated) block column: `ssim_search` on
    the slab of columns [x_org, W) (the port of `_ssim_edge_right`, :999),
    of the whole frame or of a tile. Returns [nby, 1] block grids (and a
    [K², nby, 1] volume)."""
    cur_s, halo_s, x_org = fsc.right_slab(cur, ref_halo, blk_dim, span)
    h, w = fsc.frame_of(cur, frame_height, frame_width)
    return ssim_search(cur_s, halo_s, blk_dim=blk_dim, span=span,
                       frame_height=h, frame_width=w, y_origin=y_origin,
                       x_origin=x_origin + x_org,
                       return_volume=return_volume)


def ssim_search_frame_cuda(cur, ref, *, blk_dim: int, span: int,
                           device=None) -> fs.MotionField:
    """Whole-frame SSIM full search on the CUDA kernels.

    cur/ref: [H, W] integer frames (numpy or torch), moved to `device`
    (default "cuda"; "cpu" runs the plain versions). Returns a MotionField
    in the golden SSIM layout: (mv_y, mv_x, flat index, float32 score).

    Routing follows `_ssim_frame_jit` (ssim_pallas.py:602): for blk <= 32
    the fast kernel on the interior (any span, 0 included), then the
    truncated-extent kernel on the bottom row and then the right column,
    which overwrites the corner (:661-676); for blk > 32 the
    truncated-extent kernel over the whole frame.
    """
    cur_t, ref_halo = fsc.frame_operands(cur, ref, span, resolve_device(device))
    kw = dict(blk_dim=blk_dim, span=span)
    if blk_dim <= FAST_MAX_BLK:
        score, idx = fsc.search_interior_and_edges(
            cur_t, ref_halo, ssim_fast_search, _ssim_edge_bottom,
            _ssim_edge_right, **kw,
        )
    else:
        h, w = cur_t.shape
        score, idx = ssim_search(
            cur_t, ref_halo, frame_height=h, frame_width=w, **kw
        )
    mv_y, mv_x = geometry.mv_from_flat_index(idx, span)
    return fs.MotionField(mv_y, mv_x, idx, score)


def ssim_volume_cuda(cur, ref, *, blk_dim: int, span: int,
                     device=None) -> torch.Tensor:
    """Whole-frame float32 [K², nby, nbx] SSIM score volume, -inf at every
    invalid candidate; equal entry for entry to the golden
    `full_search_frame(metric="ssim", return_cost_volume=True)`.

    The port of `ssim_volume_pallas` / `_ssim_volume_jit`
    (ssim_pallas.py:690, :798): the fast kernel's emit mode on the whole
    blocks, then the truncated-extent kernel's on the last block row and
    then the last block column, which overwrites the corner (the JAX
    package computes those slabs with its golden tile search, :852-874;
    here that search is the emit modes' plain version and runs only for
    CPU tensors). cur/ref: [H, W] integer frames, moved to `device`
    (default "cuda"). Configs outside `ssim_supported` raise ValueError.
    """
    if not ssim_supported(blk_dim, span):
        raise ValueError(
            f"ssim_volume_cuda requires blk_dim <= {FAST_MAX_BLK} and "
            f"span >= 1, got blk_dim={blk_dim} span={span}"
        )
    cur_t, ref_halo = fsc.frame_operands(cur, ref, span, resolve_device(device))
    return fsc.search_interior_and_edges(
        cur_t, ref_halo, ssim_fast_search, _ssim_edge_bottom,
        _ssim_edge_right, blk_dim=blk_dim, span=span, return_volume=True,
    )[2]


def _tile_search(cur_tile, ref_halo, y_origin, x_origin, outputs, *,
                 blk_dim, span, frame_height, frame_width,
                 return_volume=False):
    """`full_search_cuda.shard_tile` with the SSIM kernels, routed as
    `ssim_search_frame_cuda` routes a frame."""
    fsc.check_operand_shapes(cur_tile, ref_halo, span)
    where = dict(frame_height=frame_height, frame_width=frame_width,
                 y_origin=y_origin, x_origin=x_origin)
    kw = dict(blk_dim=blk_dim, span=span, return_volume=return_volume,
              **where)

    def search(cur, halo):
        if blk_dim > FAST_MAX_BLK:
            return ssim_search(cur, halo, **kw)
        return fsc.search_interior_and_edges(
            cur, halo, ssim_fast_search, _ssim_edge_bottom, _ssim_edge_right,
            **kw)

    return fsc.shard_tile(cur_tile, ref_halo, search, outputs,
                          blk_dim=blk_dim, **where)


def ssim_search_tile_cuda(cur_tile, ref_halo, y_origin: int, x_origin: int,
                          *, frame_height: int, frame_width: int,
                          blk_dim: int, span: int):
    """SSIM full search over one mesh shard's tile (the port of
    `ssim_search_tile_pallas`, ssim_pallas.py:878), operands as
    `full_search_cuda.full_search_tile_cuda`: the fast kernel on the whole
    in-frame blocks (blk <= 32) and the truncated-extent kernel on the
    frame's truncated edge, or that kernel on every block (blk > 32).
    Returns (float32 score, int32 flat idx), [th // blk, tw // blk];
    blocks wholly outside the frame hold (0.0, centre index). The JAX
    entry keeps chunk 4 and 2048-lane panels at blk > 16, a sizing its
    frame driver does not use (ROADMAP Queue 3, reference fault 1); the
    port has no such parameters, and its blk-32 tiles are held against the
    golden `full_search_tile(metric="ssim")`."""
    k = 2 * span + 1
    return _tile_search(
        cur_tile, ref_halo, y_origin, x_origin,
        [((), torch.float32, 0.0), ((), torch.int32, span * k + span)],
        blk_dim=blk_dim, span=span, frame_height=frame_height,
        frame_width=frame_width,
    )


def ssim_volume_tile_cuda(cur_tile, ref_halo, y_origin: int, x_origin: int,
                          *, frame_height: int, frame_width: int,
                          blk_dim: int, span: int):
    """Per-shard float32 [K², th // blk, tw // blk] SSIM score volume (the
    port of `ssim_volume_tile_pallas`, ssim_pallas.py:724) from the two
    kernels' emit modes, routed as `ssim_search_tile_cuda`; -inf at invalid
    candidates and on blocks wholly outside the frame."""
    k = 2 * span + 1
    return _tile_search(
        cur_tile, ref_halo, y_origin, x_origin,
        [((), torch.float32, 0.0), ((), torch.int32, span * k + span),
         ((k * k,), torch.float32, float("-inf"))],
        blk_dim=blk_dim, span=span, frame_height=frame_height,
        frame_width=frame_width, return_volume=True,
    )[2]
