"""Fused full search (MSE/SAD) and cost volumes on the CUDA kernels of
csrc/full_search.cu, csrc/int_search.cu and csrc/chunked.cu.

The PyTorch counterpart of `motionestimation_tpu.kernels.full_search_pallas`:

* `phase_search` launches `me_phase_search`, the port of the Pallas kernel
  `_kernel_phase` (full_search_pallas.py:729): all full interior blocks,
  blk in {1, 2, 4, 8, 16, 32}, span >= 1; optionally with the cost volume
  (its `emit_volume` mode).
* `int_search` launches `me_int_search`, the port of `_kernel_int`
  (:1076): blocks with truncated extents, any blk; optionally with the cost
  volume (the JAX package computes the volume's edge slabs with its golden
  tile search; here that search is the emit mode's plain version).
  `int_occupancy` reports its resources.
* `chunked_search` launches `me_chunked_search`, the port of `_kernel_f32`
  (:131): MSE of full interior blocks, blk 1..16, span >= 0, by hoisted
  box sums; optionally with the cost volume.
* `chunked_u8_search` launches `me_chunked_u8_search`, the port of
  `_kernel_f32_bf16` (:348), the TPU's A/B of bf16-staged operands: here
  every kernel reads packed bytes already, so it runs `chunked_search`'s
  own instance, without a volume.
* `wide_search` launches `me_wide_search`, the port of `_kernel_f32_wide`
  (:471): MSE of full interior blocks at blk 24 and 32.
* `full_search_frame_cuda` (the port of `full_search_frame_pallas`, :1415)
  routes as the JAX package does, runs the interior, then the bottom and
  right edge slabs, merges them in the same order, decodes MVs and scores.
* `full_search_volume_cuda` (the port of `full_search_volume_pallas`,
  :1796) returns the whole-frame [K², nby, nbx] cost volume from emit
  modes alone.
* `full_search_tile_cuda` and `full_search_volume_tile_cuda` (the ports of
  `full_search_tile_pallas`, :1621, and `full_search_volume_tile_pallas`,
  :1703) search one mesh shard's tile at its global origin with the same
  kernels (`shard_tile`): the interior kernel on the tile's whole in-frame
  blocks, the int kernel on the frame's truncated last block row and
  column where they cross the tile, and nothing on blocks wholly in the
  mesh's padding.

Beside the kernels stands their plain PyTorch version, `search_plain`,
built on `search.full_search.make_displacement_cost` over the same inputs
and output layout. A wrapper takes the plain version only for tensors on
the CPU; for CUDA tensors it launches its kernel or raises. Each wrapper
counts its launches in its `launches` attribute, and those that write a
volume (emit mode) in `volume_launches` as well.

Operands (every wrapper):
  cur       uint8 [tile_h, tile_w], unit column stride; pixel (0, 0) is
            global (y_origin, x_origin).
  ref_halo  uint8, at least [tile_h + 2*span, tile_w + 2*span], unit
            column stride; global reference pixel
            (y_origin + r - span, x_origin + c - span) at [r, c], zero
            outside the frame.
Returns int32 (cost, idx) block grids.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from motionestimation_tpu_torch.core import geometry
from motionestimation_tpu_torch.core.device import resolve_device, to_tensor
from motionestimation_tpu_torch.kernels import _build
from motionestimation_tpu_torch.search import full_search as fs

_METRIC_CODE = {"mse": 0, "sad": 1}
_PHASE_BLOCKS = (1, 2, 4, 8, 16, 32)
_SSIM_ELSEWHERE = (
    "full_search_frame_cuda searches MSE and SAD; SSIM runs on its own "
    "kernels: kernels/ssim_cuda.py ssim_search_frame_cuda"
)

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# Launcher argument types per source: pointers (cur, ref, cost, idx[, vol]),
# ints (strides, grid, blk, span[, metric], frame, origin), the stream.
_SIGNATURES = {
    "full_search": {
        "me_phase_search": [_PTR] * 5 + [_INT] * 12 + [_PTR],
        "me_phase_occupancy": [_INT] * 4 + [_PTR],
    },
    "int_search": {
        "me_int_search": [_PTR] * 5 + [_INT] * 12 + [_PTR],
        "me_int_occupancy": [_INT] * 5 + [_PTR],
    },
    "chunked": {
        "me_chunked_search": [_PTR] * 5 + [_INT] * 11 + [_PTR],
        "me_chunked_occupancy": [_INT] * 3 + [_PTR],
        "me_chunked_u8_search": [_PTR] * 4 + [_INT] * 11 + [_PTR],
        "me_wide_search": [_PTR] * 4 + [_INT] * 11 + [_PTR],
        "me_wide_occupancy": [_INT] * 3 + [_PTR],
    },
}
_EMITTERS = ("me_phase_search", "me_int_search", "me_chunked_search")
_TAKE_METRIC = ("me_phase_search", "me_int_search")


@functools.cache
def _lib(source: str) -> ctypes.CDLL:
    lib = _build.load(source)
    for name, argtypes in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def phase_supported(blk_dim: int, span: int, metric: str) -> bool:
    """Whether the phase kernel covers this config (as `_phase_supported`,
    full_search_pallas.py:1402): MSE/SAD, blk dividing 128 and <= 32,
    span >= 1."""
    return metric in _METRIC_CODE and blk_dim in _PHASE_BLOCKS and span >= 1


def chunked_supported(blk_dim: int, span: int) -> bool:
    """Whether the chunked kernels (K5, K6) cover this MSE config: blk
    1..16, span >= 0 (`use_f32`, full_search_pallas.py:1498)."""
    return 1 <= blk_dim <= 16 and span >= 0


def wide_supported(blk_dim: int, span: int) -> bool:
    """Whether the wide kernel (K7) covers this MSE config: blk % 8 == 0
    with 16 < blk <= 32, span >= 0 (`use_wide`, :1499)."""
    return 16 < blk_dim <= 32 and blk_dim % 8 == 0 and span >= 0


def volume_supported(blk_dim: int, span: int, metric: str) -> bool:
    """Whether `full_search_volume_cuda` covers this config (as
    `volume_supported`, full_search_pallas.py:1781): MSE/SAD, span >= 1,
    and blk <= 16 or a phase-kernel config."""
    return (
        metric in _METRIC_CODE
        and span >= 1
        and (blk_dim <= 16 or phase_supported(blk_dim, span, metric))
    )


def check_operand_shapes(cur, ref_halo, span):
    """Raise unless cur and ref_halo are 2-D, on one device, and the halo
    covers the tile plus `span` on every side."""
    if cur.dim() != 2 or ref_halo.dim() != 2:
        raise ValueError("cur and ref_halo must be 2-D")
    tile_h, tile_w = cur.shape
    if (
        ref_halo.shape[0] < tile_h + 2 * span
        or ref_halo.shape[1] < tile_w + 2 * span
    ):
        raise ValueError(
            f"ref_halo {tuple(ref_halo.shape)} must cover "
            f"({tile_h + 2 * span}, {tile_w + 2 * span})"
        )
    if cur.device != ref_halo.device:
        raise ValueError(
            f"cur on {cur.device} but ref_halo on {ref_halo.device}"
        )


def _check_operands(cur, ref_halo, span, metric):
    if metric not in _METRIC_CODE:
        raise ValueError(f"metric must be 'mse' or 'sad', got {metric!r}")
    check_operand_shapes(cur, ref_halo, span)


def check_kernel_operands(cur, ref_halo):
    """Raise unless both tensors are CUDA uint8 with unit column stride,
    the layout every kernel reads."""
    if cur.device.type != "cuda":
        raise ValueError(f"expected CUDA or CPU tensors, got {cur.device}")
    for name, t in (("cur", cur), ("ref_halo", ref_halo)):
        if t.dtype != torch.uint8 or t.stride(1) != 1:
            raise ValueError(
                f"{name} must be uint8 with unit column stride, got "
                f"{t.dtype} strides {t.stride()}"
            )


def check_interior_tile(shape, blk_dim, frame_height, frame_width,
                        y_origin, x_origin):
    """Raise unless the tile is whole blocks lying inside the frame."""
    tile_h, tile_w = shape
    if (
        tile_h % blk_dim or tile_w % blk_dim
        or min(y_origin, x_origin) < 0
        or y_origin + tile_h > frame_height
        or x_origin + tile_w > frame_width
    ):
        raise ValueError(
            f"the interior kernels cover whole in-frame blocks only: tile "
            f"{tile_h}x{tile_w} at ({y_origin}, {x_origin}), blk_dim "
            f"{blk_dim}, frame {frame_height}x{frame_width}"
        )


def check_edge_tile(shape, blk_dim, frame_height, frame_width, y_origin,
                    x_origin):
    """Raise unless the tile holds every in-frame pixel of its blocks."""
    tile_h, tile_w = shape
    if min(y_origin, x_origin) < 0 or (
        tile_h % blk_dim and y_origin + tile_h < frame_height
    ) or (tile_w % blk_dim and x_origin + tile_w < frame_width):
        raise ValueError(
            f"tile {tile_h}x{tile_w} at ({y_origin}, {x_origin}) cuts "
            f"blocks of side {blk_dim} inside the frame "
            f"{frame_height}x{frame_width}"
        )


def _launch(fn, cur, ref_halo, nby, nbx, *, blk_dim, span, metric,
            frame_height, frame_width, y_origin, x_origin, volume=None):
    """Run a CUDA launcher on a CUDA tensor pair. `volume`, an int32
    [K², nby, nbx] tensor or None, goes to the launchers that emit one;
    `metric` to those that take one (phase and int kernels)."""
    check_kernel_operands(cur, ref_halo)
    cost = torch.empty((nby, nbx), dtype=torch.int32, device=cur.device)
    idx = torch.empty((nby, nbx), dtype=torch.int32, device=cur.device)
    ptrs = [cur.data_ptr(), ref_halo.data_ptr(), cost.data_ptr(),
            idx.data_ptr()]
    if fn.__name__ in _EMITTERS:
        ptrs.append(None if volume is None else volume.data_ptr())
    ints = [cur.stride(0), ref_halo.stride(0), nbx, nby, nbx, blk_dim, span]
    if fn.__name__ in _TAKE_METRIC:
        ints.append(_METRIC_CODE[metric])
    ints += [frame_height, frame_width, y_origin, x_origin]
    with torch.cuda.device(cur.device):
        err = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{fn.__name__} failed with CUDA error {err} "
            f"(blk_dim={blk_dim} span={span} grid={nby}x{nbx})"
        )
    return cost, idx


def search_plain(cur, ref_halo, *, blk_dim: int, span: int, metric: str,
                 frame_height: int, frame_width: int, y_origin: int = 0,
                 x_origin: int = 0, return_volume: bool = False):
    """Plain PyTorch version of every kernel here over the same operands.

    Block grid cdiv(tile, blk_dim), truncated extents from the frame, the
    raster scan with strict `<` from (INT32_MAX, centre). For the full
    in-frame blocks the interior kernels accept, the truncated extents are
    full and this is their arithmetic too (the chunked and wide kernels'
    (Qcur - X) + (Qref - X) is the same integer SSD). Returns int32 (cost,
    idx), plus the [K², nby, nbx] volume with `return_volume`.
    """
    _check_operands(cur, ref_halo, span, metric)
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
        blk_dim=blk_dim, span=span, metric=metric,
    )
    return fs.scan_argmin(cost_fn, span, (nby, nbx), cur.device,
                          return_volume=return_volume)


def count_launch(wrapper, volume) -> None:
    """Count one launch of `wrapper`'s kernel, in emit mode when `volume`
    is not None."""
    wrapper.launches += 1
    if volume is not None:
        wrapper.volume_launches += 1


def _interior(wrapper, source, cur, ref_halo, *, return_volume=False, **kw):
    """An interior wrapper's body: the plain version for CPU tensors, else
    one launch of `wrapper`'s kernel, the launcher `me_<wrapper name>` of
    csrc/<source>.cu, counted by `count_launch`."""
    check_interior_tile(cur.shape, kw["blk_dim"], kw["frame_height"],
                        kw["frame_width"], kw["y_origin"], kw["x_origin"])
    if cur.device.type == "cpu":
        return search_plain(cur, ref_halo, return_volume=return_volume, **kw)
    blk, k = kw["blk_dim"], 2 * kw["span"] + 1
    nby, nbx = cur.shape[0] // blk, cur.shape[1] // blk
    volume = (torch.empty((k * k, nby, nbx), dtype=torch.int32,
                          device=cur.device) if return_volume else None)
    if nby == 0 or nbx == 0:
        out = tuple(torch.empty((nby, nbx), dtype=torch.int32,
                                device=cur.device) for _ in range(2))
    else:
        fn = getattr(_lib(source), f"me_{wrapper.__name__}")
        out = _launch(fn, cur, ref_halo, nby, nbx, volume=volume, **kw)
        count_launch(wrapper, volume)
    return (*out, volume) if return_volume else out


def phase_search(cur, ref_halo, *, blk_dim: int, span: int, metric: str,
                 frame_height: int, frame_width: int, y_origin: int = 0,
                 x_origin: int = 0, return_volume: bool = False):
    """Exact search of full interior blocks (`me_phase_search`, the port of
    `_kernel_phase`), on the chunked kernel's warp-per-macroblock body with
    an SSD or SAD cost. Every block of the tile must lie inside the frame;
    returns int32 (cost, idx), [tile_h // blk_dim, tile_w // blk_dim], and
    with `return_volume` the int32 [K², nby, nbx] cost volume (INT32_MAX at
    invalid candidates; the kernel's emit mode)."""
    _check_operands(cur, ref_halo, span, metric)
    if not phase_supported(blk_dim, span, metric):
        raise ValueError(
            f"phase kernel requires blk_dim in {_PHASE_BLOCKS} and span >= 1, "
            f"got blk_dim={blk_dim} span={span}"
        )
    return _interior(
        phase_search, "full_search", cur, ref_halo, blk_dim=blk_dim,
        span=span, metric=metric, frame_height=frame_height,
        frame_width=frame_width, y_origin=y_origin, x_origin=x_origin,
        return_volume=return_volume,
    )


phase_search.launches = phase_search.volume_launches = 0


def _check_mse(metric, kernel):
    if metric != "mse":
        raise ValueError(f"{kernel} searches MSE only, got metric {metric!r}")


def chunked_search(cur, ref_halo, *, blk_dim: int, span: int,
                   frame_height: int, frame_width: int, y_origin: int = 0,
                   x_origin: int = 0, metric: str = "mse",
                   return_volume: bool = False):
    """MSE search of full interior blocks by hoisted box sums
    (`me_chunked_search`, the port of `_kernel_f32`): blk 1..16, span >= 0,
    operands staged as packed bytes, a warp per macroblock and its lanes
    over the macroblock's candidates. Returns int32 (cost, idx),
    and with `return_volume` the int32 [K², nby, nbx] cost volume
    (INT32_MAX at invalid candidates; the kernel's emit mode)."""
    _check_mse(metric, "me_chunked_search")
    _check_operands(cur, ref_halo, span, metric)
    if not chunked_supported(blk_dim, span):
        raise ValueError(
            f"chunked kernel requires 1 <= blk_dim <= 16 and span >= 0, got "
            f"blk_dim={blk_dim} span={span}"
        )
    return _interior(
        chunked_search, "chunked", cur, ref_halo, blk_dim=blk_dim,
        span=span, metric=metric, frame_height=frame_height,
        frame_width=frame_width, y_origin=y_origin, x_origin=x_origin,
        return_volume=return_volume,
    )


chunked_search.launches = chunked_search.volume_launches = 0


def occupancy(launcher, *args: int) -> dict:
    """A search instance's resources on the current card, from its ctypes
    launcher `me_<...>_occupancy(*args, out)`: registers and local (spill)
    bytes per thread, dynamic shared memory and macroblocks per CUDA block,
    and the CUDA blocks and warps resident per SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`). Needs a card."""
    out = (ctypes.c_int * 5)()
    err = launcher(*args, out)
    if err != 0:
        raise RuntimeError(f"{launcher.__name__} failed with CUDA error {err}")
    regs, local, smem, tbx, blocks = out
    return dict(registers=regs, local_bytes=local, smem_bytes=smem, tbx=tbx,
                blocks_per_sm=blocks,
                warps_per_sm=blocks * 4)  # 128 threads per CUDA block


def chunked_occupancy(blk_dim: int, span: int, nbx: int) -> dict:
    """`me_chunked_search`'s resources (`occupancy`) for a grid of `nbx`
    macroblocks a row."""
    if not chunked_supported(blk_dim, span) or nbx < 1:
        raise ValueError(f"no chunked kernel for blk_dim={blk_dim} "
                         f"span={span} nbx={nbx}")
    return occupancy(_lib("chunked").me_chunked_occupancy, blk_dim, span,
                     nbx)


def phase_occupancy(blk_dim: int, span: int, metric: str, nbx: int) -> dict:
    """`me_phase_search`'s resources (`occupancy`, no volume) for a grid
    of `nbx` macroblocks a row."""
    if not phase_supported(blk_dim, span, metric) or nbx < 1:
        raise ValueError(f"no phase kernel for blk_dim={blk_dim} "
                         f"span={span} metric={metric!r} nbx={nbx}")
    return occupancy(_lib("full_search").me_phase_occupancy, blk_dim, span,
                     _METRIC_CODE[metric], nbx)


def int_occupancy(blk_dim: int, span: int, metric: str, nby: int,
                  nbx: int) -> dict:
    """`me_int_search`'s resources (`occupancy`, no volume) for an [nby,
    nbx] grid."""
    if metric not in _METRIC_CODE or min(blk_dim, nby, nbx) < 1 or span < 0:
        raise ValueError(f"no int kernel for blk_dim={blk_dim} span={span} "
                         f"metric={metric!r} grid={nby}x{nbx}")
    return occupancy(_lib("int_search").me_int_occupancy, blk_dim, span,
                     _METRIC_CODE[metric], nby, nbx)


def wide_occupancy(blk_dim: int, span: int, nbx: int) -> dict:
    """`me_wide_search`'s resources (`occupancy`) for a grid of `nbx`
    macroblocks a row."""
    if not wide_supported(blk_dim, span) or nbx < 1:
        raise ValueError(f"no wide kernel for blk_dim={blk_dim} "
                         f"span={span} nbx={nbx}")
    return occupancy(_lib("chunked").me_wide_occupancy, blk_dim, span, nbx)


def chunked_u8_search(cur, ref_halo, *, blk_dim: int, span: int,
                      frame_height: int, frame_width: int, y_origin: int = 0,
                      x_origin: int = 0, metric: str = "mse"):
    """`chunked_search`'s search without a volume (`me_chunked_u8_search`,
    the port of `_kernel_f32_bf16`, whose operands are staged at half width
    on the TPU): every kernel here reads packed bytes, four to a 32-bit
    word, so it launches K5's own instance. Returns int32 (cost, idx)."""
    _check_mse(metric, "me_chunked_u8_search")
    _check_operands(cur, ref_halo, span, metric)
    if not chunked_supported(blk_dim, span):
        raise ValueError(
            f"chunked kernel requires 1 <= blk_dim <= 16 and span >= 0, got "
            f"blk_dim={blk_dim} span={span}"
        )
    return _interior(
        chunked_u8_search, "chunked", cur, ref_halo, blk_dim=blk_dim,
        span=span, metric=metric, frame_height=frame_height,
        frame_width=frame_width, y_origin=y_origin, x_origin=x_origin,
    )


chunked_u8_search.launches = 0


def wide_search(cur, ref_halo, *, blk_dim: int, span: int,
                frame_height: int, frame_width: int, y_origin: int = 0,
                x_origin: int = 0, metric: str = "mse"):
    """MSE search of full interior blocks at blk 24 and 32 (`me_wide_search`,
    the port of `_kernel_f32_wide`): the chunked kernel's body, with the
    block's words read from shared memory. Returns int32 (cost, idx)."""
    _check_mse(metric, "me_wide_search")
    _check_operands(cur, ref_halo, span, metric)
    if not wide_supported(blk_dim, span):
        raise ValueError(
            f"wide kernel requires blk_dim % 8 == 0 with 16 < blk_dim <= 32 "
            f"and span >= 0, got blk_dim={blk_dim} span={span}"
        )
    return _interior(
        wide_search, "chunked", cur, ref_halo, blk_dim=blk_dim, span=span,
        metric=metric, frame_height=frame_height, frame_width=frame_width,
        y_origin=y_origin, x_origin=x_origin,
    )


wide_search.launches = 0


def int_search(cur, ref_halo, *, blk_dim: int, span: int, metric: str,
               frame_height: int, frame_width: int, y_origin: int = 0,
               x_origin: int = 0, return_volume: bool = False):
    """Exact search with truncated block extents (`me_int_search`, the
    port of `_kernel_int`): packed bytes, a warp per macroblock over its
    valid candidates, warps sharing a macroblock on thin slabs. The tile
    must hold every in-frame pixel of its blocks; returns int32 (cost,
    idx), [cdiv(tile_h, blk), cdiv(tile_w, blk)], and with `return_volume`
    the int32 [K², nby, nbx] cost volume (INT32_MAX at invalid candidates;
    the kernel's emit mode)."""
    _check_operands(cur, ref_halo, span, metric)
    check_edge_tile(cur.shape, blk_dim, frame_height, frame_width, y_origin,
                    x_origin)
    tile_h, tile_w = cur.shape
    kw = dict(blk_dim=blk_dim, span=span, metric=metric,
              frame_height=frame_height, frame_width=frame_width,
              y_origin=y_origin, x_origin=x_origin)
    if cur.device.type == "cpu":
        return search_plain(cur, ref_halo, return_volume=return_volume, **kw)
    nby, nbx = geometry.grid_shape(tile_h, tile_w, blk_dim)
    k = 2 * span + 1
    volume = (torch.empty((k * k, nby, nbx), dtype=torch.int32,
                          device=cur.device) if return_volume else None)
    if nby == 0 or nbx == 0:
        out = tuple(torch.empty((nby, nbx), dtype=torch.int32,
                                device=cur.device) for _ in range(2))
    else:
        out = _launch(_lib("int_search").me_int_search, cur, ref_halo, nby,
                      nbx, volume=volume, **kw)
        count_launch(int_search, volume)
    return (*out, volume) if return_volume else out


int_search.launches = int_search.volume_launches = 0


def bottom_slab(cur, ref_halo, blk_dim: int, span: int):
    """(cur rows, halo rows, y_org): the views of a whole frame's last
    block row, rows [y_org, H), and the reference halo it reaches."""
    h, w = cur.shape
    y_org = (geometry.cdiv(h, blk_dim) - 1) * blk_dim
    return cur[y_org:], ref_halo[y_org : h + 2 * span, : w + 2 * span], y_org


def right_slab(cur, ref_halo, blk_dim: int, span: int):
    """(cur columns, halo columns, x_org): the views of a whole frame's last
    block column, columns [x_org, W), and the reference halo it reaches."""
    h, w = cur.shape
    x_org = (geometry.cdiv(w, blk_dim) - 1) * blk_dim
    return (cur[:, x_org:], ref_halo[: h + 2 * span, x_org : w + 2 * span],
            x_org)


def frame_of(cur, frame_height, frame_width):
    """(frame_height, frame_width), each defaulting to `cur`'s extent: an
    edge slab's frame is its whole-frame operand unless a tile names its
    global frame."""
    h, w = cur.shape
    return (h if frame_height is None else frame_height,
            w if frame_width is None else frame_width)


def _edge_slab_bottom(cur, ref_halo, *, blk_dim: int, span: int, metric: str,
                      return_volume: bool = False, frame_height=None,
                      frame_width=None, y_origin: int = 0, x_origin: int = 0):
    """Exact search of the last (truncated) block row: `int_search` on the
    slab of rows [y_org, H) (the port of `_edge_slab_bottom`, :1953), of
    the whole frame `cur` or of a tile at (y_origin, x_origin) of a larger
    frame. Returns [1, nbx] block grids (and a [K², 1, nbx] volume)."""
    cur_s, halo_s, y_org = bottom_slab(cur, ref_halo, blk_dim, span)
    h, w = frame_of(cur, frame_height, frame_width)
    return int_search(
        cur_s, halo_s, blk_dim=blk_dim, span=span, metric=metric,
        frame_height=h, frame_width=w, y_origin=y_origin + y_org,
        x_origin=x_origin, return_volume=return_volume,
    )


def _edge_slab_right(cur, ref_halo, *, blk_dim: int, span: int, metric: str,
                     return_volume: bool = False, frame_height=None,
                     frame_width=None, y_origin: int = 0, x_origin: int = 0):
    """Exact search of the last (truncated) block column: `int_search` on
    the slab of columns [x_org, W) (the port of `_edge_slab_right`,
    :1985), of the whole frame or of a tile as `_edge_slab_bottom`.
    Returns [nby, 1] block grids (and a [K², nby, 1] volume)."""
    cur_s, halo_s, x_org = right_slab(cur, ref_halo, blk_dim, span)
    h, w = frame_of(cur, frame_height, frame_width)
    return int_search(
        cur_s, halo_s, blk_dim=blk_dim, span=span, metric=metric,
        frame_height=h, frame_width=w, y_origin=y_origin,
        x_origin=x_origin + x_org, return_volume=return_volume,
    )


def as_u8(frame: torch.Tensor) -> torch.Tensor:
    """uint8 frames pass; other integer frames are cast after a range check
    (the kernels read bytes)."""
    if frame.dtype == torch.uint8:
        return frame
    if frame.is_floating_point() or frame.is_complex() or frame.dtype == torch.bool:
        raise TypeError(f"frames must be integer pixels, got {frame.dtype}")
    if frame.numel() and (int(frame.min()) < 0 or int(frame.max()) > 255):
        raise ValueError("frame pixels must lie in [0, 255]")
    return frame.to(torch.uint8)


def frame_operands(cur, ref, span: int, device: torch.device):
    """(cur, ref_halo) uint8 tensors on `device` for a whole-frame search:
    the current frame and the reference zero-padded by `span` all round."""
    cur_t = as_u8(to_tensor(cur, device))
    ref_t = as_u8(to_tensor(ref, device))
    if cur_t.shape != ref_t.shape or cur_t.dim() != 2:
        raise ValueError(
            f"current and reference frames must be 2-D of identical shapes, "
            f"got {tuple(cur_t.shape)} vs {tuple(ref_t.shape)}"
        )
    return cur_t, F.pad(ref_t, (span, span, span, span))


def search_interior_and_edges(cur, ref_halo, interior, edge_bottom,
                              edge_right, *, blk_dim: int, span: int,
                              frame_height=None, frame_width=None,
                              y_origin: int = 0, x_origin: int = 0, **kw):
    """The results of a whole frame, each [..., nby, nbx]: `interior` on its
    whole blocks, then `edge_bottom` on the truncated last block row and
    `edge_right` on the truncated last block column, which overwrites the
    corner, as the JAX frame functions merge their result grids
    (full_search_pallas.py:1595-1608, ssim_pallas.py:661-676) and volumes
    (:1922-1949, ssim_pallas.py:852-874). With `return_volume=True` in `kw`
    the last result is the [K², nby, nbx] volume.

    `cur` may also be the in-frame part of a shard tile at (y_origin,
    x_origin), block-aligned, of a frame_height x frame_width frame: its
    rows and columns then end at the tile's edge or at the frame's, and
    only a tile that holds the frame's last block row or column has a
    truncated one."""
    frame = frame_of(cur, frame_height, frame_width)
    h, w = cur.shape
    nby, nbx = geometry.grid_shape(h, w, blk_dim)
    nyf, nxf = h // blk_dim, w // blk_dim
    where = dict(frame_height=frame[0], frame_width=frame[1],
                 y_origin=y_origin, x_origin=x_origin)
    inner = interior(
        cur[: nyf * blk_dim, : nxf * blk_dim], ref_halo, blk_dim=blk_dim,
        span=span, **where, **kw,
    )
    if (nyf, nxf) == (nby, nbx):
        return list(inner)
    out = [torch.empty((*g.shape[:-2], nby, nbx), dtype=g.dtype,
                       device=g.device) for g in inner]
    for o, g in zip(out, inner):
        o[..., :nyf, :nxf] = g
    if h % blk_dim:
        for o, g in zip(out, edge_bottom(cur, ref_halo, blk_dim=blk_dim,
                                         span=span, **where, **kw)):
            o[..., nby - 1, :] = g[..., 0, :]
    if w % blk_dim:
        for o, g in zip(out, edge_right(cur, ref_halo, blk_dim=blk_dim,
                                        span=span, **where, **kw)):
            o[..., :, nbx - 1] = g[..., :, 0]
    return out


def interior_search(blk_dim: int, span: int, metric: str,
                    phase: bool | None = None, operand_bf16: bool = False):
    """The interior wrapper a whole-frame search takes, as
    `_full_search_frame_jit` routes (full_search_pallas.py:1490-1533): the
    phase kernel where `phase` (default: wherever it applies); otherwise,
    for MSE, the chunked kernel at blk <= 16 (its packed-byte variant with
    `operand_bf16`) or the wide kernel at blk 24 and 32. None means the int
    kernel over the whole frame (SAD outside the phase kernel, MSE at other
    blk)."""
    if phase_supported(blk_dim, span, metric) if phase is None else phase:
        return phase_search
    if metric != "mse":
        return None
    if chunked_supported(blk_dim, span):
        return chunked_u8_search if operand_bf16 else chunked_search
    if wide_supported(blk_dim, span):
        return wide_search
    return None


def full_search_frame_cuda(cur, ref, *, blk_dim: int, span: int,
                           metric: str = "mse", phase: bool | None = None,
                           operand_bf16: bool = False,
                           device=None) -> fs.MotionField:
    """Whole-frame full search (MSE or SAD) on the CUDA kernels.

    Bit-exact vs `search.full_search_frame`: identical MVs, integer costs
    and float32 scores. cur/ref: [H, W] integer frames (numpy or torch),
    moved to `device` (default "cuda"; "cpu" runs the plain versions).

    Routing follows `_full_search_frame_jit` (full_search_pallas.py:1490),
    with its two arguments that choose a kernel (`interior_search`): the
    interior kernel on the whole blocks, then the int kernel on the
    truncated bottom row and right column (which overwrites the corner);
    the int kernel over the whole frame where no interior kernel applies.
    `phase=True` where the phase kernel does not apply raises ValueError, as
    there. `operand_bf16` keeps the JAX name: it selects the packed-byte
    chunked kernel, and no bfloat16 is involved. The JAX function's `tile`,
    `unroll_dx` and `chunk_dx` schedule its TPU kernels and change no
    result; they have no counterpart here. metric="ssim" raises ValueError,
    as `full_search_frame_pallas` does: SSIM lives in kernels/ssim_cuda.py.
    """
    dev = resolve_device(device)
    if metric == "ssim":
        raise ValueError(_SSIM_ELSEWHERE)
    if metric not in _METRIC_CODE:
        raise ValueError(f"metric must be 'mse' or 'sad', got {metric!r}")
    if phase and not phase_supported(blk_dim, span, metric):
        raise ValueError(
            f"phase kernel requires metric mse/sad, blk_dim in "
            f"{_PHASE_BLOCKS} and span >= 1; got blk_dim={blk_dim} "
            f"span={span} metric={metric!r}"
        )
    cur_t, ref_halo = frame_operands(cur, ref, span, dev)
    interior = interior_search(blk_dim, span, metric, phase, operand_bf16)
    h, w = cur_t.shape
    nby, nbx = geometry.grid_shape(h, w, blk_dim)
    kw = dict(blk_dim=blk_dim, span=span, metric=metric)
    if interior is None:
        cost, idx = int_search(
            cur_t, ref_halo, frame_height=h, frame_width=w, **kw
        )
    else:
        cost, idx = search_interior_and_edges(
            cur_t, ref_halo, interior, _edge_slab_bottom, _edge_slab_right,
            **kw,
        )
    _, _, blk_h, blk_w = geometry.block_extents(
        0, 0, nby, nbx, blk_dim, h, w, dev
    )
    return fs.field_from_argmin(cost, idx, blk_h * blk_w, span, metric)


def _volume_interior(blk_dim: int, span: int, metric: str):
    """The interior kernel whose emit mode covers a config's whole blocks
    (phase, else chunked for MSE at blk <= 16), or None: the int kernel's
    emit mode then takes every block."""
    if phase_supported(blk_dim, span, metric):
        return phase_search
    if metric == "mse" and chunked_supported(blk_dim, span):
        return chunked_search
    return None


def full_search_volume_cuda(cur, ref, *, blk_dim: int, span: int,
                            metric: str = "mse", device=None) -> torch.Tensor:
    """Whole-frame int32 [K², nby, nbx] cost volume (MSE: SSD, or SAD),
    INT32_MAX at every invalid candidate; equal entry for entry to the
    golden `full_search_frame(..., return_cost_volume=True)`.

    The port of `full_search_volume_pallas` (full_search_pallas.py:1796).
    Every part comes from a kernel's emit mode: the phase kernel's on the
    whole blocks of a phase config, the chunked kernel's for MSE at other
    blk <= 16, then the int kernel's on the truncated last block row and
    column (bottom, then right). Where no interior kernel applies (SAD at
    blk 3, 5, 6, 7, 9-15) the int kernel's emit mode covers the whole
    frame. The JAX package computes those slabs and configs with its golden
    tile search in XLA; here that search is the emit modes' plain version
    and runs only for CPU tensors. Unsupported configs (`volume_supported`)
    raise ValueError.
    """
    if not volume_supported(blk_dim, span, metric):
        raise ValueError(
            f"full_search_volume_cuda: unsupported config blk_dim={blk_dim} "
            f"span={span} metric={metric!r} (needs MSE/SAD, span >= 1, and "
            f"blk_dim <= 16 or a phase-kernel config)"
        )
    cur_t, ref_halo = frame_operands(cur, ref, span, resolve_device(device))
    h, w = cur_t.shape
    kw = dict(blk_dim=blk_dim, span=span, metric=metric, return_volume=True)
    interior = _volume_interior(blk_dim, span, metric)
    if interior is None:
        return int_search(cur_t, ref_halo, frame_height=h, frame_width=w,
                          **kw)[2]
    return search_interior_and_edges(
        cur_t, ref_halo, interior, _edge_slab_bottom, _edge_slab_right, **kw,
    )[2]


def check_shard_tile(shape, blk_dim, y_origin, x_origin):
    """Raise unless a shard tile is whole blocks at a non-negative
    origin, as the mesh padding makes every tile."""
    tile_h, tile_w = shape
    if tile_h % blk_dim or tile_w % blk_dim or min(y_origin, x_origin) < 0:
        raise ValueError(
            f"shard tile {tile_h}x{tile_w} at ({y_origin}, {x_origin}) must "
            f"be whole blocks of side {blk_dim} at a non-negative origin"
        )


def shard_tile(cur_tile, ref_halo, search, outputs, *, blk_dim: int,
               frame_height: int, frame_width: int, y_origin: int,
               x_origin: int):
    """A shard tile's result grids, each [*lead, th // blk, tw // blk].

    The mesh pads the frame to whole tiles, so a tile at (y_origin,
    x_origin) may reach past the frame. `search(cur, ref_halo)` runs on the
    tile's in-frame part (rows and columns up to the frame's edge: its
    whole blocks and, where the tile holds them, the frame's truncated last
    block row and column) and returns grids over the blocks that touch the
    frame. Blocks wholly in the padding launch nothing: `outputs`, one
    (lead shape, dtype, fill) per result, gives their fixed values. Only
    the grids' in-frame blocks are contract, as in the JAX package.
    """
    tile_h, tile_w = cur_tile.shape
    check_shard_tile(cur_tile.shape, blk_dim, y_origin, x_origin)
    h_in = max(0, min(tile_h, frame_height - y_origin))
    w_in = max(0, min(tile_w, frame_width - x_origin))
    nby, nbx = tile_h // blk_dim, tile_w // blk_dim
    nyi, nxi = geometry.cdiv(h_in, blk_dim), geometry.cdiv(w_in, blk_dim)
    found = search(cur_tile[:h_in, :w_in], ref_halo) if nyi and nxi else ()
    if (nyi, nxi) == (nby, nbx):
        return tuple(found)
    out = tuple(torch.full((*lead, nby, nbx), fill, dtype=dtype,
                           device=cur_tile.device)
                for lead, dtype, fill in outputs)
    for o, g in zip(out, found):
        o[..., :nyi, :nxi] = g
    return out


def _tile_search(cur_tile, ref_halo, y_origin, x_origin, interior, outputs,
                 *, blk_dim, span, metric, frame_height, frame_width,
                 return_volume=False):
    """`shard_tile` with the MSE/SAD kernels: `interior` and the int
    kernel's slabs on the in-frame part, or the int kernel over all of it
    where `interior` is None."""
    _check_operands(cur_tile, ref_halo, span, metric)
    where = dict(frame_height=frame_height, frame_width=frame_width,
                 y_origin=y_origin, x_origin=x_origin)
    kw = dict(blk_dim=blk_dim, span=span, metric=metric, **where)
    if return_volume:  # the wide and packed-byte kernels emit none
        kw["return_volume"] = True

    def search(cur, halo):
        if interior is None:
            return int_search(cur, halo, **kw)
        return search_interior_and_edges(
            cur, halo, interior, _edge_slab_bottom, _edge_slab_right, **kw)

    return shard_tile(cur_tile, ref_halo, search, outputs, blk_dim=blk_dim,
                      **where)


def full_search_tile_cuda(cur_tile, ref_halo, y_origin: int, x_origin: int,
                          *, frame_height: int, frame_width: int,
                          blk_dim: int, span: int, metric: str = "mse"):
    """Full search (MSE or SAD) over one mesh shard's tile (the port of
    `full_search_tile_pallas`, full_search_pallas.py:1621).

    cur_tile: uint8 [th, tw], whole blocks, global pixel (y_origin,
    x_origin) at [0, 0]; ref_halo: uint8 [th + 2*span, tw + 2*span], the
    exchanged reference halo (`parallel.halo.halo_exchange_2d`), zero
    outside the frame. The kernels are routed as `full_search_frame_cuda`
    routes a frame (`interior_search`), on the tile's in-frame part
    (`shard_tile`). Unlike the JAX entry, which takes phase configs only
    and leaves the truncated edge to a golden pass outside the mesh, this
    one covers every config and the truncated edge itself (the int
    kernel). Returns int32 (cost, flat idx), [th // blk, tw // blk]; blocks
    wholly outside the frame hold (INT32_MAX, centre index).
    """
    k = 2 * span + 1
    return _tile_search(
        cur_tile, ref_halo, y_origin, x_origin,
        interior_search(blk_dim, span, metric),
        [((), torch.int32, 2**31 - 1), ((), torch.int32, span * k + span)],
        blk_dim=blk_dim, span=span, metric=metric, frame_height=frame_height,
        frame_width=frame_width,
    )


def full_search_volume_tile_cuda(cur_tile, ref_halo, y_origin: int,
                                 x_origin: int, *, frame_height: int,
                                 frame_width: int, blk_dim: int, span: int,
                                 metric: str = "mse"):
    """Per-shard int32 [K², th // blk, tw // blk] cost volume (the port of
    `full_search_volume_tile_pallas`, full_search_pallas.py:1703), operands
    as `full_search_tile_cuda`. Every entry comes from an emit mode: the
    phase kernel's (phase configs) or the chunked kernel's (MSE at other
    blk <= 16) on the whole in-frame blocks and the int kernel's on the
    truncated edge, or the int kernel's on every block. INT32_MAX at
    invalid candidates and on blocks wholly outside the frame. The staged
    sharded diamond reads it (`search.diamond.diamond_search_tile`)."""
    k = 2 * span + 1
    return _tile_search(
        cur_tile, ref_halo, y_origin, x_origin,
        _volume_interior(blk_dim, span, metric),
        [((), torch.int32, 2**31 - 1), ((), torch.int32, span * k + span),
         ((k * k,), torch.int32, 2**31 - 1)],
        blk_dim=blk_dim, span=span, metric=metric, frame_height=frame_height,
        frame_width=frame_width, return_volume=True,
    )[2]
