"""Fused full search (MSE/SAD) on the CUDA kernels of csrc/full_search.cu.

The PyTorch counterpart of `motionestimation_tpu.kernels.full_search_pallas`
on the main path:

* `phase_search` launches `me_phase_search`, the port of the Pallas kernel
  `_kernel_phase` (full_search_pallas.py:729): all full interior blocks,
  blk in {1, 2, 4, 8, 16, 32}, span >= 1.
* `int_search` launches `me_int_search`, the port of `_kernel_int`
  (:1076): blocks with truncated extents, any blk.
* `full_search_frame_cuda` (the port of `full_search_frame_pallas`, :1415)
  runs the interior, then the bottom and right edge slabs, merges them in
  the same order, decodes MVs and scores.

Beside the two kernels stands their plain PyTorch version, `search_plain`,
built on `search.full_search.make_displacement_cost` over the same inputs
and output layout. A wrapper takes the plain version only for tensors on
the CPU; for CUDA tensors it launches its kernel or raises. Each wrapper
counts its launches in its `launches` attribute.

Operands (both wrappers):
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
_CHUNKED_MSE = (
    "MSE with blk_dim={blk} span={span} runs the Pallas kernel {kernel} "
    "in the JAX package; its CUDA port is ROADMAP.md Queue 1 item 6 (cost "
    "volumes and the chunked MSE kernels K5-K7)"
)

_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("full_search")
    for fn in (lib.me_phase_search, lib.me_int_search):
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return lib


def phase_supported(blk_dim: int, span: int, metric: str) -> bool:
    """Whether the phase kernel covers this config (as `_phase_supported`,
    full_search_pallas.py:1402): MSE/SAD, blk dividing 128 and <= 32,
    span >= 1."""
    return metric in _METRIC_CODE and blk_dim in _PHASE_BLOCKS and span >= 1


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
            frame_height, frame_width, y_origin, x_origin):
    """Run one of the two CUDA launchers on a CUDA tensor pair."""
    check_kernel_operands(cur, ref_halo)
    cost = torch.empty((nby, nbx), dtype=torch.int32, device=cur.device)
    idx = torch.empty((nby, nbx), dtype=torch.int32, device=cur.device)
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            cur.data_ptr(), ref_halo.data_ptr(),
            cost.data_ptr(), idx.data_ptr(),
            cur.stride(0), ref_halo.stride(0), nbx, nby, nbx,
            blk_dim, span, _METRIC_CODE[metric],
            frame_height, frame_width, y_origin, x_origin, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{fn.__name__} failed with CUDA error {err} "
            f"(blk_dim={blk_dim} span={span} grid={nby}x{nbx})"
        )
    return cost, idx


def search_plain(cur, ref_halo, *, blk_dim: int, span: int, metric: str,
                 frame_height: int, frame_width: int, y_origin: int = 0,
                 x_origin: int = 0):
    """Plain PyTorch version of both kernels over the same operands.

    Block grid cdiv(tile, blk_dim), truncated extents from the frame, the
    raster scan with strict `<` from (INT32_MAX, centre). For the full
    in-frame blocks `phase_search` accepts, the truncated extents are full
    and this is the phase kernel's arithmetic too.
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
    return fs.scan_argmin(cost_fn, span, (nby, nbx), cur.device)


def phase_search(cur, ref_halo, *, blk_dim: int, span: int, metric: str,
                 frame_height: int, frame_width: int, y_origin: int = 0,
                 x_origin: int = 0):
    """Exact search of full interior blocks (`me_phase_search`, the port of
    `_kernel_phase`). Every block of the tile must lie inside the frame;
    returns int32 (cost, idx), [tile_h // blk_dim, tile_w // blk_dim]."""
    _check_operands(cur, ref_halo, span, metric)
    if not phase_supported(blk_dim, span, metric):
        raise ValueError(
            f"phase kernel requires blk_dim in {_PHASE_BLOCKS} and span >= 1, "
            f"got blk_dim={blk_dim} span={span}"
        )
    check_interior_tile(cur.shape, blk_dim, frame_height, frame_width,
                        y_origin, x_origin)
    tile_h, tile_w = cur.shape
    kw = dict(blk_dim=blk_dim, span=span, metric=metric,
              frame_height=frame_height, frame_width=frame_width,
              y_origin=y_origin, x_origin=x_origin)
    if cur.device.type == "cpu":
        return search_plain(cur, ref_halo, **kw)
    nby, nbx = tile_h // blk_dim, tile_w // blk_dim
    if nby == 0 or nbx == 0:
        empty = torch.empty((nby, nbx), dtype=torch.int32, device=cur.device)
        return empty, empty.clone()
    out = _launch(_lib().me_phase_search, cur, ref_halo, nby, nbx, **kw)
    phase_search.launches += 1
    return out


phase_search.launches = 0


def int_search(cur, ref_halo, *, blk_dim: int, span: int, metric: str,
               frame_height: int, frame_width: int, y_origin: int = 0,
               x_origin: int = 0):
    """Exact search with truncated block extents (`me_int_search`, the
    port of `_kernel_int`). The tile must hold every in-frame pixel of its
    blocks; returns int32 (cost, idx), [cdiv(tile_h, blk), cdiv(tile_w, blk)]."""
    _check_operands(cur, ref_halo, span, metric)
    check_edge_tile(cur.shape, blk_dim, frame_height, frame_width, y_origin,
                    x_origin)
    tile_h, tile_w = cur.shape
    kw = dict(blk_dim=blk_dim, span=span, metric=metric,
              frame_height=frame_height, frame_width=frame_width,
              y_origin=y_origin, x_origin=x_origin)
    if cur.device.type == "cpu":
        return search_plain(cur, ref_halo, **kw)
    nby, nbx = geometry.grid_shape(tile_h, tile_w, blk_dim)
    if nby == 0 or nbx == 0:
        empty = torch.empty((nby, nbx), dtype=torch.int32, device=cur.device)
        return empty, empty.clone()
    out = _launch(_lib().me_int_search, cur, ref_halo, nby, nbx, **kw)
    int_search.launches += 1
    return out


int_search.launches = 0


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


def _edge_slab_bottom(cur, ref_halo, *, blk_dim: int, span: int, metric: str):
    """Exact search of the last (truncated) block row: `int_search` on the
    slab of rows [y_org, H) (the port of `_edge_slab_bottom`, :1953).
    Returns [1, nbx] block grids."""
    cur_s, halo_s, y_org = bottom_slab(cur, ref_halo, blk_dim, span)
    h, w = cur.shape
    return int_search(
        cur_s, halo_s, blk_dim=blk_dim, span=span, metric=metric,
        frame_height=h, frame_width=w, y_origin=y_org,
    )


def _edge_slab_right(cur, ref_halo, *, blk_dim: int, span: int, metric: str):
    """Exact search of the last (truncated) block column: `int_search` on
    the slab of columns [x_org, W) (the port of `_edge_slab_right`,
    :1985). Returns [nby, 1] block grids."""
    cur_s, halo_s, x_org = right_slab(cur, ref_halo, blk_dim, span)
    h, w = cur.shape
    return int_search(
        cur_s, halo_s, blk_dim=blk_dim, span=span, metric=metric,
        frame_height=h, frame_width=w, x_origin=x_org,
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
                              edge_right, *, blk_dim: int, span: int, **kw):
    """Two [nby, nbx] result grids of a whole frame: `interior` on its whole
    blocks, then `edge_bottom` on the truncated last block row and
    `edge_right` on the truncated last block column, which overwrites the
    corner, as the JAX frame functions merge them
    (full_search_pallas.py:1595-1608, ssim_pallas.py:661-676)."""
    h, w = cur.shape
    nby, nbx = geometry.grid_shape(h, w, blk_dim)
    nyf, nxf = h // blk_dim, w // blk_dim
    inner = interior(
        cur[: nyf * blk_dim, : nxf * blk_dim], ref_halo, blk_dim=blk_dim,
        span=span, frame_height=h, frame_width=w, **kw,
    )
    out = [torch.empty((nby, nbx), dtype=g.dtype, device=g.device)
           for g in inner]
    for o, g in zip(out, inner):
        o[:nyf, :nxf] = g
    if h % blk_dim:
        for o, g in zip(out, edge_bottom(cur, ref_halo, blk_dim=blk_dim,
                                         span=span, **kw)):
            o[nby - 1, :] = g[0]
    if w % blk_dim:
        for o, g in zip(out, edge_right(cur, ref_halo, blk_dim=blk_dim,
                                        span=span, **kw)):
            o[:, nbx - 1] = g[:, 0]
    return out


def full_search_frame_cuda(cur, ref, *, blk_dim: int, span: int,
                           metric: str = "mse",
                           device=None) -> fs.MotionField:
    """Whole-frame full search (MSE or SAD) on the CUDA kernels.

    Bit-exact vs `search.full_search_frame`: identical MVs, integer costs
    and float32 scores. cur/ref: [H, W] integer frames (numpy or torch),
    moved to `device` (default "cuda"; "cpu" runs the plain versions).

    Routing follows `_full_search_frame_jit` (full_search_pallas.py:1490)
    with its default `phase=None`: the phase kernel for the interior plus
    the int kernel on the truncated bottom row and right column (which
    overwrites the corner); the int kernel over the whole frame where the
    phase kernel does not apply (SAD, or MSE at blk > 16 outside {24, 32}).
    Configs the JAX package sends to its chunked MSE kernels K5-K7 (MSE at
    blk <= 16 or blk 24 outside the phase kernel) raise NotImplementedError.
    metric="ssim" raises ValueError, as `full_search_frame_pallas` does:
    SSIM lives in kernels/ssim_cuda.py.
    """
    dev = resolve_device(device)
    if metric == "ssim":
        raise ValueError(_SSIM_ELSEWHERE)
    if metric not in _METRIC_CODE:
        raise ValueError(f"metric must be 'mse' or 'sad', got {metric!r}")
    cur_t, ref_halo = frame_operands(cur, ref, span, dev)
    use_phase = phase_supported(blk_dim, span, metric)
    if not use_phase and metric == "mse":
        if blk_dim <= 16:
            raise NotImplementedError(_CHUNKED_MSE.format(
                blk=blk_dim, span=span, kernel="K5 (_kernel_f32)"))
        if blk_dim <= 32 and blk_dim % 8 == 0:
            raise NotImplementedError(_CHUNKED_MSE.format(
                blk=blk_dim, span=span, kernel="K7 (_kernel_f32_wide)"))

    h, w = cur_t.shape
    nby, nbx = geometry.grid_shape(h, w, blk_dim)
    kw = dict(blk_dim=blk_dim, span=span, metric=metric)
    if use_phase:
        cost, idx = search_interior_and_edges(
            cur_t, ref_halo, phase_search, _edge_slab_bottom,
            _edge_slab_right, **kw,
        )
    else:
        cost, idx = int_search(
            cur_t, ref_halo, frame_height=h, frame_width=w, **kw
        )
    _, _, blk_h, blk_w = geometry.block_extents(
        0, 0, nby, nbx, blk_dim, h, w, dev
    )
    return fs.field_from_argmin(cost, idx, blk_h * blk_w, span, metric)
