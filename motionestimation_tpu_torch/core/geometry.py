"""Block-grid and search-window geometry.

Reference semantics:

* The frame is partitioned into a ceil-div grid of ``blk_dim``-square
  blocks, row-major; blocks on the right/bottom edge are **truncated** to
  the frame, never padded.
* A displacement (dx, dy) is scanned for a block iff the candidate block
  (with the truncated extent) lies fully inside the frame:

      0 <= tl + d <= frame - extent                         (per axis)

  so MV=(0,0) is always a candidate and edge blocks see an asymmetric
  lattice.
* The scan is y-outer/x-inner raster order with a strict-inequality argmin,
  so the first candidate in raster order wins ties. Each displacement is
  encoded as the flat raster index

      idx = (dy + span) * (2*span + 1) + (dx + span)

  and the lowest valid index wins a tie.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def grid_shape(height: int, width: int, blk_dim: int) -> Tuple[int, int]:
    """(num_blocks_y, num_blocks_x) for a frame."""
    return cdiv(height, blk_dim), cdiv(width, blk_dim)


def padded_dims(height: int, width: int, blk_dim: int) -> Tuple[int, int]:
    """Frame dims rounded up to a whole number of blocks."""
    nby, nbx = grid_shape(height, width, blk_dim)
    return nby * blk_dim, nbx * blk_dim


def block_extents_np(height: int, width: int, blk_dim: int):
    """NumPy block geometry of a whole frame: int32 (tl_y, tl_x, blk_h,
    blk_w), each [nby, nbx], the top-left pixels and truncated extents."""
    nby, nbx = grid_shape(height, width, blk_dim)
    tl_y = np.broadcast_to(
        (np.arange(nby, dtype=np.int32) * blk_dim)[:, None], (nby, nbx))
    tl_x = np.broadcast_to(
        (np.arange(nbx, dtype=np.int32) * blk_dim)[None, :], (nby, nbx))
    blk_h = np.minimum(blk_dim, height - tl_y).astype(np.int32)
    blk_w = np.minimum(blk_dim, width - tl_x).astype(np.int32)
    return tl_y.copy(), tl_x.copy(), blk_h, blk_w


def block_extents(
    y0: int,
    x0: int,
    nby: int,
    nbx: int,
    blk_dim: int,
    frame_height: int,
    frame_width: int,
    device: torch.device | str | None = None,
):
    """Block geometry for a tile whose first pixel is global (y0, x0).

    Returns int32 tensors (tl_y, tl_x, blk_h, blk_w), each [nby, nbx], in
    *global* frame coordinates. Blocks fully outside the frame get extent
    clamped to >= 0.
    """
    iy = torch.arange(nby, dtype=torch.int32, device=device)[:, None]
    ix = torch.arange(nbx, dtype=torch.int32, device=device)[None, :]
    tl_y = (y0 + iy * blk_dim).expand(nby, nbx)
    tl_x = (x0 + ix * blk_dim).expand(nby, nbx)
    blk_h = torch.clamp(frame_height - tl_y, 0, blk_dim).to(torch.int32)
    blk_w = torch.clamp(frame_width - tl_x, 0, blk_dim).to(torch.int32)
    return tl_y, tl_x, blk_h, blk_w


def displacement_valid(
    d_y,
    d_x,
    tl_y,
    tl_x,
    blk_h,
    blk_w,
    frame_height: int,
    frame_width: int,
):
    """Boolean mask: is displacement (d_y, d_x) scanned for each block?

    Candidate top-left must satisfy 0 <= tl+d and tl+d <= frame - extent.
    d_* may be ints or tensors broadcasting against the [nby, nbx] tl_* /
    blk_* tensors.
    """
    ok_x = (tl_x + d_x >= 0) & (tl_x + d_x <= frame_width - blk_w)
    ok_y = (tl_y + d_y >= 0) & (tl_y + d_y <= frame_height - blk_h)
    return ok_x & ok_y


def mv_from_flat_index(flat_idx, span: int):
    """Decode the flat raster candidate index into (mv_y, mv_x).

    Inverse of idx = (dy+span)*(2*span+1) + (dx+span); MV semantics are
    candidate_topleft − block_topleft.
    """
    k = 2 * span + 1
    mv_y = flat_idx // k - span
    mv_x = flat_idx % k - span
    return mv_y, mv_x
