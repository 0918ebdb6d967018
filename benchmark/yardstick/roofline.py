"""The least time the card could take for a whole-frame search: its bound.

A frozen copy of the port's `bench/roofline.bound` arithmetic, so that a
change to the port cannot move the yardstick. The work is counted from the
cell's shapes, the same whichever kernel does it: both frames read once
(the reference with its span of padding all round) and two int32 grids
written, over the HBM rate; 2 integer operations (a difference and its
square or absolute value, accumulated) a pixel-candidate over the int8 peak;
for SSIM, SSIM_FLOPS a block-candidate over the float32 rate. The bound is
the largest of the three.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit): HBM bytes/s,
# int8 operations/s, float32 operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP32_OPS_S = 67e12
# Float operations of one SSIM score with the current block's terms
# hoisted: the reference mean (1), its centred variance (8), the clamp and
# root (2), the cross-variance (1), luminance (8), contrast (8), structure
# (4) and the product (2).
SSIM_FLOPS = 34


def valid_candidates(h, w, blk, span, tile, origin):
    """(pixel-candidates, block-candidates) a search of the tile's blocks
    needs: for each block, (valid dy) x (valid dx), times its in-frame
    pixels for the first."""
    (th, tw), (y0, x0) = tile, origin

    def axis(n, start, frame):
        tl = start + np.arange(-(-n // blk)) * blk
        ext = np.clip(frame - tl, 0, blk)
        lo = np.maximum(-span, -tl)
        hi = np.minimum(span, frame - ext - tl)
        return np.maximum(hi - lo + 1, 0), ext

    ny, ey = axis(th, y0, h)
    nx, ex = axis(tw, x0, w)
    return (int((ny * ey).sum()) * int((nx * ex).sum()),
            int(ny.sum()) * int(nx.sum()))


def bound(h, w, blk, span, tile, origin, ssim=False):
    """(bound_ms, bound_by) of a search of `tile` (rows, columns) at
    `origin` in an h x w frame: bytes, integer operations or, for SSIM,
    float operations, whichever takes longest at the card's peak."""
    th, tw = tile
    nby, nbx = -(-th // blk), -(-tw // blk)
    nbytes = th * tw + (th + 2 * span) * (tw + 2 * span) + 2 * 4 * nby * nbx
    pixel_cands, block_cands = valid_candidates(h, w, blk, span, tile, origin)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = max(2 * pixel_cands / INT8_OPS_S * 1e3,
                SSIM_FLOPS * block_cands / FP32_OPS_S * 1e3 if ssim else 0.0)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
