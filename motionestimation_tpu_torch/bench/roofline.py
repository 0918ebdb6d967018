"""The least time the card could take for a search: its bound.

One copy of the arithmetic, shared by `chip_smoke.py` (each kernel's
`bound_ms`) and `bench_torch.py` (`pct_of_roofline`), so a share of the
bound can never pass 100% by one side counting less work than the other.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, int8 ops/s, and
# float32 outside the tensor cores.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
FP32_OPS_S = 67e12
# Float operations of one SSIM score with the current block's terms
# hoisted (metrics/cost.py ssim_from_sums): the reference mean (1), its
# centred variance (8), the clamp and root (2), the cross-variance (1),
# luminance (8), contrast (8), structure (4) and the product (2).
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


def bound(h, w, blk, span, tile, origin, ssim=False, volume=False):
    """(bound_ms, bound_by): the largest of bytes read once / written once
    (with `volume`, the 4-byte [K², nby, nbx] volume too) over the HBM rate,
    2 integer ops (subtract or product, accumulate) per pixel-candidate
    over the int8 peak and, for SSIM, SSIM_FLOPS per block-candidate over
    the float32 rate."""
    th, tw = tile
    nby, nbx = -(-th // blk), -(-tw // blk)
    nbytes = th * tw + (th + 2 * span) * (tw + 2 * span) + 2 * 4 * nby * nbx
    if volume:
        nbytes += 4 * (2 * span + 1) ** 2 * nby * nbx
    pixel_cands, block_cands = valid_candidates(h, w, blk, span, tile, origin)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = max(2 * pixel_cands / INT8_OPS_S * 1e3,
                SSIM_FLOPS * block_cands / FP32_OPS_S * 1e3 if ssim else 0.0)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
