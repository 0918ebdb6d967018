"""The least time the card could take for a search or a diamond replay:
its bound.

One copy of the arithmetic, shared by `chip_smoke.py` (each kernel's
`bound_ms`) and `bench_torch.py` (`pct_of_roofline`), so a share of the
bound can never pass 100% by one side counting less work than the other.
"""
from __future__ import annotations

import numpy as np

from motionestimation_tpu_torch.search.patterns import LDSP, SDSP

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


def replay_reads(traj, *, span: int) -> int:
    """Distinct volume entries a diamond replay without early termination
    reads on this data, each (plane, block) pair once: per block, the
    window-clipped LDSP neighbourhoods of its centres over the rounds it
    was active and the SDSP neighbourhood of its last centre. `traj` is
    the replay's int32 trajectory [max_steps + 1, nby, nbx, 2] (numpy); a
    block is active in round 0 and in each later round that follows a
    move."""
    k = 2 * span + 1
    rows = traj.shape[0]
    cy = traj[..., 0].reshape(rows, -1).astype(np.int64)
    cx = traj[..., 1].reshape(rows, -1).astype(np.int64)
    blocks = np.arange(cy.shape[1])
    keys = []

    def read(y, x, which, pattern):
        for oy, ox in pattern:
            ty, tx = y[which] + oy, x[which] + ox
            ok = (np.abs(ty) <= span) & (np.abs(tx) <= span)
            plane = (ty[ok] + span) * k + tx[ok] + span
            keys.append(plane * len(blocks) + blocks[which][ok])

    active = np.ones(len(blocks), dtype=bool)
    for t in range(rows - 1):
        read(cy[t], cx[t], active, LDSP)
        active &= (cy[t + 1] != cy[t]) | (cx[t + 1] != cx[t])
    read(cy[-1], cx[-1], np.ones_like(active), SDSP)
    return len(np.unique(np.concatenate(keys)))


def replay_bound(reads: int, nblocks: int, trajectory_rows: int = 0):
    """(bound_ms, bound_by) of a diamond replay: `reads` 4-byte volume
    entries (`replay_reads`) read once, and per block its int32 MV pair
    and cost and its escape byte written, plus `trajectory_rows` int32
    (y, x) rows, over the HBM rate; the operations (a window test, a
    compare and a select per entry read) over the float32 lane rate stay
    well below it."""
    nbytes = 4 * reads + nblocks * (3 * 4 + 1 + 8 * trajectory_rows)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 3 * reads / FP32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
