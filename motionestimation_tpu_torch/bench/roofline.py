"""The least time the card could take for a search, a diamond replay, a
diamond walk or a speed-of-light lab variant: its bound.

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


# The speed-of-light lab (tools/kern_lab.py, csrc/lab.cu): 8x8 blocks, span
# 12. The instructions one block-candidate of a variant needs on the card,
# and the lanes of an SM that issue them each clock: L1's a __dp4a (L0,
# M1) or a vabsdiff4 with accumulate (M2) a word of four pixels on the
# 64 int32 lanes; a bf16x2 FMA and an FADD a pixel (M3), or one product
# ("L1"), on the 128 FP32 lanes; none (NOP). The key kernel's (L2-L7): SAD
# ("P1" and the key's) a vabsdiff4 with accumulate a word and the cross
# term ("P0", "P3", "P6", "P6B") a __dp4a a word, on the int32 lanes; the
# diff form a vabsdiff4 and a __dp4a a word, 32 instructions, counted
# against what holds however the two are given pipes: an SM issues one
# warp instruction a clock from each of its four schedulers, 128 lanes, and
# each of the two alone is 16 on its 64 lanes, the same time. Neither rate
# is measured on the card apart (a vabsdiff4-only and a __dp4a-only loop
# would tell). L3's ablations: "P3B" the cross term's ring, which it keeps
# live, over every candidate; "P3A" no ring, the cost's add, the key's
# multiply-add, the mask's OR and the minimum a candidate on the int32
# lanes, under its bytes.
LAB_BLK, LAB_SPAN = 8, 12
LAB_OPS = {"NOP": (0, 128), "L0": (16, 64), "L1": (1, 128), "M1": (16, 64),
           "M2": (16, 64), "M3": (128, 128),
           **dict.fromkeys(("P4", "P5", "P5B", "P7"), (32, 128)),
           **dict.fromkeys(("P4S", "P5S", "P5SB", "P7S", "P3S", "P1"),
                           (16, 64)),
           **dict.fromkeys(("P0", "P3", "P6", "P6B", "P3B"), (16, 64)),
           "P3A": (4, 64)}
# L1 searches every offset of the zero-padded reference, and "P3B" keeps
# every offset's ring live; the other key variants need only the candidates
# whose window lies inside the frame. L1 and L2 ("P0", "P1") write a
# float32 cost and an int32 index a block, the rest one int32.
LAB_UNMASKED = ("NOP", "L0", "L1", "M1", "M2", "M3", "P3B")
LAB_PAIR = ("NOP", "L0", "L1", "M1", "M2", "M3", "P0", "P1")


def lab_parts(variant: str, h: int, w: int, sms: int, clock_mhz: float):
    """(operations ms, bytes ms) of a lab variant on an h x w frame: its
    LAB_OPS instructions for each block-candidate the function needs (all
    625 a block for LAB_UNMASKED, the valid ones for the rest) over `sms`
    SMs of its lanes at `clock_mhz`; its float32 operands (cur and the
    [h + 24, w + 24] window) read once and outputs (8 bytes a block for
    LAB_PAIR, 4 for the rest) written once over the HBM rate."""
    ops, lanes = LAB_OPS[variant]
    nblk = (h // LAB_BLK) * (w // LAB_BLK)
    if variant in LAB_UNMASKED:
        cands = nblk * (2 * LAB_SPAN + 1) ** 2
    else:
        cands = valid_candidates(h, w, LAB_BLK, LAB_SPAN, (h, w), (0, 0))[1]
    out_bytes = 8 if variant in LAB_PAIR else 4
    ops_ms = cands * ops / (sms * lanes * clock_mhz * 1e6) * 1e3
    nbytes = (4 * (h * w + (h + 2 * LAB_SPAN) * (w + 2 * LAB_SPAN))
              + out_bytes * nblk)
    return ops_ms, nbytes / HBM_BYTES_S * 1e3


def lab_bound(variant: str, h: int, w: int, sms: int, clock_mhz: float):
    """(bound_ms, bound_by) of a lab variant in LAB_OPS: the larger of
    `lab_parts`' two times."""
    ops_ms, bytes_ms = lab_parts(variant, h, w, sms, clock_mhz)
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


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
    entries (`replay_reads`) read once, and per block its MotionField
    (int32 MV pair and cost or index, float32 score) and its escape byte
    written, plus `trajectory_rows` int32 (y, x) rows, over the HBM rate;
    the operations (a window test, a compare and a select per entry read)
    over the float32 lane rate stay well below it."""
    nbytes = 4 * reads + nblocks * (4 * 4 + 1 + 8 * trajectory_rows)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 3 * reads / FP32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walk_terminated(mv_y, mv_x, cost, traj, *, early_term, count,
                    minimise: bool):
    """[nby, nbx] bool (numpy): the blocks of a diamond walk that the early
    check stopped, from its result. Such a block skipped its last LDSP
    round and the SDSP step, so it ends at its last trajectory row with a
    cost that passes the check; a block that converged and took the SDSP
    step fails the check on its last LDSP centre's cost, and keeps that
    cost where the centre held. `count`: the blocks' in-frame pixels."""
    if early_term is None:
        return np.zeros(np.shape(mv_y), dtype=bool)
    thr = np.float32(early_term)
    if minimise:
        passes = (np.asarray(cost).astype(np.float32)
                  / np.maximum(count, 1).astype(np.float32)) <= thr
    else:
        passes = np.asarray(cost) >= thr
    return ((mv_y == traj[-1, ..., 0]) & (mv_x == traj[-1, ..., 1])
            & passes)


def walk_evals(traj, *, span: int, blk_dim: int, frame_height: int,
               frame_width: int, terminated=None):
    """(block-candidates, pixel-candidates): the distinct (block,
    displacement) evaluations a diamond walk needs on this data, and their
    in-frame pixels. Per block: the centre (0, 0); the LDSP candidates of
    each round it moved, and of the round after its last move unless the
    early check stopped it there (`terminated`, [nby, nbx] bool, None for
    no early check) or the rounds ran out; the SDSP candidates of its last
    centre unless terminated. Targets beyond the window or invalid for the
    block (outside the frame) need no pixels and are not counted. `traj` is
    the walk's int32 trajectory [max_steps + 1, nby, nbx, 2] (numpy), frozen
    after a block stops, as `replay_reads` reads it."""
    k = 2 * span + 1
    rows, nby, nbx = traj.shape[:3]
    cy = traj[..., 0].reshape(rows, -1).astype(np.int64)
    cx = traj[..., 1].reshape(rows, -1).astype(np.int64)
    blocks = np.arange(nby * nbx)
    tl_y = (blocks // nbx) * blk_dim
    tl_x = (blocks % nbx) * blk_dim
    bh = np.clip(frame_height - tl_y, 0, blk_dim)
    bw = np.clip(frame_width - tl_x, 0, blk_dim)
    stopped = (np.zeros(len(blocks), dtype=bool) if terminated is None
               else np.asarray(terminated).reshape(-1))
    keys = [blocks * k * k + span * k + span]

    def read(y, x, which, pattern):
        for oy, ox in pattern:
            ty, tx = y[which] + oy, x[which] + ox
            ok = ((np.abs(ty) <= span) & (np.abs(tx) <= span)
                  & (tl_y[which] + ty >= 0)
                  & (tl_y[which] + ty <= frame_height - bh[which])
                  & (tl_x[which] + tx >= 0)
                  & (tl_x[which] + tx <= frame_width - bw[which]))
            plane = (ty[ok] + span) * k + tx[ok] + span
            keys.append(blocks[which][ok] * k * k + plane)

    active = np.ones(len(blocks), dtype=bool)
    for t in range(rows - 1):
        moved = (cy[t + 1] != cy[t]) | (cx[t + 1] != cx[t])
        read(cy[t], cx[t], active & (moved | ~stopped), LDSP)
        active &= moved
    read(cy[-1], cx[-1], ~stopped, SDSP)
    found = np.unique(np.concatenate(keys))
    pixels = (bh * bw)[found // (k * k)]
    return len(found), int(pixels.sum())


# Integer operations of one pixel-candidate: the difference and its square
# or absolute value, accumulated (SSD/SAD: 2); Σr, Σr² and Σr·c (SSIM: 5).
WALK_INT_OPS = {"mse": 2, "sad": 2, "ssim": 5}


def walk_bound(frame_height: int, frame_width: int, *, nblocks: int,
               block_evals: int, pixel_evals: int, metric: str,
               trajectory_rows: int = 0):
    """(bound_ms, bound_by) of a diamond walk over the frames' pixels: the
    current frame and the evaluated candidates' reference pixels read once
    each (the centre candidates alone cover the whole reference frame), and
    per block its int32 MV pair and cost written, plus `trajectory_rows`
    int32 (y, x) rows, over the HBM rate; `WALK_INT_OPS` per
    pixel-candidate over the int8 peak and, for SSIM, SSIM_FLOPS per
    block-candidate over the float32 rate (`walk_evals` counts both)."""
    nbytes = (2 * frame_height * frame_width
              + nblocks * (3 * 4 + 8 * trajectory_rows))
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = WALK_INT_OPS[metric] * pixel_evals / INT8_OPS_S * 1e3
    if metric == "ssim":
        t_ops = max(t_ops, SSIM_FLOPS * block_evals / FP32_OPS_S * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
