"""The least time the card could take for a diamond search: its bound.

A frozen copy of the port's `bench/roofline.walk_evals` and `walk_bound`
arithmetic, without the early check (the cells run none) or trajectory
output (the cells read none back), so that a change to the port cannot
move the yardstick. The work is what the canonical trajectories need,
counted from the plain reference's (`yardstick/diamond.py`): the distinct
(block, displacement) evaluations they look up, however an implementation
reaches them (level volumes, a walk), so the bound is the same whatever
implements the diamond. Bytes: both frames read once (the centre
candidates alone cover the whole reference) and each block's int32 MV pair
and cost written, over the HBM rate; 2 integer operations a
pixel-candidate (the difference and its square or absolute value,
accumulated) over the int8 peak. The bound is the larger.
"""
from __future__ import annotations

import numpy as np

from benchmark.yardstick.diamond import LDSP, SDSP
from benchmark.yardstick.roofline import HBM_BYTES_S, INT8_OPS_S


def walk_evals(traj, *, span: int, blk_dim: int, frame_height: int,
               frame_width: int):
    """(block-candidates, pixel-candidates): the distinct (block,
    displacement) evaluations the walks of `traj` need, and their in-frame
    pixels. Per block: the centre (0, 0); the LDSP candidates of each round
    it moved, and of the round after its last move unless the rounds ran
    out; the SDSP candidates of its last centre. Targets beyond the window
    or outside the frame are not counted. `traj`: the int32 trajectory
    [max_steps + 1, nby, nbx, 2] (numpy), frozen after a block stops."""
    k = 2 * span + 1
    rows, nby, nbx = traj.shape[:3]
    cy = traj[..., 0].reshape(rows, -1).astype(np.int64)
    cx = traj[..., 1].reshape(rows, -1).astype(np.int64)
    blocks = np.arange(nby * nbx)
    tl_y = (blocks // nbx) * blk_dim
    tl_x = (blocks % nbx) * blk_dim
    bh = np.clip(frame_height - tl_y, 0, blk_dim)
    bw = np.clip(frame_width - tl_x, 0, blk_dim)
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
        read(cy[t], cx[t], active, LDSP)
        active &= (cy[t + 1] != cy[t]) | (cx[t + 1] != cx[t])
    read(cy[-1], cx[-1], np.ones(len(blocks), dtype=bool), SDSP)
    found = np.unique(np.concatenate(keys))
    pixels = (bh * bw)[found // (k * k)]
    return len(found), int(pixels.sum())


def walk_bound(frame_height: int, frame_width: int, *, nblocks: int,
               pixel_evals: int):
    """(bound_ms, bound_by) of a diamond search of `nblocks` blocks that
    evaluates `pixel_evals` pixel-candidates (`walk_evals`)."""
    nbytes = 2 * frame_height * frame_width + nblocks * 3 * 4
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2 * pixel_evals / INT8_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(traj, *, span: int, blk_dim: int, frame_height: int,
             frame_width: int) -> float:
    """The bound of one pair searched along the trajectories `traj`."""
    _, pixels = walk_evals(traj, span=span, blk_dim=blk_dim,
                           frame_height=frame_height, frame_width=frame_width)
    nblocks = traj.shape[1] * traj.shape[2]
    return walk_bound(frame_height, frame_width, nblocks=nblocks,
                      pixel_evals=pixels)[0]
