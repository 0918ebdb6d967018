"""The plain diamond search every diamond cell's output is held against.

Straightforward PyTorch over all blocks at once, independent of the
program under test (it imports nothing of it). The search is the diamond
search of Zhu and Ma, "A new diamond search algorithm for fast
block-matching motion estimation", IEEE Trans. Image Processing 9(2),
2000: per block, from the centre (0, 0), the large diamond search pattern
(LDSP: the centre and its 8 points at distance 2 in L1) is repeated around
its best point until the centre is best; then the small diamond search
pattern (SDSP: the centre and its 4 neighbours) is searched once, and its
best point is the motion vector. The costs are exact integer SSD ("mse")
or SAD ("sad") of the block against the reference at the candidate, the
block truncated to its in-frame pixels at the frame's bottom and right
edges.

Where this project's canonical rules depart from the paper, or fix what
it leaves open (the JAX package's `diamond_search_np` defines them):

* the patterns are taken in a fixed raster order (dy, then dx),
      LDSP (-2,0) (-1,-1) (-1,1) (0,-2) (0,0) (0,2) (1,-1) (1,1) (2,0)
      SDSP (-1,0) (0,-1) (0,0) (0,1) (1,0),
  and a candidate moves the centre only when its cost is strictly below
  the best so far, which starts at the centre's: the centre wins every
  tie, and among the others the first in that order wins;
* a candidate is skipped where |dy| or |dx| exceeds `span`, or where the
  block moved by it leaves the frame (the paper's search window);
* the LDSP is repeated at most `max_steps` times (default span + 2); a
  block whose centre still moves after the last round takes the SDSP step
  around its last centre all the same (the paper has no cap);
* the paper evaluates only the points a round adds; here every point of a
  pattern is looked up again, which gives the same costs and so the same
  trajectory;
* the paper matches by mean absolute difference; the cells here by SSD;
* no early termination (the program's `early_term` is not modelled: the
  cells run without it).

`dtype` exists for the control alone: the same arithmetic one precision
below what the configurations state (int16 costs), which has to come out
as not correct.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

LDSP = ((-2, 0), (-1, -1), (-1, 1), (0, -2), (0, 0),
        (0, 2), (1, -1), (1, 1), (2, 0))
SDSP = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))


class Diamond(NamedTuple):
    """A diamond search's result, each [nby, nbx] but the trajectory:
    int32 MVs and cost, the float32 cost over the block's in-frame pixels,
    and the int32 trajectory [max_steps + 1, nby, nbx, 2], the centre
    (dy, dx) after each LDSP round, frozen once the block stopped, the
    first row (0, 0)."""
    mv_y: torch.Tensor
    mv_x: torch.Tensor
    cost: torch.Tensor
    score: torch.Tensor
    trajectory: torch.Tensor


class _Blocks:
    """The frames cut into blocks, and the cost of any displacement of
    any of them."""

    def __init__(self, cur, ref, blk, span, metric, dtype):
        if metric not in ("mse", "sad"):
            raise ValueError(f"the diamond reference takes mse or sad, got "
                             f"{metric!r}")
        h, w = cur.shape
        dev = cur.device
        self.h, self.w, self.blk, self.span = h, w, blk, span
        self.square = metric == "mse"
        self.dtype = dtype
        self.nby, self.nbx = -(-h // blk), -(-w // blk)
        hp, wp = self.nby * blk, self.nbx * blk
        by, bx = torch.meshgrid(torch.arange(self.nby, device=dev),
                                torch.arange(self.nbx, device=dev),
                                indexing="ij")
        self.tly = (by * blk).flatten()
        self.tlx = (bx * blk).flatten()
        self.bh = (h - self.tly).clamp(max=blk)
        self.bw = (w - self.tlx).clamp(max=blk)
        curp = torch.zeros((hp, wp), dtype=dtype, device=dev)
        curp[:h, :w] = cur.to(dtype)
        self.cur = (curp.reshape(self.nby, blk, self.nbx, blk)
                    .permute(0, 2, 1, 3).reshape(-1, blk, blk))
        ar = torch.arange(blk, device=dev)
        self.mask = ((ar[None, :, None] < self.bh[:, None, None])
                     & (ar[None, None, :] < self.bw[:, None, None])).to(dtype)
        # The reference with `span` of zeros above and left and enough
        # below and right that every block at every |d| <= span is inside.
        self.ref = torch.zeros((hp + 2 * span, wp + 2 * span), dtype=dtype,
                               device=dev)
        self.ref[span:span + h, span:span + w] = ref.to(dtype)
        self.ar = ar

    @property
    def count(self) -> int:
        return self.nby * self.nbx

    def valid(self, idx, dy, dx):
        """Whether blocks `idx` moved by (dy, dx) lie in the window and in
        the frame."""
        return ((dy.abs() <= self.span) & (dx.abs() <= self.span)
                & (self.tly[idx] + dy >= 0)
                & (self.tly[idx] + dy + self.bh[idx] <= self.h)
                & (self.tlx[idx] + dx >= 0)
                & (self.tlx[idx] + dx + self.bw[idx] <= self.w))

    def cost(self, idx, dy, dx):
        """(cost int64, valid) of blocks `idx` [n] at displacements (dy,
        dx) [n]: the SSD or SAD over each block's in-frame pixels, summed
        in `dtype`."""
        s = self.span
        rows = (self.tly[idx] + dy.clamp(-s, s) + s)[:, None] + self.ar
        cols = (self.tlx[idx] + dx.clamp(-s, s) + s)[:, None] + self.ar
        patch = self.ref[rows[:, :, None], cols[:, None, :]]
        d = (self.cur[idx] - patch) * self.mask[idx]
        d = d * d if self.square else d.abs()
        cost = d.sum(dim=(1, 2), dtype=self.dtype).to(torch.int64)
        return cost, self.valid(idx, dy, dx)


def _pattern_step(blocks, idx, cy, cx, best, pattern):
    """One pattern around centres (cy, cx) [n] of blocks `idx` whose cost
    is `best`: (wy, wx, cost) of the winner, (0, 0) where the centre
    stays."""
    wy = torch.zeros_like(cy)
    wx = torch.zeros_like(cx)
    for oy, ox in pattern:
        if (oy, ox) == (0, 0):   # the centre's own cost cannot beat itself
            continue
        cost, ok = blocks.cost(idx, cy + oy, cx + ox)
        take = ok & (cost < best)
        best = torch.where(take, cost, best)
        wy = torch.where(take, oy, wy)
        wx = torch.where(take, ox, wx)
    return wy, wx, best


def diamond_search(cur: torch.Tensor, ref: torch.Tensor, *, blk: int,
                   span: int, metric: str = "mse", max_steps: int | None = None,
                   dtype=torch.int32) -> Diamond:
    """The canonical diamond search of uint8 [H, W] frames, all blocks at
    once: each LDSP round looks up the blocks still moving (one host sync a
    round), then one SDSP step for every block."""
    if max_steps is None:
        max_steps = span + 2
    blocks = _Blocks(cur, ref, blk, span, metric, dtype)
    dev = cur.device
    n = blocks.count
    every = torch.arange(n, device=dev)
    cy = torch.zeros(n, dtype=torch.int64, device=dev)
    cx = torch.zeros_like(cy)
    ccost, _ = blocks.cost(every, cy, cx)
    traj = torch.zeros((max_steps + 1, n, 2), dtype=torch.int64, device=dev)
    moving = torch.ones(n, dtype=torch.bool, device=dev)
    for step in range(max_steps):
        idx = moving.nonzero().squeeze(1)
        if idx.numel():
            wy, wx, best = _pattern_step(blocks, idx, cy[idx], cx[idx],
                                         ccost[idx], LDSP)
            cy[idx] += wy
            cx[idx] += wx
            ccost[idx] = best
            moving[idx] = (wy != 0) | (wx != 0)
        traj[step + 1, :, 0] = cy
        traj[step + 1, :, 1] = cx
    wy, wx, ccost = _pattern_step(blocks, every, cy, cx, ccost, SDSP)
    cy, cx = cy + wy, cx + wx
    grid = (blocks.nby, blocks.nbx)
    area = (blocks.bh * blocks.bw).to(torch.float32)
    cost = ccost.to(torch.int32)
    return Diamond(cy.to(torch.int32).view(grid), cx.to(torch.int32).view(grid),
                   cost.view(grid), (cost.to(torch.float32) / area).view(grid),
                   traj.to(torch.int32).view(max_steps + 1, *grid, 2))
