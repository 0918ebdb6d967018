"""The plain reference every cell's output is held against.

Straightforward PyTorch over whole frames, written from the semantics the
reference C code and the configurations state, independent of the program
under test (it imports nothing of it):

* full search by SSD or SAD: every displacement (dy, dx) in [-span, span]²
  whose block lies wholly inside the frame, exact integer costs, the first
  candidate in raster order (dy, then dx) winning a tie; a block with no
  valid candidate keeps (0, 0) and the largest int32 cost;
* SSIM full search: the reference's SSIM of the block and the candidate
  from exact integer sums, evaluated one IEEE float32 operation at a time,
  the largest score winning, the first in raster order on a tie; invalid
  candidates score -inf.

`dtype` arguments exist for the control alone: the same arithmetic one
precision below what the configurations state (int16 costs, bfloat16
scores), which has to come out as not correct.
"""
from __future__ import annotations

import math

import numpy as np
import torch

INT32_MAX = 2**31 - 1
SSIM_C1, SSIM_C2, SSIM_C3 = 0.01, 0.09, 0.045


def _layout(h: int, w: int, blk: int, device):
    """Block grid shape, padded frame dims, each block's top-left and
    in-frame extent, and the in-frame pixel mask of the padded frame."""
    nby, nbx = -(-h // blk), -(-w // blk)
    hp, wp = nby * blk, nbx * blk
    tly = torch.arange(nby, device=device) * blk
    tlx = torch.arange(nbx, device=device) * blk
    bh = (h - tly).clamp(0, blk)
    bw = (w - tlx).clamp(0, blk)
    mask = torch.zeros((hp, wp), dtype=torch.bool, device=device)
    mask[:h, :w] = True
    return (nby, nbx), (hp, wp), (tly, tlx), (bh, bw), mask


def _rows(h, w, blk, span, tl, ext):
    """Yield (dy, valid [K, nby, nbx]) for each dy in order: the validity
    of the row's K = 2 * span + 1 displacements dx = -span..span."""
    (tly, tlx), (bh, bw) = tl, ext
    dxs = torch.arange(-span, span + 1, device=tly.device)
    vx = ((tlx[None, :] + dxs[:, None]) >= 0) & (
        (tlx[None, :] + dxs[:, None] + bw[None, :]) <= w)
    for dy in range(-span, span + 1):
        vy = ((tly + dy) >= 0) & ((tly + dy + bh) <= h)
        yield dy, vy[None, :, None] & vx[:, None, :]


def _windows(refp, span, dy, hp, wp):
    """[K, hp, wp] view: the reference under the padded frame at (dy, dx)
    for dx = -span..span."""
    rows = refp[span + dy: span + dy + hp]
    return rows.unfold(1, wp, 1).permute(1, 0, 2)


def _padded(cur, ref, span, hp, wp, dtype):
    h, w = cur.shape
    curp = torch.zeros((hp, wp), dtype=dtype, device=cur.device)
    curp[:h, :w] = cur.to(dtype)
    refp = torch.zeros((hp + 2 * span, wp + 2 * span), dtype=dtype,
                       device=cur.device)
    refp[span:span + h, span:span + w] = ref.to(dtype)
    return curp, refp


def _block_sums(x: torch.Tensor, blk: int, dtype) -> torch.Tensor:
    """[..., hp, wp] -> [..., nby, nbx] sums in `dtype`."""
    *lead, hp, wp = x.shape
    return x.reshape(*lead, hp // blk, blk, wp // blk, blk).sum(
        dim=(-3, -1), dtype=dtype)


def full_search(cur: torch.Tensor, ref: torch.Tensor, *, blk: int, span: int,
                metric: str = "mse", dtype=torch.int32):
    """(mv_y, mv_x, cost) int32 [nby, nbx] of an SSD ("mse") or SAD ("sad")
    full search of uint8 [H, W] frames, costs accumulated in `dtype`. A row
    of displacements at a time: within it the first dx of the least cost
    wins (the least of cost * K + dx index), across rows the first dy."""
    if metric not in ("mse", "sad"):
        raise ValueError(f"full_search takes mse or sad, got {metric!r}")
    h, w = cur.shape
    dev = cur.device
    k = 2 * span + 1
    (nby, nbx), (hp, wp), tl, ext, mask = _layout(h, w, blk, dev)
    curp, refp = _padded(cur, ref, span, hp, wp, dtype)
    maskd = None if (hp, wp) == (h, w) else mask.to(dtype)
    best = torch.full((nby, nbx), INT32_MAX, dtype=torch.int64, device=dev)
    by = torch.zeros((nby, nbx), dtype=torch.int64, device=dev)
    bx = torch.zeros_like(by)
    order = torch.arange(k, device=dev)[:, None, None]
    for dy, valid in _rows(h, w, blk, span, tl, ext):
        d = curp - _windows(refp, span, dy, hp, wp)
        d = d * d if metric == "mse" else d.abs()
        if maskd is not None:   # truncated blocks: count in-frame pixels
            d = d * maskd
        cost = _block_sums(d, blk, dtype).to(torch.int64)
        key = torch.where(valid, cost, INT32_MAX) * k + order
        low = key.min(dim=0).values
        cost, dx = low // k, low % k - span
        take = cost < best
        best = torch.where(take, cost, best)
        by = torch.where(take, dy, by)
        bx = torch.where(take, dx, bx)
    return by.to(torch.int32), bx.to(torch.int32), best.to(torch.int32)


def ssim_score(sum_ref, sum_sq_ref, sum_cur, sum_sq_cur, sum_cross, count,
               dtype=torch.float32):
    """The reference's SSIM from exact int32 block sums, one operation at a
    time in `dtype`: luminance x contrast x structure, the means truncated
    to int for the cross-variance, the biased variance centred on the
    truncated mean, clamped at 0 before a correctly rounded root, and the
    root squared again in the contrast's denominator."""
    dev = sum_ref.device
    c1, c2, c3 = (torch.tensor(c, dtype=dtype, device=dev)
                  for c in (SSIM_C1, SSIM_C2, SSIM_C3))
    n_i = torch.clamp(count, min=1)
    n = n_i.to(dtype)
    mean_ref = sum_ref.to(dtype) / n
    mean_cur = sum_cur.to(dtype) / n
    imean_ref = mean_ref.to(torch.int32)
    imean_cur = mean_cur.to(torch.int32)

    def std_dev(sum_x, sum_sq, imean, mean):
        csq = sum_sq - 2 * imean * sum_x + n_i * imean * imean
        cs = sum_x - n_i * imean
        frac = mean - imean.to(dtype)
        var = (csq.to(dtype) - 2.0 * frac * cs.to(dtype)
               + n * frac * frac) / n
        return torch.clamp(var, min=0.0).double().sqrt().to(dtype)

    std_ref = std_dev(sum_ref, sum_sq_ref, imean_ref, mean_ref)
    std_cur = std_dev(sum_cur, sum_sq_cur, imean_cur, mean_cur)
    cross_sum = (sum_cross - imean_cur * sum_ref - imean_ref * sum_cur
                 + count * imean_ref * imean_cur)
    cross_var = cross_sum.to(dtype) / n
    luminance = (2.0 * mean_ref * mean_cur + c1) / (
        mean_ref * mean_ref + mean_cur * mean_cur + c1)
    contrast = (2.0 * std_ref * std_cur + c2) / (
        std_ref * std_ref + std_cur * std_cur + c2)
    structure = (cross_var + c3) / (std_ref * std_cur + c3)
    return luminance * contrast * structure


def ssim_search(cur: torch.Tensor, ref: torch.Tensor, *, blk: int, span: int,
                dtype=torch.float32):
    """(mv_y, mv_x, flat index, score) [nby, nbx] of an SSIM full search
    of uint8 [H, W] frames; the index is (dy + span) * K + dx + span with
    K = 2 * span + 1, the score float32 (its arithmetic in `dtype`). A row
    of displacements is scored at once, then taken in raster order."""
    h, w = cur.shape
    dev = cur.device
    i32 = torch.int32
    (nby, nbx), (hp, wp), tl, ext, mask = _layout(h, w, blk, dev)
    curp, refp = _padded(cur, ref, span, hp, wp, i32)
    maskd = mask.to(i32)
    count = (ext[0][:, None] * ext[1][None, :]).to(i32)
    sum_cur = _block_sums(curp, blk, i32)
    sum_sq_cur = _block_sums(curp * curp, blk, i32)
    k = 2 * span + 1
    best = torch.full((nby, nbx), -math.inf, dtype=torch.float32, device=dev)
    idx = torch.full((nby, nbx), span * k + span, dtype=i32, device=dev)
    for dy, valid in _rows(h, w, blk, span, tl, ext):
        win = _windows(refp, span, dy, hp, wp) * maskd
        score = ssim_score(_block_sums(win, blk, i32),
                           _block_sums(win * win, blk, i32), sum_cur,
                           sum_sq_cur, _block_sums(win * curp, blk, i32),
                           count, dtype).to(torch.float32)
        for j in range(k):
            take = valid[j] & (score[j] > best)
            best = torch.where(take, score[j], best)
            idx = torch.where(take, (dy + span) * k + j, idx)
    return idx // k - span, idx % k - span, idx, best


def mean_score(cost: np.ndarray, h: int, w: int, blk: int) -> np.ndarray:
    """float32 [nby, nbx]: each block's integer cost over its in-frame
    pixel count, one float32 division."""
    nby, nbx = cost.shape
    bh = np.minimum(blk, h - np.arange(nby) * blk).astype(np.float32)
    bw = np.minimum(blk, w - np.arange(nbx) * blk).astype(np.float32)
    return cost.astype(np.float32) / (bh[:, None] * bw[None, :])
