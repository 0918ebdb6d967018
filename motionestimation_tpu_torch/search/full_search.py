"""Exhaustive (full-search) block matching — the plain-torch golden path.

For each of the (2·span+1)² candidate displacements the reference frame is
slid under the current frame and the masked per-pixel cost is block-reduced,
carrying a running (best_cost, best_flat_index) argmin — or, for SSIM, a
running (best_score, best_flat_index) argmax. Raster iteration order over
the flat displacement index plus strict-inequality updates reproduce the
reference's first-in-raster-order-wins tie rule exactly.

The tile-level function takes a global origin, so a later sharded path can
call it per shard with the same arithmetic as the single-card call. This
module is also the plain version every CUDA kernel of the search is held
against (kernels/full_search_cuda.py and kernels/ssim_cuda.py build on
`make_displacement_cost`).
It runs wherever its input tensors lie.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from motionestimation_tpu_torch.core import geometry
from motionestimation_tpu_torch.core.device import to_tensor
from motionestimation_tpu_torch.metrics import cost as cost_lib

class MotionField(NamedTuple):
    """Per-block search result, tensors of shape [nby, nbx].

    mv_y / mv_x: int32 displacement, candidate_topleft − block_topleft.
    best_cost_i32: exact integer SSD (MSE search) or SAD (SAD search); for
      SSIM, the winner's flat raster index (the search maximises a float
      score, so there is no integer cost).
    score: float32 MSE (SSD / (w·h)), MAD (SAD / (w·h)) or SSIM score.
    """

    mv_y: torch.Tensor
    mv_x: torch.Tensor
    best_cost_i32: torch.Tensor
    score: torch.Tensor


def make_ref_halo(ref, frame_height: int, frame_width: int, blk_dim: int, span: int):
    """Zero-pad the reference frame to the block-padded dims plus a span halo.

    Global reference pixel (y, x) lands at halo[y + span, x + span]; pixels
    outside the frame are zero (never observed by a valid candidate).
    """
    hp, wp = geometry.padded_dims(frame_height, frame_width, blk_dim)
    return F.pad(
        to_tensor(ref).to(torch.int32),
        (span, span + wp - frame_width, span, span + hp - frame_height),
    )


def _tile_masks(tile_h, tile_w, y0, x0, frame_height, frame_width, device):
    """Per-pixel in-frame mask (int32) for a tile with global origin (y0, x0)."""
    py = y0 + torch.arange(tile_h, dtype=torch.int32, device=device)[:, None]
    px = x0 + torch.arange(tile_w, dtype=torch.int32, device=device)[None, :]
    return ((py < frame_height) & (px < frame_width)).to(torch.int32)


def _check_metric(metric: str) -> None:
    if metric not in ("mse", "sad", "ssim"):
        raise ValueError(f"unknown metric {metric!r}")


def make_displacement_cost(
    cur_tile: torch.Tensor,
    ref_halo: torch.Tensor,
    y0: int,
    x0: int,
    *,
    frame_height: int,
    frame_width: int,
    blk_dim: int,
    span: int,
    metric: str,
):
    """Closure computing the per-block cost plane of one displacement.

    The returned `displacement_cost(idx)` maps a flat raster displacement
    index (idx = (d_y + span)*K + (d_x + span)) to the [nby, nbx] per-block
    cost: truncated-extent masking, window-clamp validity, and INT32_MAX
    (int32 SSD/SAD) or -inf (float32 SSIM score) for invalid (block,
    displacement) pairs. For SSIM the reference window is masked by the
    current block's in-frame pixels before its sums are taken.

    cur_tile: [Th, Tw] with Th, Tw multiples of blk_dim, global origin
    (y0, x0); ref_halo: [Th + 2*span, Tw + 2*span], global ref pixel
    (y0 + r - span, x0 + c - span) at [r, c].
    """
    _check_metric(metric)
    tile_h, tile_w = cur_tile.shape
    nby, nbx = tile_h // blk_dim, tile_w // blk_dim
    k = 2 * span + 1
    device = cur_tile.device
    cur_tile = cur_tile.to(torch.int32)
    ref_halo = ref_halo.to(torch.int32)
    tl_y, tl_x, blk_h, blk_w = geometry.block_extents(
        y0, x0, nby, nbx, blk_dim, frame_height, frame_width, device
    )
    pix_mask = _tile_masks(
        tile_h, tile_w, y0, x0, frame_height, frame_width, device
    )
    if metric == "ssim":
        # Current-block sums do not depend on the displacement.
        cur_m = cur_tile * pix_mask
        sum_cur = cost_lib.block_reduce(cur_m, blk_dim)
        sum_sq_cur = cost_lib.block_reduce(cur_m * cur_m, blk_dim)
        count = blk_h * blk_w

    def displacement_cost(idx: int) -> torch.Tensor:
        d_y = idx // k - span
        d_x = idx % k - span
        win = ref_halo[
            span + d_y : span + d_y + tile_h, span + d_x : span + d_x + tile_w
        ]
        valid = geometry.displacement_valid(
            d_y, d_x, tl_y, tl_x, blk_h, blk_w, frame_height, frame_width
        )
        if metric == "ssim":
            win_m = win * pix_mask
            score = cost_lib.ssim_from_sums(
                cost_lib.block_reduce(win_m, blk_dim),
                cost_lib.block_reduce(win_m * win_m, blk_dim),
                sum_cur, sum_sq_cur,
                cost_lib.block_reduce(win_m * cur_m, blk_dim),
                count,
            )
            return score.masked_fill(~valid, float("-inf"))
        diff = (cur_tile - win) * pix_mask
        per_px = diff.abs() if metric == "sad" else diff * diff
        return cost_lib.block_reduce(per_px, blk_dim).masked_fill(
            ~valid, cost_lib.INT32_MAX
        )

    return displacement_cost


def scan_argmin(displacement_cost, span: int, shape, device):
    """Raster scan over all K² displacements with strict `<`.

    Starts from (INT32_MAX, centre index), so a block with no valid
    candidate keeps MV (0, 0). Returns int32 (best_cost, best_idx).
    """
    k = 2 * span + 1
    best = torch.full(shape, cost_lib.INT32_MAX, dtype=torch.int32, device=device)
    best_idx = torch.full(shape, span * k + span, dtype=torch.int32, device=device)
    for i in range(k * k):
        cand = displacement_cost(i)
        take = cand < best  # strict < keeps the earliest candidate
        best = torch.where(take, cand, best)
        best_idx = best_idx.masked_fill(take, i)
    return best, best_idx


def scan_argmax(displacement_cost, span: int, shape, device):
    """Raster scan over all K² displacements with strict `>` (SSIM).

    Starts from (0.0, centre index): a block where no candidate scores
    above 0 keeps MV (0, 0), where the reference would read uninitialised
    memory. Returns (float32 best_score, int32 best_idx).
    """
    k = 2 * span + 1
    best = torch.zeros(shape, dtype=torch.float32, device=device)
    best_idx = torch.full(shape, span * k + span, dtype=torch.int32, device=device)
    for i in range(k * k):
        cand = displacement_cost(i)
        take = cand > best  # strict > keeps the earliest candidate
        best = torch.where(take, cand, best)
        best_idx = best_idx.masked_fill(take, i)
    return best, best_idx


def full_search_tile(
    cur_tile,
    ref_halo,
    y0: int,
    x0: int,
    *,
    frame_height: int,
    frame_width: int,
    blk_dim: int,
    span: int,
    metric: str = "mse",
) -> MotionField:
    """Full search over one tile of the current frame.

    cur_tile: [Th, Tw] current-frame tile, Th and Tw multiples of blk_dim
    (pixels beyond the frame are masked); ref_halo as in
    `make_displacement_cost`; (y0, x0): global coordinates of
    cur_tile[0, 0].
    """
    _check_metric(metric)
    cur_tile = to_tensor(cur_tile)
    ref_halo = to_tensor(ref_halo)
    tile_h, tile_w = cur_tile.shape
    if tile_h % blk_dim or tile_w % blk_dim:
        raise ValueError(
            f"tile dims ({tile_h},{tile_w}) must be multiples of blk_dim={blk_dim}"
        )
    nby, nbx = tile_h // blk_dim, tile_w // blk_dim
    displacement_cost = make_displacement_cost(
        cur_tile, ref_halo, y0, x0,
        frame_height=frame_height, frame_width=frame_width,
        blk_dim=blk_dim, span=span, metric=metric,
    )
    if metric == "ssim":
        score, best_idx = scan_argmax(
            displacement_cost, span, (nby, nbx), cur_tile.device
        )
        mv_y, mv_x = geometry.mv_from_flat_index(best_idx, span)
        return MotionField(mv_y, mv_x, best_idx, score)
    best, best_idx = scan_argmin(
        displacement_cost, span, (nby, nbx), cur_tile.device
    )
    _, _, blk_h, blk_w = geometry.block_extents(
        y0, x0, nby, nbx, blk_dim, frame_height, frame_width, cur_tile.device
    )
    return field_from_argmin(best, best_idx, blk_h * blk_w, span, metric)


def field_from_argmin(best, best_idx, count, span: int, metric: str) -> MotionField:
    """Decode MVs from flat indices and score the costs by pixel count."""
    mv_y, mv_x = geometry.mv_from_flat_index(best_idx, span)
    if metric == "sad":
        score = cost_lib.mad_from_sad(best, count)
    else:
        score = cost_lib.mse_from_ssd(best, count)
    return MotionField(mv_y, mv_x, best, score)


def pad_cur_frame(cur, frame_height: int, frame_width: int, blk_dim: int):
    """Zero-pad the current frame to whole blocks (the mask handles the rest)."""
    hp, wp = geometry.padded_dims(frame_height, frame_width, blk_dim)
    return F.pad(
        to_tensor(cur).to(torch.int32),
        (0, wp - frame_width, 0, hp - frame_height),
    )


def full_search_frame(
    cur,
    ref,
    *,
    blk_dim: int,
    span: int,
    metric: str = "mse",
) -> MotionField:
    """Whole-frame full search (single tile, origin 0). cur/ref: [H, W]
    uint8/int32 tensors (or numpy arrays, which run on the CPU)."""
    if tuple(cur.shape) != tuple(ref.shape):
        raise ValueError(
            f"current and reference frames must have identical shapes, "
            f"got {tuple(cur.shape)} vs {tuple(ref.shape)}"
        )
    frame_height, frame_width = cur.shape
    cur_p = pad_cur_frame(cur, frame_height, frame_width, blk_dim)
    ref_halo = make_ref_halo(ref, frame_height, frame_width, blk_dim, span)
    return full_search_tile(
        cur_p, ref_halo, 0, 0,
        frame_height=frame_height, frame_width=frame_width,
        blk_dim=blk_dim, span=span, metric=metric,
    )


def compensate_tile(ref_halo, mv_y, mv_x, *, blk_dim: int, span: int):
    """Motion-compensated tile: comp[p] = ref[p + mv(block(p))].

    Valid candidates are fully in-frame, so the gather from the halo never
    reads out-of-frame pixels for in-frame outputs. Returns [Th, Tw].
    """
    nby, nbx = mv_y.shape
    tile_h, tile_w = nby * blk_dim, nbx * blk_dim
    device = ref_halo.device
    mv_y_p = mv_y.repeat_interleave(blk_dim, 0).repeat_interleave(blk_dim, 1)
    mv_x_p = mv_x.repeat_interleave(blk_dim, 0).repeat_interleave(blk_dim, 1)
    yy = torch.arange(tile_h, device=device)[:, None] + mv_y_p.long() + span
    xx = torch.arange(tile_w, device=device)[None, :] + mv_x_p.long() + span
    return ref_halo[yy, xx]


def compensate_frame(
    ref, field: MotionField, *, frame_height, frame_width, blk_dim, span
):
    """Whole-frame motion compensation, cropped to [H, W] (int32)."""
    ref_halo = make_ref_halo(ref, frame_height, frame_width, blk_dim, span)
    comp = compensate_tile(
        ref_halo, field.mv_y, field.mv_x, blk_dim=blk_dim, span=span
    )
    return comp[:frame_height, :frame_width]
