"""Cost metrics: SSD/MSE and SAD/MAD over exact integer block sums.

Costs are exact int32 sums (SSD of a 32x32 block reaches 255²·1024 >
2²⁴, past what float32 holds exactly); only the reported mean score is
float32. The SSIM score (`ssim_from_sums`) comes with the SSIM slice.
"""
from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def block_reduce(x: torch.Tensor, blk_dim: int) -> torch.Tensor:
    """Sum a [..., nby*blk, nbx*blk] int32 array into per-block [..., nby, nbx]."""
    *lead, hp, wp = x.shape
    nby, nbx = hp // blk_dim, wp // blk_dim
    return x.reshape(*lead, nby, blk_dim, nbx, blk_dim).sum(
        dim=(-3, -1), dtype=torch.int32
    )


def mse_from_ssd(ssd: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """MSE = SSD / (w*h) in float32; 0-count padding blocks map to 0."""
    denom = torch.clamp(count, min=1).to(torch.float32)
    return ssd.to(torch.float32) / denom


def mad_from_sad(sad: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Mean absolute difference = SAD / (w*h) in float32.

    The SAD metric itself is the exact integer Σ|cur-ref|; this mean is the
    reported score, as MSE relates to SSD.
    """
    denom = torch.clamp(count, min=1).to(torch.float32)
    return sad.to(torch.float32) / denom
