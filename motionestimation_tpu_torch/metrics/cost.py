"""Cost metrics: SSD/MSE, SAD/MAD and SSIM over exact integer block sums.

Costs are exact int32 sums (SSD of a 32x32 block reaches 255²·1024 >
2²⁴, past what float32 holds exactly); only the reported mean score and
the SSIM score are float32. `ssim_from_sums` evaluates the SSIM formula
one IEEE float32 operation at a time, in the order the CUDA kernels
(kernels/csrc/ssim.cu) evaluate it, so both give the same bits.
"""
from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1

# The reference's SSIM constants (ssim.c:47), rounded to float32 where used.
SSIM_C1 = 0.01
SSIM_C2 = 0.09
SSIM_C3 = 0.045


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


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.

    `torch.sqrt` on float32 CPU tensors is not correctly rounded on every
    build (vectorised approximations); the float64 root rounded once to
    float32 is, on any device, since float64 carries more than twice
    float32's precision.
    """
    return x.double().sqrt().float()


def ssim_from_sums(sum_ref, sum_sq_ref, sum_cur, sum_sq_cur, sum_cross, count):
    """SSIM score from exact int32 block sums over the in-frame extent.

    sum_ref / sum_sq_ref: Σx and Σx² of the reference candidate; sum_cur /
    sum_sq_cur: those of the current block; sum_cross: Σ ref·cur; count:
    in-frame pixels (0 counts as 1). Returns float32 L·C·S with

      L = (2·Mr·Mc + C1) / (Mr² + Mc² + C1)
      C = (2·σr·σc + C2) / (σr·σr + σc·σc + C2)
      S = (CrossVar + C3) / (σr·σc + C3)

    The reference's quirks are kept: the cross-variance uses the means
    truncated to int (trunc of the float32 mean, not Σx // N), and the
    variance is the biased /N one, centred on the truncated mean so that
    it stays exact in float32 (the int32 parts are exact; only the
    fractional correction rounds), clamped at 0 before the root.
    """
    f32 = torch.float32
    c1 = torch.tensor(SSIM_C1, dtype=f32, device=sum_ref.device)
    c2 = torch.tensor(SSIM_C2, dtype=f32, device=sum_ref.device)
    c3 = torch.tensor(SSIM_C3, dtype=f32, device=sum_ref.device)
    count = torch.as_tensor(count, dtype=torch.int32, device=sum_ref.device)
    n_i = torch.clamp(count, min=1)
    n = n_i.to(f32)
    mean_ref = sum_ref.to(f32) / n
    mean_cur = sum_cur.to(f32) / n
    imean_ref = mean_ref.to(torch.int32)  # truncation toward zero
    imean_cur = mean_cur.to(torch.int32)

    def centred_var(sum_x, sum_sq, imean, mean):
        csq = sum_sq - 2 * imean * sum_x + n_i * imean * imean  # exact int32
        cs = sum_x - n_i * imean  # exact int32
        frac = mean - imean.to(f32)  # exact, in [0, 1)
        num = csq.to(f32) - 2.0 * frac * cs.to(f32) + n * frac * frac
        return num / n

    def std_dev(var):  # the clamp guards a tiny negative rounding residue
        return _sqrt_rn(torch.clamp(var, min=0.0))

    std_ref = std_dev(centred_var(sum_ref, sum_sq_ref, imean_ref, mean_ref))
    std_cur = std_dev(centred_var(sum_cur, sum_sq_cur, imean_cur, mean_cur))
    cross_sum = (
        sum_cross
        - imean_cur * sum_ref
        - imean_ref * sum_cur
        + count * imean_ref * imean_cur
    )
    cross_var = cross_sum.to(f32) / n
    luminance = (2.0 * mean_ref * mean_cur + c1) / (
        mean_ref * mean_ref + mean_cur * mean_cur + c1
    )
    # σr·σr, not the variance: the reference squares the rounded root.
    contrast = (2.0 * std_ref * std_cur + c2) / (
        std_ref * std_ref + std_cur * std_cur + c2
    )
    structure = (cross_var + c3) / (std_ref * std_cur + c3)
    return luminance * contrast * structure
