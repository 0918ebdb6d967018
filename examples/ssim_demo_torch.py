"""Standalone single-pair SSIM demo of the PyTorch/CUDA port.

The port of `examples/ssim_demo.py`: SSIM between two random 16x16 blocks
with the reference's scratch-prototype conventions, integer constants
C1=2, C2=2, C3=1 and the unbiased /(N-1) variance, rather than the search's
C1=.01/C2=.09/C3=.045 with the biased /N variance. In float32 torch, on
the CUDA card unless --device cpu is given.

    python examples/ssim_demo_torch.py [seed] [--device cpu]
"""
import argparse
import sys

import numpy as np
import torch


def ssim_unbiased(block_a: torch.Tensor, block_b: torch.Tensor) -> torch.Tensor:
    """SSIM with the demo's conventions: float means, the square root of
    the unbiased variance, integer constants; a float32 scalar."""
    a = block_a.to(torch.float32)
    b = block_b.to(torch.float32)
    n = a.numel()
    mu_a = torch.sum(a) / n
    mu_b = torch.sum(b) / n
    sigma_a = torch.sqrt(torch.sum((a - mu_a) ** 2) / (n - 1))
    sigma_b = torch.sqrt(torch.sum((b - mu_b) ** 2) / (n - 1))
    sigma_ab = torch.sum((a - mu_a) * (b - mu_b)) / (n - 1)
    c1, c2, c3 = 2.0, 2.0, 1.0
    luminance = (2 * mu_a * mu_b + c1) / (mu_a**2 + mu_b**2 + c1)
    contrast = (2 * sigma_a * sigma_b + c2) / (sigma_a**2 + sigma_b**2 + c2)
    structure = (sigma_ab + c3) / (sigma_a * sigma_b + c3)
    return luminance * contrast * structure


def blocks(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Two [16, 16] blocks of values 10..19 (the reference's rand()%10 +
    10), made from `seed` as the JAX demo makes them."""
    rng = np.random.default_rng(seed)
    return rng.integers(10, 20, (16, 16)), rng.integers(10, 20, (16, 16))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("seed", nargs="?", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu")
    block_a, block_b = (torch.from_numpy(x).to(args.device)
                        for x in blocks(args.seed))
    value = float(ssim_unbiased(block_a, block_b))
    print(f"SSIM VALUE OBTAINED IS {value:f} ")
    ident = float(ssim_unbiased(block_a, block_a))
    print(f"(self-SSIM sanity: {ident:f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
