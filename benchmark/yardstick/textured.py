"""Textured frames for the diamond cells, made from the run's seed.

A copy, without JAX or numpy, of the frames of the JAX matrix's adversarial
rows (`_synth` in the port's `bench/matrix.py`, which `matrix_frames` calls
with shift (28, -28) and noise 2 for `diamond-worstcase-4k`), carried on
into a GOP as `content.gop_frames` carries its own: frame 0 a texture of
`texture` x `texture` squares of uniform random grey plus gaussian noise
of unit deviation, truncated to 0..255; then each frame the previous one
moved by `shift` (rows, columns; what is pushed out wraps round) plus
uniform integer noise in [-noise, noise], clipped to 0..255.

Over such a texture a block's costs change smoothly from one displacement
to the next, so diamond walks run far from (0, 0) and escape the staged
levels; over `content.gop_frames`' independent pixels they stop within a
few steps.
"""
from __future__ import annotations

import torch

# Seeds reach a little past 2**31; a generator takes any value below 2**64.
_SEED_MOD = 2**64


def gop_frames(seed: int, count: int, height: int, width: int, *,
               shift=(28, -28), noise: int = 2, texture: int = 4,
               device="cpu") -> torch.Tensor:
    """uint8 [count, height, width] on `device`: frame 0 textured, frame k
    frame k - 1 moved by `shift` plus noise in [-noise, noise]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % _SEED_MOD)
    squares = torch.randint(0, 256, (-(-height // texture),
                                     -(-width // texture)),
                            generator=gen, device=device).float()
    grey = squares.repeat_interleave(texture, 0).repeat_interleave(
        texture, 1)[:height, :width]
    out = torch.empty((count, height, width), dtype=torch.uint8,
                      device=device)
    out[0] = (grey + torch.randn((height, width), generator=gen,
                                 device=device)).clamp_(0, 255).to(
        torch.uint8)
    for k in range(1, count):
        moved = torch.roll(out[k - 1], tuple(shift), (0, 1)).to(torch.int16)
        jitter = torch.randint(-noise, noise + 1, (height, width),
                               generator=gen, device=device,
                               dtype=torch.int16)
        out[k] = (moved + jitter).clamp_(0, 255).to(torch.uint8)
    return out
