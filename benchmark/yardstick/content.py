"""The frames every cell searches, made from the run's seed.

A copy, without JAX, of the JAX bench's headline GOP (`bench.py`, its
`gop_fps_4k` frames): a frame of uniform random pixels, then each frame the
previous one moved by `shift` (rows, columns; the rows and columns pushed
out wrap round) plus uniform integer noise in [-noise, noise], clipped to
0..255. Here the pixels come from a `torch.Generator` on the frames' device,
so one seed gives one set of frames on that device.
"""
from __future__ import annotations

import torch

# Seeds reach a little past 2**31; a generator takes any value below 2**64.
_SEED_MOD = 2**64


def gop_frames(seed: int, count: int, height: int, width: int, *,
               shift=(1, -2), noise: int = 3, device="cpu") -> torch.Tensor:
    """uint8 [count, height, width] on `device`: frame 0 random, frame k
    frame k - 1 moved by `shift` plus noise in [-noise, noise]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % _SEED_MOD)
    out = torch.empty((count, height, width), dtype=torch.uint8,
                      device=device)
    out[0] = torch.randint(0, 256, (height, width), generator=gen,
                           device=device, dtype=torch.uint8)
    for k in range(1, count):
        moved = torch.roll(out[k - 1], tuple(shift), (0, 1)).to(torch.int16)
        jitter = torch.randint(-noise, noise + 1, (height, width),
                               generator=gen, device=device,
                               dtype=torch.int16)
        out[k] = (moved + jitter).clamp_(0, 255).to(torch.uint8)
    return out
