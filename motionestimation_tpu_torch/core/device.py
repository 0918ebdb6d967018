"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU. A
machine without CUDA raises instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def to_tensor(x, device: torch.device | str | None = None) -> torch.Tensor:
    """A tensor on `device` (where it lies when None) from a tensor or array.

    Read-only or strided numpy arrays (e.g. `np.frombuffer` planes) are
    copied first, since `torch.from_numpy` needs a writable array.
    """
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if not (a.flags.c_contiguous and a.flags.writeable):
            a = a.copy()
        x = torch.from_numpy(a)
    return x if device is None else x.to(device)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`device`, or "cuda" when None; raises if CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev
