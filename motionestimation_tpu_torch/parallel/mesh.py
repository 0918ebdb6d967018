"""Device mesh for spatial and batch parallelism.

The port of `motionestimation_tpu.parallel.mesh`. One mesh, three axes:

  "dp" — batch of frame pairs (a GOP), pure data parallelism
  "ty" — frame tiles, vertical
  "tx" — frame tiles, horizontal

Each ("ty", "tx") slot owns an [Hp/ty, Wp/tx] tile of both frames and
needs a halo of `span` reference pixels beyond its tile, exchanged with its
mesh neighbours (`parallel.halo`).

A slot is a torch device and the rank of the process that owns it. A
device may fill several slots: `[cuda:0] * 4` is a 2x2 mesh on one card,
whose exchanges are copies on that card, and `[cpu] * 8` is the tests'
stand-in for eight devices (as the JAX tests' virtual CPU devices are).
Slots of different ranks exchange through `torch.distributed`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "ty", "tx")


def process_group() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) outside a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A ("dp", "ty", "tx") array of slots: `devices` (torch.device) and
    `ranks` (the owning process), each a [dp, ty, tx] numpy object / int
    array; `shape` maps an axis name to its size, as a JAX `Mesh` does."""

    def __init__(self, devices: np.ndarray, ranks: np.ndarray):
        if devices.ndim != 3 or devices.shape != ranks.shape:
            raise ValueError("devices and ranks must be [dp, ty, tx] arrays")
        self.devices = devices
        self.ranks = ranks
        self.shape = dict(zip(AXES, devices.shape))
        self.rank, self.world_size = process_group()

    @property
    def platform(self) -> str:
        """"cuda" when every slot is a CUDA device, "cpu" when every one is
        the CPU; mixed meshes raise."""
        kinds = {d.type for d in self.devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh of mixed device types {sorted(kinds)}")
        return kinds.pop()

    def slots(self):
        """Every slot's (d, iy, ix), in mesh order."""
        return [tuple(int(i) for i in s) for s in np.ndindex(*self.ranks.shape)]

    def local_slots(self):
        """The (d, iy, ix) of this process's slots, in mesh order."""
        return [s for s in self.slots() if self.ranks[s] == self.rank]

    def __repr__(self):
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]}, "
                f"ranks={self.ranks.ravel().tolist()})")


def _default_devices() -> list[torch.device]:
    """This process's share of "every visible CUDA device": all of them on
    one process; under a process group of several, the current device
    alone (NCCL takes one device per rank)."""
    if not torch.cuda.is_available():
        return []
    if process_group()[1] > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(dp: int = 1, ty: int = 1, tx: int = 1, *,
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """Build a ("dp", "ty", "tx") mesh (the port of `make_mesh`,
    mesh.py:27).

    `devices` lists this process's devices (default: the visible CUDA
    devices, `_default_devices`). Under a process group every rank lists
    its own and the mesh takes the ranks' lists in rank order, so "ty"
    varies slowest across processes and each rank owns whole tile rows.
    The first dp*ty*tx of them fill the mesh in row-major order; fewer
    raise ValueError, as the JAX function does.
    """
    local = [torch.device(d) for d in (
        _default_devices() if devices is None else devices)]
    rank, world = process_group()
    if world > 1:
        gathered: list = [None] * world
        dist.all_gather_object(gathered, [str(d) for d in local])
        owned = [(r, torch.device(d)) for r, ds in enumerate(gathered)
                 for d in ds]
    else:
        owned = [(0, d) for d in local]
    n = dp * ty * tx
    if min(dp, ty, tx) < 1:
        raise ValueError(f"mesh axes must be >= 1, got {dp}x{ty}x{tx}")
    if len(owned) < n:
        raise ValueError(
            f"mesh {dp}x{ty}x{tx} needs {n} devices, have {len(owned)}")
    devs = np.empty(n, dtype=object)
    devs[:] = [d for _, d in owned[:n]]
    ranks = np.array([r for r, _ in owned[:n]], dtype=np.int64)
    return Mesh(devs.reshape(dp, ty, tx), ranks.reshape(dp, ty, tx))
