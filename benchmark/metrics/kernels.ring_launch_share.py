"""kernels.ring_launch_share: the share of the run's phase-kernel launches
that took the register ring (`full_search_cuda.phase_search.ring_launches`
over its `launches`, read at the end of the run); nothing where the
program has no such counter or launched no phase kernel."""
import sys


def read(run):
    kc = sys.modules.get("motionestimation_tpu_torch.kernels.full_search_cuda")
    search = getattr(kc, "phase_search", None)
    launches = getattr(search, "launches", 0)
    ring = getattr(search, "ring_launches", None)
    if ring is None or not launches:
        return None
    return ring / launches
