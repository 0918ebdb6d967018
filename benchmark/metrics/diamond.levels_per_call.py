"""diamond.levels_per_call: the staged diamond levels run per search call
(`search.diamond._diamond_staged.levels` over `diamond_search_frame.calls`,
read at the end of the run); nothing where the program has no such
counters or made no diamond call."""
import sys


def read(run):
    module = sys.modules.get("motionestimation_tpu_torch.search.diamond")
    calls = getattr(getattr(module, "diamond_search_frame", None), "calls", 0)
    levels = getattr(getattr(module, "_diamond_staged", None), "levels", None)
    if levels is None or not calls:
        return None
    return levels / calls
