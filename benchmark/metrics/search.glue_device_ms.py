"""search.glue_device_ms: the card time of the operations launched inside
the program's `me.search` span and outside its `me.launch` spans (the
wrapper's pad, copies, merge and decode), per call, in ms."""
from collections import Counter


def read(run):
    if run.trace is None:
        return None
    calls = len(run.trace.spans("me.search"))
    ops = Counter(run.trace.launched_in("me.search"))
    if not calls or not ops:
        return None
    glue = ops - Counter(run.trace.launched_in("me.launch"))
    return sum((b - a) * n for (a, b, _, _), n in glue.items()) / calls * 1e3
