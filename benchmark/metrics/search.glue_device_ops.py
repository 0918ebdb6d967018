"""search.glue_device_ops: operations on the card (kernels, copies,
memsets) launched inside the program's `me.search` span and outside its
`me.launch` spans, so by the frame-search wrapper itself, per call."""
from collections import Counter


def read(run):
    if run.trace is None:
        return None
    calls = len(run.trace.spans("me.search"))
    ops = Counter(run.trace.launched_in("me.search"))
    if not calls or not ops:
        return None
    glue = ops - Counter(run.trace.launched_in("me.launch"))
    return sum(glue.values()) / calls
