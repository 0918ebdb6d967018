"""search.device_ops: operations on the card (kernels, copies, memsets)
launched inside one search call, over the traced calls."""


def read(run):
    if run.trace is None:
        return None
    calls = len(run.trace.spans("search"))
    if not calls:
        return None
    return len(run.trace.launched_in("search")) / calls
