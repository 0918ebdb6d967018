"""kernels.launch_host_ms: the host's time inside the program's
`me.launch` spans (a kernel's output tensors and its ctypes launch) that
lie inside its `me.search` span, per search call, in ms."""


def read(run):
    if run.trace is None:
        return None
    calls = run.trace.spans("me.search")
    inside = [e - s for s, e, t in run.trace.spans("me.launch")
              if any(a <= s and e <= b and t == tid for a, b, tid in calls)]
    if not calls or not inside:
        return None
    return sum(inside) / len(calls) * 1e3
