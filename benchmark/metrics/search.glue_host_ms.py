"""search.glue_host_ms: the host's time inside the program's `me.search`
span less the part its `me.launch` spans cover, so the frame-search
wrapper's own host time, over the traced calls, in ms."""
from benchmark.yardstick.trace import union


def read(run):
    if run.trace is None:
        return None
    calls = run.trace.spans("me.search")
    if not calls:
        return None
    launches = run.trace.spans("me.launch")
    glue_s = 0.0
    for a, b, tid in calls:
        covered = union((max(s, a), min(e, b)) for s, e, t in launches
                        if t == tid and s < b and e > a)
        glue_s += (b - a) - sum(e - s for s, e in covered)
    return glue_s / len(calls) * 1e3
