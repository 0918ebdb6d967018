"""diamond.escape_wait_host_ms: the host's time inside the program's
`me.escape_wait` spans (its wait on a staged level's escape mask) that lie
inside its `me.search` span, per search call, in ms."""


def read(run):
    if run.trace is None:
        return None
    calls = run.trace.spans("me.search")
    waits = [e - s for s, e, t in run.trace.spans("me.escape_wait")
             if any(a <= s and e <= b and t == tid for a, b, tid in calls)]
    if not calls or not waits:
        return None
    return sum(waits) / len(calls) * 1e3
