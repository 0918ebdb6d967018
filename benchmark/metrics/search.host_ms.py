"""search.host_ms: the host's wall time of one search call (the harness's
clock around the call, no sync inside), over the traced calls, in ms."""


def read(run):
    calls = run.counters.get("search_calls", 0)
    if not calls:
        return None
    return run.counters["search_host_s"] / calls * 1e3
