"""diamond.level_device_ms: the card time of the operations launched
inside the program's `me.level` spans (a staged diamond level: its volume
and its replay), per search call (`me.search`), in ms."""


def read(run):
    if run.trace is None:
        return None
    calls = len(run.trace.spans("me.search"))
    ops = run.trace.launched_in("me.level")
    if not calls or not ops:
        return None
    return sum(b - a for a, b, _, _ in ops) / calls * 1e3
