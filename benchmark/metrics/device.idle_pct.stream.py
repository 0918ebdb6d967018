"""device.idle_pct.stream: the share of the traced window in which no
kernel, copy or memset ran on the card, in %."""


def read(run):
    return run.trace.idle_pct() if run.trace is not None else None
