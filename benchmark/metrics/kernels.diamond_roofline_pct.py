"""kernels.diamond_roofline_pct: the canonical diamond's least time
(`yardstick.diamond_roofline`, from the plain reference's trajectories of
the traced pairs, which the driver hands over as `bound_ms_traced` over
`bound_pairs`) over the card time of every kernel launched inside the
harness's "search" spans, in %, over the traced calls."""


def read(run):
    if run.trace is None:
        return None
    bound_ms = run.counters.get("bound_ms_traced")
    pairs = run.counters.get("bound_pairs")
    calls = len(run.trace.spans("search"))
    kernel_s = sum(b - a for a, b, _, cat in run.trace.launched_in("search")
                   if cat == "kernel")
    if not bound_ms or not pairs or not calls or kernel_s <= 0:
        return None
    return 100.0 * calls * bound_ms / pairs * 1e-3 / kernel_s
