"""kernels.roofline_pct: the search's least time (`yardstick.roofline`,
from the cell's shapes) over the card time of every kernel launched inside
the harness's "search" spans, in %, over the traced calls."""
from benchmark.yardstick import roofline


def read(run):
    if run.trace is None:
        return None
    calls = len(run.trace.spans("search"))
    kernel_s = sum(b - a for a, b, _, cat in run.trace.launched_in("search")
                   if cat == "kernel")
    if not calls or kernel_s <= 0:
        return None
    cfg = run.cell.config
    h, w = cfg["frame_height"], cfg["frame_width"]
    bound_ms, _ = roofline.bound(h, w, cfg["blk_dim"], cfg["span"], (h, w),
                                 (0, 0), ssim=cfg["metric"] == "ssim")
    return 100.0 * calls * bound_ms * 1e-3 / kernel_s
