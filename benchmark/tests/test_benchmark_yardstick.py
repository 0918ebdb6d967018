"""The yardstick on the CPU: the roofline against hand counts at the three
configurations, the reference against a loop over blocks and candidates,
the frames' generator, and the trace's arithmetic on made-up events."""
from __future__ import annotations


import numpy as np
import pytest
import torch

from benchmark.yardstick import content, reference, roofline
from benchmark.yardstick.trace import WINDOW, Trace, union

FRAME = (2160, 3840)


def _hand(blk, span):
    """Valid offsets summed over an axis's blocks, by hand: every block
    has 2 * span + 1 but the first and last few, which lose the offsets
    that leave the frame (span - tl for each top-left tl < span)."""
    def axis(n):
        blocks = n // blk
        lost = sum(span - tl for tl in range(0, span, blk))
        return blocks * (2 * span + 1) - 2 * lost
    return axis(FRAME[0]), axis(FRAME[1])


@pytest.mark.parametrize("blk, span, ssim, by", [
    (8, 12, False, "bytes"), (16, 7, True, "bytes"),
    (16, 15, False, "operations")])
def test_bound_against_hand_counts(blk, span, ssim, by):
    h, w = FRAME
    ny, nx = _hand(blk, span)
    blocks = (h // blk) * (w // blk)
    nbytes = h * w + (h + 2 * span) * (w + 2 * span) + 8 * blocks
    ops_ms = 2 * (ny * blk) * (nx * blk) / 1979e12 * 1e3
    if ssim:
        ops_ms = max(ops_ms, 34 * ny * nx / 67e12 * 1e3)
    want = max(nbytes / 3.35e12 * 1e3, ops_ms)
    got, got_by = roofline.bound(h, w, blk, span, FRAME, (0, 0), ssim=ssim)
    assert got == pytest.approx(want, rel=1e-12) and got_by == by


def test_hand_counts_by_number():
    # 4K 8x8 +-12: rows 270 * 25 - 2 * (12 + 4), columns 480 * 25 - 32.
    assert _hand(8, 12) == (6718, 11968)
    assert _hand(16, 7) == (2011, 3586)
    assert _hand(16, 15) == (4155, 7410)
    assert roofline.bound(2160, 3840, 8, 12, FRAME, (0, 0))[0] == \
        pytest.approx(17_770_176 / 3.35e12 * 1e3)


def _loop_search(cur, ref, blk, span, metric):
    """Every block, every candidate, in raster order, with numpy."""
    h, w = cur.shape
    cur = cur.astype(np.int64)
    ref = ref.astype(np.int64)
    nby, nbx = -(-h // blk), -(-w // blk)
    out = {k: np.zeros((nby, nbx), np.int64) for k in ("y", "x", "c")}
    best_s = np.full((nby, nbx), -np.inf, np.float32)
    for by in range(nby):
        for bx in range(nbx):
            y0, x0 = by * blk, bx * blk
            bh, bw = min(blk, h - y0), min(blk, w - x0)
            c = cur[y0:y0 + bh, x0:x0 + bw]
            best = (2**31 - 1, 0, 0) if metric != "ssim" else None
            for dy in range(-span, span + 1):
                for dx in range(-span, span + 1):
                    if not (0 <= y0 + dy <= h - bh and 0 <= x0 + dx <= w - bw):
                        continue
                    r = ref[y0 + dy:y0 + dy + bh, x0 + dx:x0 + dx + bw]
                    if metric == "ssim":
                        t = lambda a: torch.tensor([[int(a)]], dtype=torch.int32)
                        s = float(reference.ssim_score(
                            t(r.sum()), t((r * r).sum()), t(c.sum()),
                            t((c * c).sum()), t((r * c).sum()),
                            t(bh * bw))[0, 0])
                        if best is None or s > best[0]:
                            best = (s, dy, dx)
                        continue
                    d = c - r
                    cost = int((d * d).sum() if metric == "mse"
                               else np.abs(d).sum())
                    if cost < best[0]:
                        best = (cost, dy, dx)
            out["y"][by, bx], out["x"][by, bx] = best[1], best[2]
            if metric == "ssim":
                best_s[by, bx] = best[0]
            else:
                out["c"][by, bx] = best[0]
    return out, best_s


@pytest.mark.parametrize("metric", ["mse", "sad", "ssim"])
@pytest.mark.parametrize("h, w, blk, span", [(24, 40, 8, 3), (21, 30, 8, 2),
                                             (20, 20, 16, 5)])
def test_reference_against_loop(metric, h, w, blk, span):
    frames = content.gop_frames(11, 2, h, w).numpy()
    cur, ref = frames[1], frames[0]
    want, want_s = _loop_search(cur, ref, blk, span, metric)
    ct, rt = torch.from_numpy(cur), torch.from_numpy(ref)
    if metric == "ssim":
        my, mx, idx, score = reference.ssim_search(ct, rt, blk=blk, span=span)
        k = 2 * span + 1
        assert np.array_equal(idx.numpy(), (want["y"] + span) * k
                              + want["x"] + span)
        assert np.array_equal(score.numpy().view(np.int32),
                              want_s.view(np.int32))
    else:
        my, mx, cost = reference.full_search(ct, rt, blk=blk, span=span,
                                             metric=metric)
        assert np.array_equal(cost.numpy(), want["c"])
    assert np.array_equal(my.numpy(), want["y"])
    assert np.array_equal(mx.numpy(), want["x"])


def test_ties_keep_the_first_in_raster_order():
    flat = torch.full((16, 16), 7, dtype=torch.uint8)
    my, mx, cost = reference.full_search(flat, flat, blk=8, span=4)
    # Every valid candidate costs 0: the first valid one in raster order.
    assert my.tolist() == [[0, 0], [-4, -4]]
    assert mx.tolist() == [[0, -4], [0, -4]]
    assert int(cost.max()) == 0


def test_frames_follow_the_seed():
    a = content.gop_frames(2**31 + 5, 3, 16, 24)
    b = content.gop_frames(2**31 + 5, 3, 16, 24)
    c = content.gop_frames(2**31 + 6, 3, 16, 24)
    assert torch.equal(a, b) and not torch.equal(a, c)
    moved = torch.roll(a[0], (1, -2), (0, 1)).int()
    assert int((a[1].int() - moved).abs().max()) <= 3


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def test_trace_arithmetic():
    events = [
        _ev(WINDOW, "user_annotation", 0, 100),
        _ev("search", "user_annotation", 10, 10),
        _ev("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=1),
        _ev("cudaMemsetAsync", "cuda_runtime", 14, 1, correlation=2),
        _ev("wait_chunk", "user_annotation", 60, 30),
        _ev("cudaLaunchKernel", "cuda_runtime", 65, 1, correlation=3),
        _ev("k1", "kernel", 20, 30, correlation=1),
        _ev("memset", "gpu_memset", 40, 20, correlation=2),
        _ev("k2", "kernel", 95, 20, correlation=3),   # ends past the window
    ]
    tr = Trace(events)
    assert union([(3, 5), (1, 2), (4, 6)]) == [(1, 2), (3, 6)]
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(45e-6)        # 20..60 and 95..100
    assert tr.idle_pct() == pytest.approx(55.0)
    assert len(tr.spans("search")) == 1
    inside = tr.launched_in("search")
    assert sorted(op for *_, op, _ in inside) == ["k1", "memset"]
    assert tr.top_device_ops()[0][0] == "k1"
    gaps = dict(tr.idle_gaps())
    assert gaps["search"] == pytest.approx(20e-6)
    assert gaps["wait_chunk"] == pytest.approx(35e-6)
