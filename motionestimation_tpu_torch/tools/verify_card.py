"""Every committed fixture through the card route, against the plain path
and the C reference's outputs.

The port of the JAX package's `tools/verify_tpu.py`, for its fixture cases.
Each case under `tests/fixtures/` (every `*/meta.json`, found by glob) runs
through the search its metric takes on the card, `full_search_frame_cuda`
(MSE, SAD) or `ssim_search_frame_cuda` (SSIM), and through the port's plain
golden search (`search.full_search.full_search_frame`) on the same device.
Checked:

* MVs and integer costs equal to the plain path's; SSIM scores bit-equal;
* the CLI's stacked output (`cli.main`) byte-equal to the fixture's
  `output.yuv`, and its PSNR or score lines, dimensions and echoed config
  equal to the fixture's `stdout.txt`.

Foreman cases hold no frame files: F4 and F1 (their cur and ref) are
planes 1 and 0 of the fixture's `output.yuv`, as every stack begins with
[ref, cur]. Exits 1 on any difference.

    python -m motionestimation_tpu_torch.tools.verify_card [--device cpu] \
        [--fixtures DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import sys
import tempfile

import numpy as np
import torch

from motionestimation_tpu_torch import cli
from motionestimation_tpu_torch.core import frames as frames_lib
from motionestimation_tpu_torch.core.device import resolve_device
from motionestimation_tpu_torch.kernels.full_search_cuda import (
    full_search_frame_cuda,
)
from motionestimation_tpu_torch.kernels.ssim_cuda import ssim_search_frame_cuda
from motionestimation_tpu_torch.search import full_search as fs

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
# The stdout lines compared with the fixture's: the path lines and the
# computation time differ by nature.
COMPARED = ("PSNR:", "Original Score:", "Output file dimensions", "  BlkDim",
            "  ExtraSpan", "  FrameWidth", "  FrameHeight")


def compared_lines(stdout: str) -> list[str]:
    return [line for line in stdout.splitlines() if line.startswith(COMPARED)]


def case_frames(case_dir: str, meta: dict, work: str) -> tuple[str, str]:
    """Paths of the case's cur and ref frames: its own files, or planes 1
    and 0 of its `output.yuv` written into `work`."""
    cur, ref = (os.path.join(case_dir, meta[k]) for k in ("cur", "ref"))
    if os.path.exists(cur) and os.path.exists(ref):
        return cur, ref
    h, w = meta["height"], meta["width"]
    planes = np.fromfile(os.path.join(case_dir, "output.yuv"),
                         np.uint8).reshape(5, h, w)
    name = os.path.basename(case_dir)
    cur, ref = (os.path.join(work, f"{name}_{k}.yuv") for k in ("cur", "ref"))
    planes[1].tofile(cur)
    planes[0].tofile(ref)
    return cur, ref


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


def check_case(case_dir: str, dev: torch.device, work: str) -> list[str]:
    """The differences found for one fixture case (empty when it passes)."""
    with open(os.path.join(case_dir, "meta.json")) as f:
        meta = json.load(f)
    blk, span, metric = meta["blk_dim"], meta["span"], meta["metric"]
    h, w = meta["height"], meta["width"]
    cur_path, ref_path = case_frames(case_dir, meta, work)
    cur = frames_lib.load_yuv(cur_path, h, w)
    ref = frames_lib.load_yuv(ref_path, h, w)
    if metric == "ssim":
        got = ssim_search_frame_cuda(cur, ref, blk_dim=blk, span=span,
                                     device=dev)
    else:
        got = full_search_frame_cuda(cur, ref, blk_dim=blk, span=span,
                                     metric=metric, device=dev)
    want = fs.full_search_frame(torch.from_numpy(cur).to(dev),
                                torch.from_numpy(ref).to(dev), blk_dim=blk,
                                span=span, metric=metric)
    diffs = []
    keys = (("mv_y", "mv_x", "score") if metric == "ssim"
            else ("mv_y", "mv_x", "best_cost_i32"))
    for key in keys:
        if not _equal(getattr(got, key), getattr(want, key)):
            diffs.append(f"{key} differs from the plain path")

    out_dir = os.path.join(work, os.path.basename(case_dir))
    argv = [cur_path, ref_path, out_dir, str(blk), str(span), str(w), str(h),
            "--device", dev.type, "--metric", metric]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        diffs.append(f"cli.main returned {rc}")
    with open(os.path.join(case_dir, "stdout.txt")) as f:
        want_lines = compared_lines(f.read())
    got_lines = compared_lines(buf.getvalue())
    if got_lines != want_lines:
        diffs.append(f"stdout lines {got_lines} != fixture's {want_lines}")
    stack_path = frames_lib.output_filename(out_dir, blk, span)
    golden = os.path.join(case_dir, "output.yuv")
    with open(stack_path, "rb") as a, open(golden, "rb") as b:
        if a.read() != b.read():
            diffs.append("stacked output differs from the fixture's "
                         "output.yuv")
    return diffs


def verify(fixtures: str = FIXTURES, device=None) -> dict[str, list[str]]:
    """{case name: differences} for every fixture case under `fixtures`, on
    `device` (default "cuda"), printing one line per case."""
    dev = resolve_device(device)
    cases = sorted(os.path.dirname(p)
                   for p in glob.glob(os.path.join(fixtures, "*", "meta.json")))
    if not cases:
        raise FileNotFoundError(f"no fixture cases under {fixtures}")
    results = {}
    with tempfile.TemporaryDirectory(prefix="verify_card_") as work:
        for case_dir in cases:
            name = os.path.basename(case_dir)
            diffs = check_case(case_dir, dev, work)
            results[name] = diffs
            print(f"{'OK  ' if not diffs else 'FAIL'} {name}"
                  + "".join(f"\n     {d}" for d in diffs))
    failed = sum(1 for d in results.values() if d)
    print(f"{len(results) - failed}/{len(results)} fixture cases exact on "
          f"{dev}")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--fixtures", default=FIXTURES)
    args = p.parse_args(argv)
    results = verify(args.fixtures, args.device)
    return 1 if any(results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
