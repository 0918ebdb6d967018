"""A one-step check of the card route, and a multi-slot dry run.

The port of the JAX package's `__graft_entry__.py`:

* `entry()` returns the flagship step (whole-frame MSE full search on the
  CUDA kernels, then motion compensation) with its example frames;
* `dryrun_multichip(n)` runs the sharded step over a mesh of n slots at
  hard shapes and holds every result against the unsharded port.

Both run on the CUDA card unless the caller passes `device="cpu"`, which
runs the kernels' plain versions on the CPU.

    python -m motionestimation_tpu_torch.graft_entry [N] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import math
import sys

import numpy as np
import torch

from motionestimation_tpu_torch.core import frames as frames_lib
from motionestimation_tpu_torch.core import geometry
from motionestimation_tpu_torch.core.device import resolve_device
from motionestimation_tpu_torch.kernels.full_search_cuda import (
    full_search_frame_cuda,
)
from motionestimation_tpu_torch.kernels.ssim_cuda import ssim_search_frame_cuda
from motionestimation_tpu_torch.parallel.mesh import make_mesh
from motionestimation_tpu_torch.parallel.sharded import (
    gather,
    sharded_motion_step,
)
from motionestimation_tpu_torch.search import diamond
from motionestimation_tpu_torch.search import full_search as fs


def entry(device=None):
    """(step, (cur, ref)): `step(cur, ref)` runs the CIF 288x352 16x16 +-7
    MSE full search on the card route and compensates the reference,
    returning (mv_y, mv_x, int32 best cost, int32 comp [288, 352]); the
    frames are the JAX entry's, made from seed 0, as uint8 tensors on
    `device` (default "cuda")."""
    dev = resolve_device(device)
    blk_dim, span, h, w = 16, 7, 288, 352

    def step(cur, ref):
        field = full_search_frame_cuda(cur, ref, blk_dim=blk_dim, span=span,
                                       metric="mse", device=dev)
        comp = fs.compensate_frame(ref, field, frame_height=h,
                                   frame_width=w, blk_dim=blk_dim, span=span)
        return field.mv_y, field.mv_x, field.best_cost_i32, comp

    rng = np.random.default_rng(0)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = np.clip(
        np.roll(ref, (2, -3), (0, 1)).astype(np.int32)
        + rng.integers(-5, 6, (h, w)),
        0, 255,
    ).astype(np.uint8)
    return step, (torch.from_numpy(cur).to(dev), torch.from_numpy(ref).to(dev))


def _factor_mesh(n: int):
    """Split n slots into (dp, ty, tx): the spatial axes as square as
    possible, dp = 2 when n is even and at least 8 (the JAX split)."""
    dp = 2 if (n % 2 == 0 and n >= 8) else 1
    m = n // dp
    ty = int(math.isqrt(m))
    while m % ty:
        ty -= 1
    return dp, ty, m // ty


def _slots(n: int, dev: torch.device) -> list[torch.device]:
    """n slot devices: the CPU n times; else the first n visible cards, or
    `dev` n times when there are fewer."""
    if dev.type == "cpu":
        return [dev] * n
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_geometry(n_devices: int) -> dict:
    """The dry run's mesh split and shapes for n slots: dp, ty, tx, the
    frame's h and w (8*ty-3 x 8*tx-3), blk_dim 8, span 9 and the batch
    (2*dp)."""
    dp, ty, tx = _factor_mesh(n_devices)
    return dict(dp=dp, ty=ty, tx=tx, h=8 * ty - 3, w=8 * tx - 3, blk_dim=8,
                span=9, batch=2 * dp)


def dryrun_multichip(n_devices: int, device=None,
                     around_sharded=None) -> str:
    """Run the sharded step on an n-slot ("dp", "ty", "tx") mesh at hard
    shapes and hold it against the unsharded port; returns a summary line
    and raises RuntimeError on the first difference. `around_sharded`, a
    context manager, is entered around the three sharded steps and their
    gathers alone (not the unsharded runs they are held against), to count
    what they launch.

    The frame is 8*ty-3 x 8*tx-3 at blk 8 (truncated bottom row and right
    column, searched by the truncated-extent kernels inside their tiles)
    with span 9, wider than a tile (multi-hop halos on both axes), and a
    batch of 2*dp pairs. Checked for every batch element: the full MSE
    step's MVs, costs, compensated frame and the PSNR of its reduced
    stats against `full_search_frame_cuda`, `compensate_frame` and
    `image_psnr`; diamond against `diamond_search_frame`; SSIM MVs against
    `ssim_search_frame_cuda`. The sharded steps run the kernels' tile
    entries (backend "cuda"; their plain versions on the CPU).
    """
    dev = resolve_device(device)
    g = dryrun_geometry(n_devices)
    dp, ty, tx, h, w, blk_dim, span, batch = (
        g[k] for k in ("dp", "ty", "tx", "h", "w", "blk_dim", "span",
                       "batch"))
    mesh = make_mesh(dp, ty, tx, devices=_slots(n_devices, dev))
    rng = np.random.default_rng(1)
    refs = rng.integers(0, 256, (batch, h, w), dtype=np.uint8)
    curs = np.clip(
        refs.astype(np.int32) + rng.integers(-6, 7, refs.shape), 0, 255
    ).astype(np.uint8)
    nby, nbx = geometry.grid_shape(h, w, blk_dim)
    kw = dict(mesh=mesh, blk_dim=blk_dim, span=span, frame_height=h,
              frame_width=w, backend="cuda")

    def host(t):
        return t.cpu().numpy()

    with around_sharded or contextlib.nullcontext():
        res, res_d, res_s = (
            gather(sharded_motion_step(curs, refs, **kw, **step))
            for step in (dict(metric="mse"),
                         dict(metric="mse", algorithm="diamond"),
                         dict(metric="ssim")))
    _require(tuple(res.mv_y.shape[:1]) == (batch,)
             and res.comp.shape[0] == batch,
             f"result batch {tuple(res.mv_y.shape)}, expected {batch}")
    for b in range(batch):
        cur, ref = (torch.from_numpy(a[b]).to(dev) for a in (curs, refs))
        golden = full_search_frame_cuda(cur, ref, blk_dim=blk_dim, span=span,
                                        metric="mse", device=dev)
        comp = host(fs.compensate_frame(ref, golden, frame_height=h,
                                        frame_width=w, blk_dim=blk_dim,
                                        span=span))
        for what, got, want in (
                ("MVs (y)", res.mv_y[b, :nby, :nbx], golden.mv_y),
                ("MVs (x)", res.mv_x[b, :nby, :nbx], golden.mv_x),
                ("costs", res.best_cost[b, :nby, :nbx],
                 golden.best_cost_i32)):
            _require(np.array_equal(host(got), host(want)),
                     f"sharded {what} != unsharded (batch {b})")
        _require(np.array_equal(host(res.comp[b, :h, :w]), comp),
                 f"sharded compensated frame != unsharded (batch {b})")
        psnr_sharded = frames_lib.psnr_from_stats(
            int(res.sum_sq[b]), h * w, int(res.frame_max[b]))
        psnr_host = frames_lib.image_psnr(comp, curs[b].astype(np.int32))
        _require(psnr_sharded == psnr_host,
                 f"PSNR of the reduced stats {psnr_sharded!r} != "
                 f"{psnr_host!r} (batch {b})")

    for b in range(batch):
        want = diamond.diamond_search_frame(
            curs[b], refs[b], blk_dim=blk_dim, span=span, metric="mse",
            device=dev)
        for what, got, ref_t in (
                ("MVs (y)", res_d.mv_y, want.mv_y),
                ("MVs (x)", res_d.mv_x, want.mv_x),
                ("costs", res_d.best_cost, want.best_cost_i32)):
            _require(np.array_equal(host(got[b, :nby, :nbx]), host(ref_t)),
                     f"sharded diamond {what} != diamond_search_frame "
                     f"(batch {b})")

    for b in range(batch):
        want = ssim_search_frame_cuda(curs[b], refs[b], blk_dim=blk_dim,
                                      span=span, device=dev)
        for what, got, ref_t in (("MVs (y)", res_s.mv_y, want.mv_y),
                                 ("MVs (x)", res_s.mv_x, want.mv_x)):
            _require(np.array_equal(host(got[b, :nby, :nbx]), host(ref_t)),
                     f"sharded SSIM {what} != ssim_search_frame_cuda "
                     f"(batch {b})")

    return (f"dryrun_multichip OK: mesh dp={dp} ty={ty} tx={tx} on "
            f"{sorted({str(d) for d in mesh.devices.flat})}, batch={batch}, "
            f"frame {h}x{w} (truncated edges), blk {blk_dim}, span {span} "
            f"(multi-hop halo), backend=cuda: full search (MVs, costs, "
            f"comp, PSNR of the reduced stats), diamond and SSIM MVs equal "
            f"to the unsharded port for all {batch} batch elements")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    step, example = entry(args.device)
    mv_y, _, cost, comp = step(*example)
    print(f"entry OK: mv_y {tuple(mv_y.shape)}, cost {cost.dtype}, comp "
          f"{tuple(comp.shape)} on {comp.device}")
    print(dryrun_multichip(args.n_devices, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
