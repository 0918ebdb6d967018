"""One process of the port's two-process sharded run
(tests/test_torch_multihost.py).

Usage: python torch_multihost_worker.py <rank> <world> <port> <out_dir> [cuda]

Each process lists four slots, CPU slots on gloo, or with "cuda" slots of
card `rank` on NCCL (one card a rank); together they form a (1, 2 *
world, 2) mesh whose "ty" axis spans the ranks, so halos cross the rank
boundaries. Each rank feeds only its own frame rows
(`ingest.local_row_range`), runs `sharded_motion_step` (full search on both
backends, SSIM, diamond), gathers the results to every rank and checks
them against the unsharded port on the same frames, then gathers them to
rank 0 alone (the others must get None, and rank 0 the same results);
then a `run_gop_sharded` GOP that each rank reads row by row from disk,
whose dumps rank 0 holds against the port's `run_gop`. Prints
"TORCH_MULTIHOST_OK rank=<rank>" when every check passed.
"""
import os
import sys

rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
on_card = sys.argv[5:] == ["cuda"]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from motionestimation_tpu_torch.core.config import SearchConfig  # noqa: E402
from motionestimation_tpu_torch.parallel import halo, ingest  # noqa: E402
from motionestimation_tpu_torch.parallel import make_mesh  # noqa: E402
from motionestimation_tpu_torch.parallel import sharded  # noqa: E402
from motionestimation_tpu_torch.pipeline import runner  # noqa: E402
from motionestimation_tpu_torch.search import diamond  # noqa: E402
from motionestimation_tpu_torch.search import full_search as fs  # noqa: E402

torch.set_num_threads(1)
ingest.distributed_init(f"127.0.0.1:{port}", world, rank,
                        backend="nccl" if on_card else "gloo")
slot = torch.device("cuda", rank) if on_card else torch.device("cpu")
mesh = make_mesh(1, 2 * world, 2, devices=[slot] * 4)
assert mesh.ranks.ravel().tolist() == [r for r in range(world)
                                       for _ in range(4)], mesh


def check(name, got, want):
    got = got.cpu()
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"rank {rank}: {name} differs")


def frames(h, w, seed):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = np.clip(np.roll(ref, (2, -3), (0, 1)).astype(np.int32)
                  + rng.integers(-5, 6, (h, w)), 0, 255).astype(np.uint8)
    return cur, ref


for h, w, blk, span in [(64, 64, 8, 4), (60, 52, 8, 5)]:
    cur, ref = frames(h, w, h + w)
    hp, wp = sharded.padded_dims_for_mesh(h, w, blk, mesh)
    lo, hi = ingest.local_row_range(mesh, hp)
    assert (lo, hi) == (rank * hp // world, (rank + 1) * hp // world), (lo, hi)

    def local(x):
        return np.pad(x, ((0, hp - h), (0, wp - w)))[None, lo:hi]

    cur_s = ingest.put_frame_batch(local(cur), mesh)
    ref_s = ingest.put_frame_batch(local(ref), mesh)
    assert cur_s.shape == (1, hp, wp) and len(cur_s.tiles) == 4

    # The halo across the rank boundary equals the single-card halo.
    want_halo = torch.nn.functional.pad(
        fs.make_ref_halo(ref, h, w, blk, span),
        (0, wp - w - (-(-w // blk) * blk - w), 0,
         hp - h - (-(-h // blk) * blk - h)))
    th, tw = hp // mesh.shape["ty"], wp // mesh.shape["tx"]
    for (d, iy, ix), t in halo.halo_exchange_2d(ref_s.tiles, span,
                                                mesh).items():
        check(f"halo of slot {(d, iy, ix)}", t[0].to(torch.int32),
              want_halo[iy * th : iy * th + th + 2 * span,
                        ix * tw : ix * tw + tw + 2 * span])

    nby, nbx = -(-h // blk), -(-w // blk)
    for metric, algorithm, backend in [("mse", "full", "golden"),
                                       ("mse", "full", "cuda"),
                                       ("ssim", "full", "cuda"),
                                       ("mse", "diamond", "cuda")]:
        local = sharded.sharded_motion_step(
            cur_s, ref_s, mesh=mesh, blk_dim=blk, span=span, metric=metric,
            frame_height=h, frame_width=w, backend=backend,
            algorithm=algorithm)
        res = sharded.gather(local)
        to_lead = sharded.gather(local, dst=0)
        assert (to_lead is None) == (rank != 0), (rank, to_lead)
        for a, b in zip(to_lead or (), res):
            check(f"{h}x{w} {metric} {algorithm} {backend} gathered to rank "
                  f"0", a, b.cpu())
        if algorithm == "diamond":
            want = diamond.diamond_search_frame(
                cur, ref, blk_dim=blk, span=span, metric=metric,
                device="cpu")
        else:
            want = fs.full_search_frame(torch.from_numpy(cur),
                                        torch.from_numpy(ref), blk_dim=blk,
                                        span=span, metric=metric)
        what = f"{h}x{w} {metric} {algorithm} {backend}"
        check(f"{what} mv_y", res.mv_y[0, :nby, :nbx], want.mv_y)
        check(f"{what} mv_x", res.mv_x[0, :nby, :nbx], want.mv_x)
        check(f"{what} cost", res.best_cost[0, :nby, :nbx],
              want.score if metric == "ssim" else want.best_cost_i32)
        comp = fs.compensate_frame(torch.from_numpy(ref), want,
                                   frame_height=h, frame_width=w,
                                   blk_dim=blk, span=span)
        check(f"{what} comp", res.comp[0, :h, :w], comp)
        err = comp.to(torch.int64) - torch.from_numpy(cur).to(torch.int64)
        assert res.sum_sq.device.type == slot.type, what
        assert int(res.sum_sq[0]) == int((err * err).sum()), what
        assert int(res.frame_max[0]) == int(torch.maximum(
            comp, torch.from_numpy(cur).to(torch.int32)).max()), what

# A GOP read row by row on each rank, pipelined and per pair.
h, w = 60, 52
gop = [frames(h, w, 7)[1]]
for _ in range(3):
    gop.append(np.clip(np.roll(gop[-1], (1, -2), (0, 1)).astype(np.int32)
                       + np.random.default_rng(len(gop)).integers(
                           -3, 4, (h, w)), 0, 255).astype(np.uint8))
paths = [os.path.join(out_dir, f"f{i}.yuv") for i in range(len(gop))]
if rank == 0:
    for p, f in zip(paths, gop):
        f.tofile(p)
torch.distributed.barrier()
config = SearchConfig(blk_dim=8, span=5, frame_width=w, frame_height=h)
for pipelined in (True, False):
    got = runner.run_gop_sharded(
        paths, config, mesh=mesh, pipelined=pipelined,
        output_dir=os.path.join(out_dir, f"sharded_{pipelined}"))
    torch.distributed.barrier()
    if rank == 0:
        want = runner.run_gop(paths, config, device="cpu",
                              output_dir=os.path.join(out_dir, "single"))
        for a, b in zip(got, want):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for key in zb.files:
                assert za[key].dtype == zb[key].dtype and np.array_equal(
                    za[key], zb[key]), (pipelined, a, key)

torch.distributed.barrier()
torch.distributed.destroy_process_group()
print(f"TORCH_MULTIHOST_OK rank={rank}")
