"""Write results/h100/scaling.txt: the predicted 1 -> N scaling of the
port's sharded step at 4K, from rates measured on one card.

The port of the JAX package's `tools/record_scaling.py`. It evaluates the
model of `parallel/scaling.py` at the measured rates and writes its curves:
the GOP over hosts (pairs batched over hosts, the (2, 4) spatial mesh in
each), kernel-bound and at the measured host-to-card rate, at 4K 8x8 +-12
and 16x16 +-15; one frame tiled over (1, 2) to (4, 8) meshes; the
pipelined GOP on the same meshes; and the per-term split of the (2, 2),
(2, 4) and (4, 8) single-pair steps. Every rate is an argument (no default): a card's
M blocks/s at the two cells (its frame time over the frame's blocks) and
its pinned host-to-card MB/s. The card's name and power limit stand beside
every number.

    python -m motionestimation_tpu_torch.tools.record_scaling \
        --headline MBLOCKS_8x8 --north MBLOCKS_16x16 --ingest-mb-s MBPS \
        [--card "NAME, POWER"] [--out PATH]

Without --card it asks nvidia-smi, and fails on a machine without a card.
"""
from __future__ import annotations

import argparse
import os
import sys

from motionestimation_tpu_torch.parallel import scaling

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "results", "h100", "scaling.txt")
H, W = 2160, 3840
HOSTS = [1, 2, 4, 8, 16]
MESHES = [(1, 2), (2, 2), (2, 4), (4, 4), (4, 8)]
SPLITS = [(2, 2), (2, 4), (4, 8)]


def report(headline: float, north: float, ingest_mb_s: float,
           card: str) -> str:
    """The text of scaling.txt for the measured rates on `card`."""
    cell = dict(frame_height=H, frame_width=W, blk_dim=8, span=12)
    gop_h = scaling.gop_scaling_efficiency(
        **cell, n_hosts=HOSTS, measured_mblocks_per_s=headline)
    gop_h_e2e = scaling.gop_scaling_efficiency(
        **cell, n_hosts=HOSTS, measured_mblocks_per_s=headline,
        host_ingest_mb_s=ingest_mb_s)
    gop_n = scaling.gop_scaling_efficiency(
        frame_height=H, frame_width=W, blk_dim=16, span=15, n_hosts=HOSTS,
        measured_mblocks_per_s=north)
    spatial = scaling.scaling_efficiency(
        **cell, meshes=MESHES, measured_mblocks_per_s=headline)
    overlap = scaling.spatial_gop_overlap_efficiency(
        **cell, meshes=MESHES, measured_mblocks_per_s=headline)
    host = scaling.model_step(**cell, ty=2, tx=4,
                              measured_mblocks_per_s=headline)
    ingest_s = H * W / (ingest_mb_s * 1e6)
    at = f"| {card}"
    lines = [
        "# Predicted 1->N scaling efficiency of the port's sharded step at "
        "4K on HGX H100 hosts.",
        "# Model: motionestimation_tpu_torch/parallel/scaling.py (its "
        "docstring cites the link constants).",
        "# Compute from the measured single-card rate below; halo, stats "
        "and gather bytes from the arrays",
        "# the port's step moves (mesh-padded uint8 tiles, the busiest "
        "card). The gather is one collective:",
        "# a GOP's grids to rank 0 (no compensated frame); a single pair's "
        "grids and int32 comp to every card.",
        "# The pipelined GOP hides each next frame's halo behind the "
        "search, in chunks of 8 pairs; host issue",
        "# of each tile's launches left out. Written by "
        "motionestimation_tpu_torch/tools/record_scaling.py.",
        f"# Measured on {card}: {headline} M blocks/s at 4K 8x8 +-12, "
        f"{north} M blocks/s at 4K 16x16 +-15,",
        f"# pinned host-to-card {ingest_mb_s} MB/s.",
        f"[ GOP over hosts, 4K 8x8 +-12, {headline} M blocks/s/card, "
        f"kernel-bound ingest {at} ]",
    ]
    lines += [f"hosts {n:3d}  efficiency {gop_h[n]:.4f} {at}" for n in HOSTS]
    lines += [
        f"[ GOP over hosts, 4K 8x8 +-12, at the measured {ingest_mb_s} "
        f"MB/s/host ingest {at} ]",
        f"# ingest {ingest_s * 1e3:.4f} ms/frame vs step "
        f"{host.step_s * 1e3:.4f} ms on the (2, 4) host mesh {at}",
    ]
    lines += [f"hosts {n:3d}  efficiency {gop_h_e2e[n]:.4f} {at}"
              for n in HOSTS]
    lines.append(f"[ GOP over hosts, 4K 16x16 +-15, {north} M blocks/s/card, "
                 f"kernel-bound {at} ]")
    lines += [f"hosts {n:3d}  efficiency {gop_n[n]:.4f} {at}" for n in HOSTS]
    lines.append(f"[ spatial tiling, 4K 8x8 +-12, single pair "
                 f"(sharded_full_search) {at} ]")
    lines += [f"chips {ty * tx:3d} ({ty}x{tx})  efficiency "
              f"{spatial[ty * tx]:.4f} {at}" for ty, tx in MESHES]
    lines.append(f"[ spatial tiling, 4K 8x8 +-12, pipelined GOP "
                 f"(run_gop_sharded: next halo under the search, grids to "
                 f"rank 0) {at} ]")
    lines += [f"chips {ty * tx:3d} ({ty}x{tx})  efficiency "
              f"{overlap[ty * tx]:.4f} {at}" for ty, tx in MESHES]
    for ty, tx in SPLITS:
        m = scaling.model_step(**cell, ty=ty, tx=tx,
                               measured_mblocks_per_s=headline)
        lines.append(f"[ step split, 4K 8x8 +-12, ({ty}, {tx}) mesh, single "
                     f"pair{', crosses hosts' if m.crosses_hosts else ''} "
                     f"{at} ]")
        lines += [
            f"compute {m.compute_s * 1e3:.6f} ms {at}",
            f"halo    {m.halo_s * 1e3:.6f} ms ({m.halo_bytes} B sent by the "
            f"busiest card) {at}",
            f"stats   {m.stats_s * 1e3:.6f} ms (two all-reduces) {at}",
            f"gather  {m.gather_s * 1e3:.6f} ms ({m.gather_bytes} B "
            f"received by each card, one all-gather) {at}",
            f"step    {m.step_s * 1e3:.6f} ms {at}",
        ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--headline", type=float, required=True,
                   help="measured M blocks/s at 4K 8x8 +-12")
    p.add_argument("--north", type=float, required=True,
                   help="measured M blocks/s at 4K 16x16 +-15")
    p.add_argument("--ingest-mb-s", type=float, required=True,
                   help="measured pinned host-to-card MB/s")
    p.add_argument("--card", default=None,
                   help="the card's name and power limit (default: "
                   "nvidia-smi's)")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    card = args.card
    if card is None:
        from motionestimation_tpu_torch.bench import measure
        card = measure.card()
    text = report(args.headline, args.north, args.ingest_mb_s, card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}")
    print(text, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
