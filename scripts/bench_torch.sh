#!/usr/bin/env bash
# Versioned benchmark harness of the PyTorch/CUDA port, mirroring the
# reference's src/gpu/run.sh (scripts/bench.sh runs the JAX package's):
#   scripts/bench_torch.sh -v <version> --frames-dir DIR [-b blkDim] \
#       [-s extraSpan] [--matrix]
# The per-sequence rows go to results/h100/sequences/v<version>.txt, the
# matrix to results/h100/v<version>.txt: two version series, kept apart.
set -e
cd "$(dirname "$0")/.."
python3 -m motionestimation_tpu_torch.bench "$@"
