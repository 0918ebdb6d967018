#!/usr/bin/env bash
# MSE one-liner of the PyTorch/CUDA port's CLI (scripts/run.sh runs the
# JAX package's):
#   scripts/run_torch.sh CUR.yuv REF.yuv [OUTDIR [BLK [SPAN]]] [CLI options]
# Foreman CIF (352x288), blk 8 +-12 and results/cpu/foreman by default;
# the options (e.g. --device cpu, --timing-row) pass through to the CLI.
set -e
root="$(cd "$(dirname "$0")/.." && pwd)"
if [ $# -lt 2 ]; then
  echo "usage: $0 CUR.yuv REF.yuv [OUTDIR [BLK [SPAN]]] [CLI options]" >&2
  exit 2
fi
cur=$1 ref=$2
shift 2
pos=()
while [ $# -gt 0 ] && [ ${#pos[@]} -lt 3 ] && [[ $1 != -* ]]; do
  pos+=("$1")
  shift
done
PYTHONPATH="$root${PYTHONPATH:+:$PYTHONPATH}" python3 -m motionestimation_tpu_torch.cli \
  "$cur" "$ref" "${pos[0]:-$root/results/cpu/foreman}" "${pos[1]:-8}" \
  "${pos[2]:-12}" 352 288 "$@"
