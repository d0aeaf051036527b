#!/bin/bash
# Sequential A/B sweep of the port (one variant per process; see
# tools/ab_torch.py), the five variants of tools/ab_driver.sh.
# Usage: tools/ab_driver_torch.sh <out.jsonl> <model> [<model>...]
# On the CPU, run one variant of tools/ab_torch.py with --device cpu instead.
out="$1"; shift
cd "$(dirname "$0")/.."
for model in "$@"; do
  for v in "highest auto" "high auto" "default auto" "highest off" "high off"; do
    set -- $v
    prec=$1; edge=$2
    tag="${prec}_${edge}"
    echo "=== $model $tag $(date +%H:%M:%S)" >> "$out.log"
    timeout 1500 python tools/ab_torch.py --model "$model" --precision "$prec" \
      --edge "$edge" --iters 200 --tag "$tag" \
      2>> "$out.log" | tail -1 >> "$out"
  done
done
echo DONE >> "$out"
