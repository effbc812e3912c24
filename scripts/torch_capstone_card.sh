#!/usr/bin/env bash
# The port's convergence capstone on one CUDA card, then the readings taken
# on its trained flagship, each bounded by `timeout` so that what was banked
# is still written out when a later step is cut:
#
#   1. scripts/torch_convergence_capstone.py with the cut schedule below
#      (override it with CAPSTONE_ARGS) → <out>/torch_convergence.json, .md
#   2. scripts/torch_bf16_converged_quality.py --eval-only (the eval dtype)
#   3. scripts/torch_bf16_chain_split.py --checkpoint <flagship> (the bf16
#      chain's split and chip_smoke's hold_bf16 on the trained weights)
#   4. scripts/torch_bf16_converged_quality.py (the train-dtype half), if
#      TRAIN_DTYPE_SECONDS > 0
#
#   bash scripts/torch_capstone_card.sh [out_dir] [root]
#
# Times (seconds) come from CAPSTONE_SECONDS, TRAIN_DTYPE_SECONDS; the logs
# and JSON files land in out_dir (default output/capstone_report), the
# checkpoints under root (default output/torch_capstone).
set -u
cd "$(dirname "$0")/.."
OUT=${1:-output/capstone_report}
ROOT=${2:-output/torch_capstone}
CUT=${CAPSTONE_ARGS:---ae-epochs 60 --ae-iters 64 --ae-gamma 0.92 --diff-epochs 30 --diff-iters 64 --diff-gamma 0.9 --diff-warmup 5 --eval-freq 5}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)' \
  | tee -a "$OUT/card.txt"

start=$(date +%s)
# shellcheck disable=SC2086
timeout -k 20 "${CAPSTONE_SECONDS:-2400}" python3 scripts/torch_convergence_capstone.py \
  --root "$ROOT" --out-json "$OUT/torch_convergence.json" $CUT > "$OUT/capstone.log" 2>&1
echo "capstone rc=$? after $(( $(date +%s) - start )) s"
grep -a "\[capstone\]\|Error\|error" "$OUT/capstone.log" | tail -40
for d in "$ROOT"/out_*; do
  [ -f "$d/metrics.jsonl" ] && grep -a '"prefix": "\(train\|valid\)"' "$d/metrics.jsonl" \
    > "$OUT/metrics_$(basename "$d").jsonl"
done
if [ -f "$OUT/torch_convergence.json" ]; then
  python3 scripts/torch_convergence_report.py --json "$OUT/torch_convergence.json" \
    --out "$OUT/torch_convergence.md"
fi

flagship="$ROOT/out_diff_k50_motion"
if [ -f "$flagship/CAPSTONE_DONE" ]; then
  t=$(date +%s)
  timeout -k 20 600 python3 scripts/torch_bf16_converged_quality.py --eval-only --root "$ROOT" \
    --out "$OUT/torch_bf16_eval_quality.json" > "$OUT/bf16_eval.log" 2>&1
  echo "bf16 eval-dtype rc=$? after $(( $(date +%s) - t )) s"
  tail -3 "$OUT/bf16_eval.log"
  t=$(date +%s)
  timeout -k 20 900 python3 scripts/torch_bf16_chain_split.py --checkpoint "$flagship" \
    > "$OUT/chain_split_trained.log" 2>&1
  echo "chain split rc=$? after $(( $(date +%s) - t )) s"
  grep -a "plain vs fp32\|kernels:\|step by step\|hold_bf16\|with injected noise" \
    "$OUT/chain_split_trained.log" | cut -c1-400
  if [ "${TRAIN_DTYPE_SECONDS:-0}" -gt 0 ]; then
    t=$(date +%s)
    timeout -k 20 "$TRAIN_DTYPE_SECONDS" python3 scripts/torch_bf16_converged_quality.py \
      --root "$ROOT" --out "$OUT/torch_bf16_eval_quality.json" > "$OUT/bf16_train.log" 2>&1
    echo "bf16 train-dtype rc=$? after $(( $(date +%s) - t )) s"
    tail -3 "$OUT/bf16_train.log"
  fi
fi
echo "total $(( $(date +%s) - start )) s"
