#!/usr/bin/env bash
# The port's convergence capstone on one CUDA card, then the readings taken
# on its trained flagship, each bounded by `timeout` so that what was banked
# is still written out when a later step is cut:
#
#   1. scripts/torch_convergence_capstone.py with the schedule SCHEDULE names
#      (CAPSTONE_ARGS replaces it) → <out>/torch_convergence.json, .md
#   2. scripts/torch_bf16_converged_quality.py --eval-only (the eval dtype)
#   3. scripts/torch_bf16_chain_split.py --checkpoint <flagship> (the bf16
#      chain's split and chip_smoke's hold_bf16 on the trained weights)
#   4. scripts/torch_bf16_converged_quality.py (the train-dtype half), if
#      TRAIN_DTYPE_SECONDS > 0
#   5. scripts/torch_validation_reading.py --experiment <flagship> (its
#      validation ADE through each path, beside the test split's)
#
#   bash scripts/torch_capstone_card.sh [out_dir] [root]
#
# SCHEDULE=cut (the default) is a quarter of the JAX run's steps a stage, to
# fit one call; SCHEDULE=full is the JAX run's own (docs/convergence.json →
# config), ~3 h on an H100, run across calls: CAPSTONE_SECONDS is this call's
# time for step 1 (the capstone's phase markers and the CLIs' resume carry
# the run into the next call, which starts where the cut one stopped).
# Stage 1 at the full schedule takes ~3 800 s on an H100 (0.246 s a step):
# more than one call.
# PARALLEL_VARIANTS="k50_motion k50_latent" trains those variants at once
# after stage 1 (each in its own process, evaluated on its EMA and its live
# weights) and merges the report from their stage files; the first of them
# is kept if the others would overrun the budget.  An entry <variant>:fp32
# trains that variant with an fp32 stage 2 (--stage2-dtype fp32, named
# <variant>_fp32): "k50_motion k50_latent k50_motion:fp32 k50_latent:fp32"
# reads check (b)'s first leg in both dtypes on one AutoEncoder (the merged
# report's `stage2_dtype`).
# Times (seconds) come from CAPSTONE_SECONDS, BF16_EVAL_SECONDS (600),
# CHAIN_SPLIT_SECONDS (900), TRAIN_DTYPE_SECONDS (0), READING_SECONDS (600);
# a step given 0 is skipped.  The logs
# and JSON files land in out_dir (default output/capstone_report), the
# checkpoints under root (default output/torch_capstone).  A call on a
# machine that is thrown away afterwards carries stage 1 to the next one
# through out_dir/carry/out_ae (the AutoEncoder's latest and best
# checkpoints, its log and host state; ~50 MB) while stage 1 or a variant of
# PARALLEL_VARIANTS is unfinished: move it back to root/out_ae before the
# next call.  Stage 2's checkpoints (~0.5 GB each)
# do not travel, so a stage-2 variant trains within one call.
set -u
cd "$(dirname "$0")/.."
OUT=${1:-output/capstone_report}
ROOT=${2:-output/torch_capstone}
case "${SCHEDULE:-cut}" in
  cut) SCHED="--ae-epochs 60 --ae-iters 64 --ae-gamma 0.92 --diff-epochs 30 --diff-iters 64 --diff-gamma 0.9 --diff-warmup 5 --eval-freq 5" ;;
  full) SCHED="--ae-epochs 120 --ae-iters 128 --ae-gamma 0.94 --diff-epochs 60 --diff-iters 128 --diff-gamma 0.94 --diff-warmup 10 --eval-freq 10" ;;
  *) echo "SCHEDULE is cut or full, not ${SCHEDULE}" >&2; exit 2 ;;
esac
CUT=${CAPSTONE_ARGS:-$SCHED}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)' \
  | tee -a "$OUT/card.txt"

start=$(date +%s)
budget=${CAPSTONE_SECONDS:-2400}
if [ -z "${PARALLEL_VARIANTS:-}" ]; then
  # shellcheck disable=SC2086
  timeout -k 20 "$budget" python3 scripts/torch_convergence_capstone.py \
    --root "$ROOT" --out-json "$OUT/torch_convergence.json" $CUT >> "$OUT/capstone.log" 2>&1
  echo "capstone rc=$? after $(( $(date +%s) - start )) s"
else
  # stage 1 and the ZeroVelocity eval in one process, then the variants of
  # PARALLEL_VARIANTS at once on the card, each in its own process and report
  # directory (with its eval on the live weights), then one report merged
  # from their stage files.  The first variant is kept: while it runs, the
  # others are stopped as soon as its epochs so far say it would not finish
  # within the budget beside them.
  # shellcheck disable=SC2086
  timeout -k 20 "$budget" python3 scripts/torch_convergence_capstone.py \
    --root "$ROOT" --out-json "$OUT/stage1/torch_convergence.json" $CUT --variants \
    >> "$OUT/capstone.log" 2>&1
  echo "capstone stage 1 rc=$? after $(( $(date +%s) - start )) s"
  dirs="$OUT/stage1"
  if [ -f "$OUT/stage1/stage_zero_velocity.json" ]; then
    epochs=$(echo "$CUT" | sed -n 's/.*--diff-epochs \([0-9]*\).*/\1/p')
    t0=$(date +%s)
    deadline=$(( start + budget ))
    pids=""
    tags=""
    for v in $PARALLEL_VARIANTS; do
      # <variant>[:<stage-2 dtype>]; a variant trained in fp32 is <variant>_fp32
      name=${v%%:*}; dtype=bf16
      [ "$v" != "$name" ] && dtype=${v#*:}
      tag=$name; [ "$dtype" != bf16 ] && tag=${name}_$dtype
      # shellcheck disable=SC2086
      timeout -k 20 $(( deadline - t0 )) python3 scripts/torch_convergence_capstone.py \
        --root "$ROOT" --out-json "$OUT/$tag/torch_convergence.json" $CUT --variants "$name" \
        --stage2-dtype "$dtype" --live-eval >> "$OUT/capstone_$tag.log" 2>&1 &
      pids="$pids $!"
      dirs="$dirs $OUT/$tag"
      tags="$tags $tag"
    done
    first=${pids# }; first=${first%% *}
    others=${pids# }; others=${others#"$first"}
    kept=${tags# }; kept=${kept%% *}
    while kill -0 "$first" 2>/dev/null && [ -n "$others" ]; do
      sleep 30
      e=$(grep -c '"prefix": "train"' "$ROOT/out_diff_$kept/metrics.jsonl" 2>/dev/null)
      if [ "${e:-0}" -ge 2 ] && [ -n "$epochs" ]; then
        end=$(( t0 + ($(date +%s) - t0) * epochs / e ))
        if [ "$end" -gt $(( deadline - 120 )) ]; then
          echo "$kept: epoch $e of $epochs, projected end $(( end - start )) s of $budget:" \
               "stopping the others after $(( $(date +%s) - start )) s"
          # shellcheck disable=SC2086
          kill $others 2>/dev/null
          others=""
        fi
      fi
    done
    wait
    echo "variants done after $(( $(date +%s) - start )) s"
  fi
  # shellcheck disable=SC2086
  python3 scripts/torch_convergence_capstone.py --merge $dirs \
    --out-json "$OUT/torch_convergence.json" >> "$OUT/capstone.log" 2>&1
  echo "merge rc=$?"
fi
grep -a "\[capstone\]\|Error\|error\|Traceback" "$OUT"/capstone*.log | tail -40
unfinished=""
[ -f "$ROOT/out_ae/CAPSTONE_DONE" ] || unfinished="stage 1"
for tag in ${tags:-}; do
  [ -f "$ROOT/out_diff_$tag/CAPSTONE_DONE" ] || unfinished="$unfinished $tag"
done
if [ -d "$ROOT/out_ae" ] && [ -n "$unfinished" ]; then
  # stage 1 cut by the budget, or a variant of PARALLEL_VARIANTS unfinished
  # (a stage-2 variant restarts in the next call on this stage 1), for the
  # next call: its log, config and host state, and of its checkpoints the
  # latest (to resume) and the best (the one stage 2 loads); ~45 MB
  echo "carrying stage 1 to the next call: unfinished $unfinished"
  rm -rf "$OUT/carry" && mkdir -p "$OUT/carry"
  cp -r "$ROOT/timings" "$OUT/carry/" 2>/dev/null
  python3 - "$ROOT/out_ae" "$OUT/carry/out_ae" <<'PY'
import json, os, shutil, sys
src, dst = sys.argv[1:]
keep = set()
index = os.path.join(src, "checkpoints", "index.json")
if os.path.exists(index):
    entries = json.load(open(index))
    scored = [e for e in entries if e["score"] is not None]
    keep = {e["name"] + ".pt" for e in entries if e["name"].startswith("latest")}
    if scored:
        keep.add(max(scored, key=lambda e: e["score"])["name"] + ".pt")
shutil.copytree(src, dst, ignore=lambda d, names: [
    n for n in names if n.startswith("events.out.tfevents") or n == "code_snapshot.zip"
    or (d.endswith("checkpoints") and n.endswith((".pt", ".tmp")) and n not in keep)])
print("carried", sorted(keep))
PY
fi
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
  if [ "${READING_SECONDS:-600}" -gt 0 ]; then
    t=$(date +%s)
    timeout -k 20 "${READING_SECONDS:-600}" python3 scripts/torch_validation_reading.py \
      --experiment "$flagship" --out "$OUT/validation_reading.json" > "$OUT/validation_reading.log" 2>&1
    echo "validation reading rc=$? after $(( $(date +%s) - t )) s"
    grep -a "ADE\|Error" "$OUT/validation_reading.log" | grep -v "^{" | cut -c1-300
  fi
  if [ "${BF16_EVAL_SECONDS:-600}" -gt 0 ]; then
    t=$(date +%s)
    timeout -k 20 "${BF16_EVAL_SECONDS:-600}" python3 scripts/torch_bf16_converged_quality.py \
      --eval-only --root "$ROOT" --out "$OUT/torch_bf16_eval_quality.json" > "$OUT/bf16_eval.log" 2>&1
    echo "bf16 eval-dtype rc=$? after $(( $(date +%s) - t )) s"
    tail -3 "$OUT/bf16_eval.log"
  fi
  if [ "${CHAIN_SPLIT_SECONDS:-900}" -gt 0 ]; then
    t=$(date +%s)
    timeout -k 20 "${CHAIN_SPLIT_SECONDS:-900}" python3 scripts/torch_bf16_chain_split.py \
      --checkpoint "$flagship" > "$OUT/chain_split_trained.log" 2>&1
    echo "chain split rc=$? after $(( $(date +%s) - t )) s"
    grep -a "plain vs fp32\|kernels:\|step by step\|hold_bf16\|with injected noise" \
      "$OUT/chain_split_trained.log" | cut -c1-400
  fi
  if [ "${TRAIN_DTYPE_SECONDS:-0}" -gt 0 ]; then
    t=$(date +%s)
    timeout -k 20 "$TRAIN_DTYPE_SECONDS" python3 scripts/torch_bf16_converged_quality.py \
      --root "$ROOT" --out "$OUT/torch_bf16_eval_quality.json" > "$OUT/bf16_train.log" 2>&1
    echo "bf16 train-dtype rc=$? after $(( $(date +%s) - t )) s"
    tail -3 "$OUT/bf16_train.log"
  fi
fi
echo "total $(( $(date +%s) - start )) s"
