#!/usr/bin/env bash
# The XL accuracy campaign with the PyTorch port (the twin of
# scripts/run_campaign_xl.sh): converged S1 -> S2 on the scaled
# self-rendered dataset (render_campaign_xl.sh), evaluated with both the
# H36M protocol (MPJPE family) and the MPI protocol (PCK/AUC via
# dataset_params.eval_protocol).
#
# Usage: scripts/torch/run_campaign_xl.sh [s1|s2|s1ext|s2h0|eval|confident]
# (default: all stages except s1ext/s2h0/confident). s2h0 is the
# confident-mode experiment: S2's finetune with an added 0.5-weight
# hypothesis-0 pull (Campaign_XL_SurS2h0). s1ext is the matched-compute
# control: the S1 checkpoint finetuned 5 more epochs with S1's own losses
# under S2's optimizer schedule (Campaign_XL_SurS1ext), so S1ext and S2
# differ only in the unsupervised loss terms. confident re-runs the
# oracle-free (--multi_hypo confident) eval rows for S1 and S2.
#
# Every location and the per-CLI extra args can be overridden:
#   XAS_CAMPAIGN_CFG_DIR    config directory  (default:
#                           x_as_supervision_tpu_torch/configs)
#   XAS_CAMPAIGN_PREFIX     config filename prefix  (default: Campaign_XL_Sur
#                           -> ${PREFIX}S1.json / S2.json / S1ext.json)
#   XAS_CAMPAIGN_LOG_ROOT   run-dir root      (default: log)
#   XAS_CAMPAIGN_OUT        eval artifact dir (default: log/campaign; the
#                           JAX driver's benchmarks/campaign holds the JAX
#                           package's results and is not written)
#   XAS_CAMPAIGN_TRAIN_ARGS extra train args  (default: --seed 0 --worker 12)
#   XAS_CAMPAIGN_EVAL_ARGS  extra eval args   (default: none)
# The *_ARGS values are split on single spaces: values holding spaces are
# not supported. The configs are JSON: the card's machine has no yaml.
set -uo pipefail
cd "$(dirname "$0")/../.."
STAGE="${1:-all}"
CFG_DIR="${XAS_CAMPAIGN_CFG_DIR:-x_as_supervision_tpu_torch/configs}"
PREFIX="${XAS_CAMPAIGN_PREFIX:-Campaign_XL_Sur}"
LOG_ROOT="${XAS_CAMPAIGN_LOG_ROOT:-log}"
OUT="${XAS_CAMPAIGN_OUT:-log/campaign}"
IFS=' ' read -r -a TRAIN_ARGS <<< "${XAS_CAMPAIGN_TRAIN_ARGS:---seed 0 --worker 12}"
IFS=' ' read -r -a EVAL_ARGS <<< "${XAS_CAMPAIGN_EVAL_ARGS:- }"
mkdir -p "$OUT" "$LOG_ROOT"

# MPI-protocol (PCK@0.15m / AUC) config twin, generated on the fly.
make_mpi_twin() {  # <src-json> <dst-json>
  python - "$1" "$2" <<'PY'
import json
import sys

src, dst = sys.argv[1], sys.argv[2]
with open(src) as f:
    cfg = json.load(f)
cfg["dataset_params"]["eval_protocol"] = "mpi"
with open(dst, "w") as f:
    json.dump(cfg, f, indent=2)
PY
}

latest_run() {  # <stage log dir>: its newest run directory
  ls -dt "$1"/*/ 2>/dev/null | head -1 || true
}

latest_ckpt() {  # <run dir>: its newest {epoch}_ckpt that holds state.pt
  local c
  for c in $(ls -d "$1"*_ckpt 2>/dev/null | sort -r); do
    if [[ -f "$c/state.pt" ]]; then echo "$c"; return 0; fi
  done
}

evaluate() {  # <config> <ckpt> <mode> <run-dir> <artifact>
  python -m x_as_supervision_tpu_torch.eval --config "$1" \
    --checkpoint "$2" --multi_hypo "$3" "${EVAL_ARGS[@]}" || exit 1
  cp "${4}eval/eval_result.txt" "$OUT/${5}.txt"
}

if [[ "$STAGE" == "s1" || "$STAGE" == "all" ]]; then
  scripts/torch/train_resumable.sh "$CFG_DIR/${PREFIX}S1.json" \
    "$LOG_ROOT/campaign_xl_s1" "${TRAIN_ARGS[@]}" || exit 1
fi

S1_RUN=$(latest_run "$LOG_ROOT/campaign_xl_s1")
S1_CKPT=""
if [[ -n "${S1_RUN}" ]]; then
  S1_CKPT=$(latest_ckpt "${S1_RUN}")
fi
echo "S1 ckpt: ${S1_CKPT:-<none>}"

# The finetune stages are meaningless without the S1 init: an empty
# XAS_INIT_CKPT reads as "unset" to the driver, which would silently
# train the matched-compute control from scratch.
if [[ ( "$STAGE" == "s2" || "$STAGE" == "s1ext" || "$STAGE" == "s2h0" ) \
      && -z "$S1_CKPT" ]]; then
  echo "[campaign] no S1 checkpoint under $LOG_ROOT/campaign_xl_s1;" \
       "run the s1 stage first" >&2
  exit 1
fi

if [[ "$STAGE" == "s2" || "$STAGE" == "all" ]]; then
  # while campaign_xl_s2 has no checkpoint of its own, every retry
  # initializes from the S1 checkpoint (XAS_INIT_CKPT); once S2 has
  # saved, retries resume its own newest checkpoint
  XAS_INIT_CKPT="${S1_CKPT}" \
    scripts/torch/train_resumable.sh "$CFG_DIR/${PREFIX}S2.json" \
      "$LOG_ROOT/campaign_xl_s2" "${TRAIN_ARGS[@]}" || exit 1
fi

# S1-initialized finetune variant (the matched-compute control S1ext,
# the confident-mode experiment S2h0): train from the S1 checkpoint,
# then eval best + MPI-protocol + confident rows.
finetune_variant() {  # <Variant> (config suffix, e.g. S1ext / S2h0)
  local v=$1 lv run ckpt
  lv=$(echo "$v" | tr '[:upper:]' '[:lower:]')
  XAS_INIT_CKPT="${S1_CKPT}" \
    scripts/torch/train_resumable.sh "$CFG_DIR/${PREFIX}${v}.json" \
      "$LOG_ROOT/campaign_xl_${lv}" "${TRAIN_ARGS[@]}" || exit 1
  run=$(latest_run "$LOG_ROOT/campaign_xl_${lv}")
  ckpt=$(latest_ckpt "${run}")
  make_mpi_twin "$CFG_DIR/${PREFIX}${v}.json" \
    "$LOG_ROOT/${PREFIX}${v}_mpi.json" || exit 1
  evaluate "$CFG_DIR/${PREFIX}${v}.json" "$ckpt" best "$run" \
    "xl_eval_${lv}"
  evaluate "$LOG_ROOT/${PREFIX}${v}_mpi.json" "$ckpt" best "$run" \
    "xl_eval_${lv}_mpi"
  evaluate "$CFG_DIR/${PREFIX}${v}.json" "$ckpt" confident "$run" \
    "xl_eval_${lv}_confident"
}

if [[ "$STAGE" == "s1ext" ]]; then
  finetune_variant S1ext
fi
if [[ "$STAGE" == "s2h0" ]]; then
  finetune_variant S2h0
  exit 0
fi

S2_RUN=$(latest_run "$LOG_ROOT/campaign_xl_s2")
S2_CKPT=""
if [[ -n "${S2_RUN}" ]]; then
  S2_CKPT=$(latest_ckpt "${S2_RUN}")
fi
echo "S2 ckpt: ${S2_CKPT:-<none>}"

eval_stage() {  # <stage-number> <ckpt> <run-dir>
  local s=$1 ckpt=$2 run=$3
  if [[ -z "$ckpt" ]]; then
    echo "[campaign] stage S${s}: no checkpoint yet, skipping eval"
    return 0
  fi
  evaluate "$CFG_DIR/${PREFIX}S${s}.json" "$ckpt" best "$run" \
    "xl_eval_s${s}"
  make_mpi_twin "$CFG_DIR/${PREFIX}S${s}.json" \
    "$LOG_ROOT/${PREFIX}S${s}_mpi.json" || exit 1
  evaluate "$LOG_ROOT/${PREFIX}S${s}_mpi.json" "$ckpt" best "$run" \
    "xl_eval_s${s}_mpi"
}
if [[ "$STAGE" == "confident" ]]; then
  eval_confident() {  # <stage-number> <ckpt> <run-dir>
    local s=$1 ckpt=$2 run=$3
    if [[ -z "$ckpt" ]]; then
      echo "[campaign] stage S${s}: no checkpoint yet, skipping confident"
      return 0
    fi
    evaluate "$CFG_DIR/${PREFIX}S${s}.json" "$ckpt" confident "$run" \
      "xl_eval_s${s}_confident"
  }
  eval_confident 1 "${S1_CKPT}" "${S1_RUN}"
  eval_confident 2 "${S2_CKPT}" "${S2_RUN}"
  exit 0
fi

if [[ "$STAGE" != "s1ext" ]]; then
  eval_stage 1 "${S1_CKPT}" "${S1_RUN}"
  eval_stage 2 "${S2_CKPT}" "${S2_RUN}"
fi

for f in xl_eval_s1 xl_eval_s2 xl_eval_s1_mpi xl_eval_s2_mpi; do
  if [[ -f "$OUT/$f.txt" ]]; then echo "=== $f ==="; cat "$OUT/$f.txt"; fi
done
exit 0
