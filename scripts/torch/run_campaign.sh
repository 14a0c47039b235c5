#!/usr/bin/env bash
# S1 -> S2 accuracy campaign driver of the PyTorch port (the twin of
# scripts/run_campaign.sh; self-rendered data: render_campaign_xl.sh or
# python -m x_as_supervision_tpu_torch.tools.render_campaign).
#
# Stage 2 only: assumes the S1 run under log/campaign_s1 has finished.
# Usage: scripts/torch/run_campaign.sh [--skip-eval-s1]
set -euo pipefail
cd "$(dirname "$0")/../.."
CFG=x_as_supervision_tpu_torch/configs

latest_ckpt() {  # <run dir>: its newest {epoch}_ckpt that holds state.pt
  local c
  for c in $(ls -d "$1"*_ckpt 2>/dev/null | sort -r); do
    if [[ -f "$c/state.pt" ]]; then echo "$c"; return 0; fi
  done
}

S1_RUN=$(ls -dt log/campaign_s1/*/ | head -1)
S1_CKPT=$(latest_ckpt "${S1_RUN}")
echo "S1 run: ${S1_RUN} ckpt: ${S1_CKPT}"

if [[ "${1:-}" != "--skip-eval-s1" ]]; then
  python -m x_as_supervision_tpu_torch.eval \
    --config "$CFG/Campaign_SurS1.json" \
    --checkpoint "${S1_CKPT}" --multi_hypo best
  cp "${S1_RUN}eval/eval_result.txt" log/campaign_eval_s1.txt
fi

# first attempt initializes from the S1 checkpoint (finetune mode);
# crash retries resume campaign_s2's own newest checkpoint (train mode)
python -m x_as_supervision_tpu_torch.train \
  --config "$CFG/Campaign_SurS2.json" --finetune \
  --checkpoint "${S1_CKPT}" --seed 0 --log_dir log/campaign_s2 --worker 12 \
  || scripts/torch/train_resumable.sh "$CFG/Campaign_SurS2.json" \
       log/campaign_s2 --seed 0 --worker 12

S2_RUN=$(ls -dt log/campaign_s2/*/ | head -1)
S2_CKPT=$(latest_ckpt "${S2_RUN}")
python -m x_as_supervision_tpu_torch.eval \
  --config "$CFG/Campaign_SurS2.json" \
  --checkpoint "${S2_CKPT}" --multi_hypo best
cp "${S2_RUN}eval/eval_result.txt" log/campaign_eval_s2.txt

echo "=== S1 ==="; cat log/campaign_eval_s1.txt
echo "=== S2 ==="; cat log/campaign_eval_s2.txt
