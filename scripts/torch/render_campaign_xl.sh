#!/usr/bin/env bash
# The XL campaign render with the PyTorch port's offline tools (the twin of
# scripts/render_campaign_xl.sh): SMPL on the card, the same arguments and
# seed, the same regenerate-or-reuse (complete hm36 folders and pseudo
# segments are skipped, so a re-run after an interruption converges to the
# render of one uninterrupted run).
#
# The port's render rounds differently from the JAX tool's (its counts
# agree, some digests do not: PERF.md), so it is not checked against
# benchmarks/campaign/xl_manifest.json, which it never writes. Its counts
# are compared with that manifest (a difference fails), and its own first
# manifest is kept beside the render as ${OUT}_manifest.json, against which
# every later run is checked.
#
#   XAS_CAMPAIGN_DATA   dataset root (default: data/campaign_xl, the path
#                       the Campaign_XL_* configs point at)
set -euo pipefail
cd "$(dirname "$0")/../.."
OUT="${XAS_CAMPAIGN_DATA:-data/campaign_xl}"
REF="${OUT%/}_manifest.json"
JAX_REF="benchmarks/campaign/xl_manifest.json"

python -m x_as_supervision_tpu_torch.tools.render_campaign \
  --out "$OUT" \
  --train_set campaign_train_xl --valid_set campaign_valid_xl \
  --train_frames 336 --valid_frames 80 \
  --pseudo_segments 375 --pseudo_frames 48 --sample_times 12 \
  --img_size 384 --seed 0

if [[ -f "$REF" ]]; then
  python -m x_as_supervision_tpu_torch.tools.campaign_manifest "$OUT" \
    --check --manifest "$REF"
else
  cp "$OUT/manifest.json" "$REF"
  echo "recorded the port's reference manifest at $REF"
fi

if [[ -f "$JAX_REF" ]]; then
  python - "$JAX_REF" "$OUT/manifest.json" <<'PY'
import json
import sys

from x_as_supervision_tpu_torch.checks import manifest_agreement

ref, got = (json.load(open(p)) for p in sys.argv[1:3])
agreement = manifest_agreement(ref, got)
print("against the JAX render's manifest:", json.dumps(agreement))
if not agreement["counts_equal"]:
    sys.exit("the port's render has other counts than the JAX render's")
PY
fi
