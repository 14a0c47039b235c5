#!/usr/bin/env bash
# The full XL campaign chain with the PyTorch port (the twin of
# scripts/xl_chain.sh): reproducible render -> S1 to plateau -> S1ext
# control -> S2 finetune -> confident-mode rows. The control (s1ext) runs
# right after s1, so a cut still leaves the S1 vs S1ext comparison on
# disk.
#
# Everything is resumable: the render skips complete folders and
# segments, and each train stage runs under scripts/torch/train_resumable.sh.
# Re-running this script after any interruption continues where it stopped.
set -uo pipefail
cd "$(dirname "$0")/../.."

stamp() { date "+%F %T"; }
say() { echo "[xl_chain $(stamp)] $*"; }

say "stage: render"
scripts/torch/render_campaign_xl.sh || { say "render FAILED"; exit 1; }

say "stage: s1"
scripts/torch/run_campaign_xl.sh s1 || { say "s1 FAILED"; exit 1; }

say "stage: s1ext (matched-compute control)"
scripts/torch/run_campaign_xl.sh s1ext || { say "s1ext FAILED"; exit 1; }

say "stage: s2"
scripts/torch/run_campaign_xl.sh s2 || { say "s2 FAILED"; exit 1; }

say "stage: confident"
scripts/torch/run_campaign_xl.sh confident || { say "confident FAILED"; exit 1; }

say "chain complete"
