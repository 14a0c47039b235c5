#!/usr/bin/env bash
# Crash- and hang-resilient training driver of the PyTorch port (the twin
# of scripts/train_resumable.sh): runs the port's train CLI and, when it
# dies or wedges, resumes it from the newest complete checkpoint of the
# same run, up to 12 attempts. The driver is
# x_as_supervision_tpu_torch/tools/train_resumable.py (its docstring has
# the rules).
#
# Usage: scripts/torch/train_resumable.sh <config> <log_dir> \
#            [--poll SECONDS] [extra args...]
#
#   XAS_STALL_SECS  (default 1200)   XAS_GRACE_SECS  (default 3000)
#   XAS_INIT_CKPT   finetune from this checkpoint while the run has none
#   --poll          seconds between the watchdog's checks (default 60)
set -uo pipefail
cd "$(dirname "$0")/../.."
exec python -m x_as_supervision_tpu_torch.tools.train_resumable "$@"
