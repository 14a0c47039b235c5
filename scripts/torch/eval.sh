#!/bin/bash
# Eval launcher of the PyTorch port (the twin of scripts/eval.sh): the
# port's eval CLI (eval2d for a TikTok or MPII config) in one process.
# XAS_EXTRA_ARGS is forwarded verbatim (e.g. "--synthetic", or
# "--device cpu" on a host without a card).
# Usage: ./eval.sh <num_hosts> <config> <checkpoint> [best|confident]
set -e
num_hosts=$1; config_path=$2; ckpt=$3; hypo=${4:-best}
cd "$(dirname "$0")/../.."
if [[ $config_path == *"TikTok"* ]] || [[ $config_path == *"MPII"* ]]; then
    entry=x_as_supervision_tpu_torch.eval2d
else
    entry=x_as_supervision_tpu_torch.eval
fi
command="python -m $entry --config $config_path --checkpoint $ckpt --multi_hypo $hypo"
[[ -n ${XAS_EXTRA_ARGS:-} ]] && command+=" $XAS_EXTRA_ARGS"
echo "Running command: $command"
eval "exec $command"
