#!/bin/bash
# S1 -> S2 finetune with the PyTorch port (the twin of scripts/finetune.sh).
# XAS_EXTRA_ARGS is forwarded verbatim.
# Usage: ./finetune.sh <num_hosts> <config> <s1_checkpoint> [tag]
set -e
num_hosts=$1; config_path=$2; ckpt=$3; extra_tag_info=$4
cd "$(dirname "$0")/../.."
command="python -m x_as_supervision_tpu_torch.train --config $config_path --checkpoint $ckpt --finetune"
[[ -n $extra_tag_info ]] && command+=" --extra_tag $extra_tag_info"
[[ -n ${XAS_EXTRA_ARGS:-} ]] && command+=" $XAS_EXTRA_ARGS"
echo "Running command: $command"
eval "exec $command"
