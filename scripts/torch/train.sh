#!/bin/bash
# Per-process training launcher of the PyTorch port (the twin of
# scripts/train.sh): runs the port's train CLI, python -m
# x_as_supervision_tpu_torch.train (train2d3d for a TikTok or MPII config).
#
# Usage: ./train.sh <num_hosts> <config_path> [extra_tag] [coordinator_addr]
#
# Without a coordinator it is one process on this host's card, or one rank
# of a torchrun group where torchrun runs it (launch_train.sh's fan-outs:
# the CLI joins the group from torchrun's environment). An explicit
# coordinator host:port pairs with XAS_NUM_PROCESSES / XAS_PROCESS_ID (the
# CLI's --coordinator --num_processes --process_id, one process per card).
# Coordinator 'auto' reads TPU metadata and has no counterpart: the CLI
# refuses it. XAS_EXTRA_ARGS is forwarded verbatim (e.g. "--seed 0", or
# "--device cpu" on a host without a card).
set -e
num_hosts=$1
config_path=$2
extra_tag_info=$3
coordinator=$4

cd "$(dirname "$0")/../.."
export PYTHONUNBUFFERED=1

if [[ $config_path == *"TikTok"* ]] || [[ $config_path == *"MPII"* ]]; then
    entry=x_as_supervision_tpu_torch.train2d3d
else
    entry=x_as_supervision_tpu_torch.train
fi

command="python -m $entry --config $config_path"
if [[ -n $extra_tag_info ]]; then
    command+=" --extra_tag $extra_tag_info"
fi
if [[ -n $coordinator ]]; then
    command+=" --coordinator $coordinator"
fi
if [[ -n ${XAS_NUM_PROCESSES:-} ]]; then
    # fail fast on a missing rank rather than letting argparse mis-parse
    # an empty --process_id value
    command+=" --num_processes $XAS_NUM_PROCESSES --process_id ${XAS_PROCESS_ID:?XAS_PROCESS_ID must be set with XAS_NUM_PROCESSES}"
fi
if [[ -n ${XAS_EXTRA_ARGS:-} ]]; then
    command+=" $XAS_EXTRA_ARGS"
fi

echo "Running command: $command"
eval "exec $command"
