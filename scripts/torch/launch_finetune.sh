#!/bin/bash
# The PyTorch port's twin of scripts/launch_finetune.sh.
# Usage: ./launch_finetune.sh <target> <num_hosts> <config> <ckpt> [tag]
set -e
bash "$(dirname "$0")/finetune.sh" "$2" "$3" "$4" "$5"
