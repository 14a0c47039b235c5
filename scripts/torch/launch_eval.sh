#!/bin/bash
# The PyTorch port's twin of scripts/launch_eval.sh.
# Usage: ./launch_eval.sh <target> <num_hosts> <config> <ckpt> [best|confident]
set -e
bash "$(dirname "$0")/eval.sh" "$2" "$3" "$4" "$5"
