#!/bin/bash
# The flagship train step (chip_smoke.py phase 6: the launch counts, the
# step's CUDA-event ms, and in a tree that has it the physique leaky ReLU's
# check) of two checkouts on one card, in turns: A, B, B, A.
#
#   bash scripts/paired_train_step.sh PARENT_DIR CHANGE_DIR
#
# Each directory is a full checkout (for example `git archive <commit>`
# unpacked into smoke_tree/, which .gitignore lists); each builds its own
# kernels into its build/. Prints the card, then one RESULT line a run.
set -euo pipefail
a=$(cd "$1" && pwd)
b=$(cd "$2" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
for tree in "$a" "$b" "$b" "$a"; do
  echo "=== $tree"
  (cd "$tree" && python3 -c "
import json
import chip_smoke as c
c.phase_device(); c.phase_build(); r = c.phase_train()
print('RESULT', json.dumps(dict(step_ms=r['step_ms'],
      mean_step_ms=r['mean_step_ms'], leaky=r.get('leaky_relu'),
      launches=r['launches_per_step'])))
" | grep RESULT)
done
