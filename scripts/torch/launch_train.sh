#!/bin/bash
# Cluster launcher of the PyTorch port (the twin of scripts/launch_train.sh):
# dispatches the training job through scripts/torch/train.sh.
#
# Usage: ./launch_train.sh <target> <num_hosts> <config> [tag]
#
#   <target> selects the dispatch mode:
#     * "local"          - this host. num_hosts <= 1: one process (no
#                          process group). num_hosts = N > 1: N ranks under
#                          torchrun --nproc_per_node N, one per card; ranks
#                          that outnumber the cards share them over gloo
#                          (torchrun's LOCAL_WORLD_SIZE tells the CLI)
#     * a hostfile path  - one hostname per line ('#' comments allowed):
#                          over ssh, one torchrun --nnodes <num_hosts>
#                          --node_rank i --nproc_per_node <that host's
#                          cards> per host, line 0 the rendezvous host
#     * anything else    - the JAX launcher's TPU pod (gcloud ssh
#                          --worker=all, coordinator 'auto' from TPU
#                          metadata): no counterpart here; exits 2
#
# Environment:
#   XAS_COORD_PORT  rendezvous port (default 8476)
#   XAS_EXTRA_ARGS  extra flags forwarded to the train CLI (e.g. "--seed 0")
#   XAS_REPO_DIR    repo path on the remote hosts (default: this repo's path)
set -eo pipefail
target=$1
num_hosts=$2
config_path=$3
extra_tag_info=$4

port=${XAS_COORD_PORT:-8476}
repo_dir=${XAS_REPO_DIR:-$(cd "$(dirname "$0")/../.." && pwd)}
scripts_dir="$(cd "$(dirname "$0")" && pwd)"

mkdir -p launch_output
echo "target: $target num_hosts: $num_hosts"

if [[ $num_hosts -le 1 ]]; then
    bash "$scripts_dir/train.sh" 1 "$config_path" "$extra_tag_info" \
        2>&1 | tee launch_output/log.out.$$
elif [[ $target == local ]]; then
    # torchrun starts the ranks; each runs train.sh, whose CLI joins the
    # group from torchrun's environment
    python -m torch.distributed.run --nnodes 1 --node_rank 0 \
        --nproc_per_node "$num_hosts" --master_addr localhost \
        --master_port "$port" --no-python \
        bash "$scripts_dir/train.sh" "$num_hosts" "$config_path" \
            "$extra_tag_info" \
        2>&1 | tee launch_output/log.out.$$
elif [[ -f $target ]]; then
    # hostfile ssh fan-out: first host is the rendezvous host
    mapfile -t hosts < <(grep -v '^\s*#' "$target" | grep -v '^\s*$')
    if [[ ${#hosts[@]} -ne $num_hosts ]]; then
        echo "hostfile has ${#hosts[@]} hosts, expected $num_hosts" >&2
        exit 1
    fi
    pids=()
    for ((i = 0; i < num_hosts; i++)); do
        ssh -o BatchMode=yes "${hosts[$i]}" \
            "cd '$repo_dir' && XAS_EXTRA_ARGS='${XAS_EXTRA_ARGS:-}' \
             python -m torch.distributed.run --nnodes $num_hosts \
                 --node_rank $i --nproc_per_node \$(nvidia-smi -L | wc -l) \
                 --master_addr ${hosts[0]} --master_port $port --no-python \
                 bash scripts/torch/train.sh $num_hosts '$config_path' \
                     '$extra_tag_info'" \
            > "launch_output/log.host$i.$$" 2>&1 &
        pids+=($!)
    done
    status=0
    for pid in "${pids[@]}"; do
        wait "$pid" || status=$?
    done
    tail -5 "launch_output/log.host0.$$" || true
    exit $status
else
    echo "target '$target': not 'local' and not a hostfile. A TPU pod" \
         "launch (gcloud --worker=all, coordinator 'auto') has no" \
         "counterpart in the port" >&2
    exit 2
fi
