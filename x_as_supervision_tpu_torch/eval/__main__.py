"""The port's eval CLI, the twin of the JAX package's eval.py:

    python -m x_as_supervision_tpu_torch.eval --config <yaml|json> \\
        --checkpoint <ckpt_dir> [--multi_hypo best|confident] \\
        [--batch_size N] [--worker N] [--log_dir DIR] [--extra_tag T] \\
        [--synthetic] [--device cpu] \\
        [--coordinator HOST:PORT --num_processes P --process_id R] \\
        [--reduce_hosts]

Without ``--synthetic`` it scores the ``test_image_set`` of the dataset that
the config's ``dataset_params`` name on disk (data/factory.py:basic_data
with ``eval_only``).

It takes the detector out of a train checkpoint, evaluates it in bf16 (as
eval.py builds it) on the CUDA card unless given ``--device cpu``, writes
``<run>/eval/eval_result.txt`` beside the checkpoint and each batch's pose
panels as TensorBoard events into ``<run>/eval/tensorboard``, and prints
the ambiguity ratio. ``--worker``, ``--log_dir`` and ``--extra_tag`` are
accepted and unused, as in eval.py (the run directory is the
checkpoint's).

Under torchrun or the ``--coordinator`` flags (as eval.py takes them)
process p of P scores batches p, p + P, ... on its own card. With
``--reduce_hosts`` every process sums the tables over the processes and
process 0 writes the one-process result; without it process 0 writes the
tables of its own batches (the reference's rank-0 report). Process 0 alone
logs the panels.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import torch


def run_eval(config: dict, checkpoint: str, multi_hypo: str = "best",
             synthetic: bool = False, batch_size: int | None = None,
             device=None, reduce_hosts: bool = False):
    """Evaluates the detector of `checkpoint` under `config` (a loaded
    config dict) in bf16, logs its panels and writes eval_result.txt;
    returns the Evaluator, which holds the result's path, the tables it
    was written from (``tables``, this process's, as ``record`` normalized
    them on process 0), the ambiguity ratio, the per-batch times and the
    event writer (``tb_logger``, None on other processes). In a process
    group each process scores its shard of the batches; `reduce_hosts`
    as eval.py's flag."""
    from ..config import apply_overrides
    from ..data.factory import build_dataset
    from ..models.detector import build_detector
    from ..train import checkpoint as ckpt
    from ..parallel import mesh
    from ..train.evaluator import Evaluator
    from ..train.logging import create_writer

    config = apply_overrides(config, batch_size, None)
    detector = build_detector(config["model_params"]["detector_params"],
                              torch.bfloat16)
    detector.load_state_dict(ckpt.restore_detector(checkpoint))
    log_dir = os.path.dirname(os.path.abspath(checkpoint))
    dataset = build_dataset(config, synthetic, eval_only=True)
    evaluator = Evaluator(config, detector, dataset, log_dir, device=device)
    rank0 = mesh.process_index() == 0
    tb_logger = (create_writer(os.path.join(log_dir, "eval", "tensorboard"))
                 if rank0 else None)
    try:
        tables = evaluator.eval(mode=multi_hypo, tb_log=tb_logger)
    finally:
        if tb_logger is not None:
            tb_logger.close()
    evaluator.tb_logger = tb_logger
    evaluator.result_path = None
    # eval.py's rule: every process records under reduce_hosts (the sum is
    # collective), else process 0 alone
    if reduce_hosts or rank0:
        evaluator.result_path = evaluator.record(*tables,
                                                 reduce_hosts=reduce_hosts)
    evaluator.tables = tables
    return evaluator


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, help="path to config")
    parser.add_argument("--log_dir", default="log",
                        help="unused, as in eval.py: results go beside the "
                             "checkpoint")
    parser.add_argument("--checkpoint", default=None,
                        help="path to checkpoint to restore")
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument("--worker", default=10, type=int)
    parser.add_argument("--extra_tag", default=" ", help="unused, as in "
                        "eval.py")
    parser.add_argument("--multi_hypo", default="best",
                        choices=["best", "confident"],
                        help="multi-hypothesis eval mode")
    parser.add_argument("--synthetic", action="store_true",
                        help="evaluate on the in-memory synthetic fixture")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0 for a multi-process "
                             "eval (else torchrun's environment, else one "
                             "process); each process scores its shard")
    parser.add_argument("--num_processes", default=None, type=int,
                        help="world size, with --coordinator")
    parser.add_argument("--process_id", default=None, type=int,
                        help="this process's rank, with --coordinator")
    parser.add_argument("--reduce_hosts", action="store_true",
                        help="sum the metric tables over the processes "
                             "before recording (else process 0 reports "
                             "its own shard, as the reference's rank 0)")
    opt = parser.parse_args(argv)
    if opt.checkpoint is None:
        raise SystemExit("Must specify checkpoint path")

    from ..config import load_config
    from ..parallel import mesh

    mesh.initialize_multihost(opt.coordinator, opt.num_processes,
                              opt.process_id,
                              backend=mesh.default_backend(opt.device))
    return run_eval(load_config(opt.config), opt.checkpoint, opt.multi_hypo,
                    opt.synthetic, opt.batch_size, opt.device,
                    opt.reduce_hosts)


if __name__ == "__main__":
    main()
    from ..parallel.mesh import shutdown

    shutdown()
