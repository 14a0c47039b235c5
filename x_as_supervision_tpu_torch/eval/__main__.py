"""The port's eval CLI, the twin of the JAX package's eval.py:

    python -m x_as_supervision_tpu_torch.eval --config <yaml|json> \\
        --checkpoint <ckpt_dir> [--multi_hypo best|confident] \\
        [--batch_size N] [--synthetic] [--device cpu]

It takes the detector out of a train checkpoint, evaluates it in bf16 (as
eval.py builds it) on the CUDA card unless given ``--device cpu``, writes
``<run>/eval/eval_result.txt`` beside the checkpoint and prints the
ambiguity ratio.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import torch


def run_eval(config: dict, checkpoint: str, multi_hypo: str = "best",
             synthetic: bool = True, batch_size: int | None = None,
             device=None):
    """Evaluates the detector of `checkpoint` under `config` (a loaded
    config dict) in bf16 and writes eval_result.txt; returns the Evaluator,
    which holds the result's path, the ambiguity ratio and the per-batch
    times."""
    from ..data.synthetic import synthetic_dataset
    from ..models.detector import build_detector
    from ..train import checkpoint as ckpt
    from ..train.evaluator import Evaluator

    if not synthetic:
        raise SystemExit("only --synthetic data is ported; the real "
                         "datasets and their loader are not")
    if batch_size is not None:
        config["train_params"]["batch_size"] = batch_size
    detector = build_detector(config["model_params"]["detector_params"],
                              torch.bfloat16)
    detector.load_state_dict(ckpt.restore_detector(checkpoint))
    evaluator = Evaluator(config, detector, synthetic_dataset(config),
                          os.path.dirname(os.path.abspath(checkpoint)),
                          device=device)
    tables = evaluator.eval(mode=multi_hypo)
    evaluator.result_path = evaluator.record(*tables)
    return evaluator


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, help="path to config")
    parser.add_argument("--checkpoint", default=None,
                        help="path to checkpoint to restore")
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument("--multi_hypo", default="best",
                        choices=["best", "confident"],
                        help="multi-hypothesis eval mode")
    parser.add_argument("--synthetic", action="store_true",
                        help="evaluate on the in-memory synthetic fixture")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    opt = parser.parse_args(argv)
    if opt.checkpoint is None:
        raise SystemExit("Must specify checkpoint path")

    from ..config import load_config

    return run_eval(load_config(opt.config), opt.checkpoint, opt.multi_hypo,
                    opt.synthetic, opt.batch_size, opt.device)


if __name__ == "__main__":
    main()
