"""The port's training CLI, the twin of the JAX package's train.py:

    python -m x_as_supervision_tpu_torch.train --config <yaml|json> \\
        --synthetic --seed 0 [--steps N] [--batch_size B] [--log_dir DIR] \\
        [--checkpoint <ckpt_dir>|auto] [--finetune] [--extra_tag T] \\
        [--device cpu] [--fp32]

It writes ``<log_dir>/<cfg>_seed<s>_<tag><timestamp>/{epoch:05d}_ckpt`` every
``checkpoint_freq`` epochs and at the last one. ``--checkpoint`` resumes
from a checkpoint (in its run directory), or with ``--finetune`` takes its
weights into a new run; ``auto`` is the newest checkpoint of the last run
of this config under ``--log_dir``.
"""

from __future__ import annotations

from argparse import ArgumentParser


def main(argv=None):
    """Parses `argv`, trains, and returns the Trainer."""
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, help="path to config")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on the in-memory synthetic fixture")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--steps", default=None, type=int,
                        help="stop after this many steps")
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument("--log_dir", default="log", help="path to log into")
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint to restore, or 'auto'")
    parser.add_argument("--finetune", action="store_true",
                        help="take the checkpoint's weights only (S1 -> S2)")
    parser.add_argument("--extra_tag", default="")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--fp32", action="store_true",
                        help="compute in fp32 instead of bf16")
    opt = parser.parse_args(argv)

    import torch

    from ..config import load_config
    from ..data.synthetic import synthetic_dataset
    from .trainer import Trainer, auto_checkpoint, create_run_dir

    config = load_config(opt.config)
    if opt.batch_size is not None:
        config["train_params"]["batch_size"] = opt.batch_size
    if not opt.synthetic:
        raise SystemExit("only --synthetic data is ported; the real "
                         "datasets and their loader are not")
    checkpoint = opt.checkpoint
    if checkpoint == "auto":
        checkpoint = auto_checkpoint(opt.log_dir, opt.config)
        print(f"auto-resume from {checkpoint}")
    save_dir = create_run_dir(opt.log_dir, opt.config, opt.seed,
                              opt.extra_tag, opt.finetune, checkpoint)
    trainer = Trainer(config, synthetic_dataset(config), seed=opt.seed,
                      dtype=torch.float32 if opt.fp32 else torch.bfloat16,
                      device=opt.device, save_dir=save_dir,
                      checkpoint_path=checkpoint,
                      mode="finetune" if opt.finetune else "train")
    trainer.train(opt.steps)
    return trainer


if __name__ == "__main__":
    main()
