"""The port's training CLI, the twin of the JAX package's train.py:

    python -m x_as_supervision_tpu_torch.train --config <yaml|json> \\
        [--synthetic] [--seed S] [--epoch N] [--steps N] [--batch_size B] \\
        [--worker N] [--backbone_init FILE] [--log_dir DIR] \\
        [--checkpoint <ckpt_dir>|auto] [--finetune] [--extra_tag T] \\
        [--device cpu] [--fp32] \\
        [--coordinator HOST:PORT --num_processes P --process_id R]

Without ``--synthetic`` it trains on the dataset that the config's
``dataset_params`` name on disk (``hm36``, ``mpi_inf_3dhp`` or
``mpi_inf_3dhp+hm36``: data/factory.py:basic_data). It writes
``<log_dir>/<cfg>_seed<s>_<tag><timestamp>/{epoch:05d}_ckpt`` every
``checkpoint_freq`` epochs and at the last one, and TensorBoard events into
``tensorboard/`` beside them. ``--seed -1`` (the default) seeds from the
clock and names the run ``seed_rand_``. ``--checkpoint`` resumes from a
checkpoint (in its run directory), or with ``--finetune`` takes its weights
into a new run; ``auto`` is the newest checkpoint of the last run of this
config under ``--log_dir``.

Data parallelism: under torchrun (one process per card)

    python -m torch.distributed.run --standalone --nproc_per_node 8 \\
        -m x_as_supervision_tpu_torch.train --config <cfg> ...

or with the JAX CLI's flags, one command per process
(``--coordinator host:port --num_processes P --process_id r``), P
processes train at the global batch ``train_params.batch_size`` (see
train/trainer.py for the rules by rank). NCCL joins the cards; with
``--device cpu`` the ranks run on the CPU over gloo.
"""

from __future__ import annotations

import os
import random
from argparse import ArgumentParser

import numpy as np


def setup_seed(seed: int) -> None:
    """Host-side RNG seeding (reference: train.py:32-41); the modules and
    the dropout generators are seeded from the trainer's seed."""
    if seed != -1:
        np.random.seed(seed)
        random.seed(seed)


def base_parser(description: str) -> ArgumentParser:
    """The flags of both train CLIs (this one and train2d3d)."""
    p = ArgumentParser(description=description)
    p.add_argument("--config", required=True, help="path to config")
    p.add_argument("--seed", default=-1, type=int,
                   help="-1: a seed from the clock")
    p.add_argument("--steps", default=None, type=int,
                   help="stop after this many steps")
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--epoch", default=None, type=int,
                   help="number of epochs (train_params.num_epochs)")
    p.add_argument("--worker", default=10, type=int,
                   help="data pipeline worker threads")
    p.add_argument("--log_dir", default="log", help="path to log into")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint to restore, or 'auto'")
    p.add_argument("--finetune", action="store_true",
                   help="take the checkpoint's weights only (S1 -> S2)")
    p.add_argument("--extra_tag", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--fp32", action="store_true",
                   help="compute in fp32 instead of bf16")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 for a multi-process run "
                        "(else torchrun's environment, else one process)")
    p.add_argument("--num_processes", default=None, type=int,
                   help="world size, with --coordinator")
    p.add_argument("--process_id", default=None, type=int,
                   help="this process's rank, with --coordinator")
    return p


def run(opt, make_dataset, backbone_init: str | None = None):
    """Trains as `opt` (base_parser's flags) says on
    ``make_dataset(config)``, from the ImageNet backbone `backbone_init`
    when given; returns the Trainer."""
    import torch

    from ..config import apply_overrides, load_config
    from ..parallel import mesh
    from .logging import create_writer
    from .trainer import Trainer, auto_checkpoint, create_run_dir, draw_seed

    mesh.initialize_multihost(opt.coordinator, opt.num_processes,
                              opt.process_id,
                              backend=mesh.default_backend(opt.device))
    rank0 = mesh.process_index() == 0
    config = apply_overrides(load_config(opt.config), opt.batch_size,
                             opt.epoch)
    seed = opt.seed
    if seed == -1 and mesh.is_distributed():
        # every rank must build the same dataset: rank 0's clock seeds all
        seed = draw_seed(-1)
    setup_seed(seed)
    checkpoint = opt.checkpoint
    if checkpoint == "auto":
        checkpoint = auto_checkpoint(opt.log_dir, opt.config)
        if rank0:
            print(f"auto-resume from {checkpoint}")
    save_dir = create_run_dir(opt.log_dir, opt.config, opt.seed,
                              opt.extra_tag, opt.finetune, checkpoint)
    tb_logger = (create_writer(os.path.join(save_dir, "tensorboard"))
                 if rank0 else None)
    try:
        # built here, as train.py builds it: the subset policies draw from
        # the global numpy state that setup_seed seeded
        dataset = make_dataset(config)
        trainer = Trainer(config, dataset, seed=seed,
                          dtype=torch.float32 if opt.fp32 else torch.bfloat16,
                          device=opt.device, save_dir=save_dir,
                          checkpoint_path=checkpoint,
                          mode="finetune" if opt.finetune else "train",
                          num_workers=opt.worker,
                          backbone_init=backbone_init)
        trainer.history = trainer.train(opt.steps, tb_logger=tb_logger)
    finally:
        if tb_logger is not None:
            tb_logger.close()
    trainer.tb_logger = tb_logger
    return trainer


def main(argv=None):
    """Parses `argv`, trains, and returns the Trainer."""
    p = base_parser(__doc__)
    p.add_argument("--synthetic", action="store_true",
                   help="train on the in-memory synthetic fixture")
    p.add_argument("--backbone_init", default=None,
                   help="ImageNet backbone: a torchvision .pth/.pt or the "
                        "JAX package's converted npz")
    opt = p.parse_args(argv)

    from ..data.factory import build_dataset

    return run(opt, lambda config: build_dataset(config, opt.synthetic),
               opt.backbone_init)


if __name__ == "__main__":
    main()
    from ..parallel.mesh import shutdown

    shutdown()
