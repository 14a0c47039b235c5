"""Training loop of the port (the JAX package's train/trainer.py, without
its TensorBoard logging, thread loader and multi-host mesh): the run
directory, seeded modules, the GAN update cadence, a per-step dropout
generator, per-step losses, and a checkpoint every ``checkpoint_freq``
epochs and at the last one, with resume and finetune from one.

    python -m x_as_supervision_tpu_torch.train --config <yaml|json> \\
        --synthetic --seed 0 [--steps N] [--batch_size B] [--log_dir DIR] \\
        [--checkpoint <ckpt_dir>|auto] [--finetune] [--extra_tag T] \\
        [--device cpu] [--fp32]

It trains on the CUDA card unless given ``--device cpu``; there the kernels'
plain versions run. A resumed run takes the same steps as one that was not
interrupted: the data position follows from the epoch and the step, and
each step's dropout generator from the seed and the step.
"""

from __future__ import annotations

import glob
import os
import time
from shutil import copy as copy_file

import numpy as np
import torch

from .. import weights
from ..serve import resolve_device
from . import checkpoint as ckpt
from .factory import build_gan_spec
from .state import TrainState, train_step


def create_run_dir(log_root: str, config_path: str, seed: int,
                   extra_tag: str = "", finetune: bool = False,
                   checkpoint_path: str | None = None) -> str:
    """log/<cfg>[_FINETUNE]_seed<s>_<tag><timestamp>/ with the config copied
    in; resuming reuses the checkpoint's directory.
    Reference: train.py:282-302."""
    if checkpoint_path is not None and not finetune:
        return os.path.dirname(os.path.abspath(checkpoint_path))
    seed_tag = f"seed{seed if seed != -1 else '_rand'}_"
    name = os.path.basename(config_path).split(".")[0]
    if finetune:
        name += "_FINETUNE"
    stamp = time.strftime("%d_%m_%y_%H.%M.%S", time.gmtime())
    run_dir = os.path.join(log_root, name + "_" + seed_tag + extra_tag + stamp)
    os.makedirs(run_dir, exist_ok=True)
    dst = os.path.join(run_dir, os.path.basename(config_path))
    if os.path.isfile(config_path) and not os.path.exists(dst):
        copy_file(config_path, run_dir)
    return run_dir


def auto_checkpoint(log_root: str, config_path: str) -> str | None:
    """``--checkpoint auto``: the newest checkpoint of the last run of this
    config under `log_root` (run directories in name order), or None."""
    name = os.path.basename(config_path).split(".")[0]
    runs = sorted(glob.glob(os.path.join(log_root, name + "_*")))
    return ckpt.latest_checkpoint(runs[-1]) if runs else None


def update_intervals(config: dict) -> tuple[int, int]:
    """(disc_every, gen_every) from smpl_disc_loss.update_interval: >= 1
    updates the discriminator every that many steps and the generator every
    step; below 1 the other way round."""
    interval = config["model_params"]["loss_config"].get(
        "smpl_disc_loss", {}).get("update_interval", 1)
    if interval >= 1:
        return int(interval), 1
    return 1, int(round(1.0 / interval))


def to_device(batch: dict, device) -> dict:
    """A numpy batch (host-only fields dropped) as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items() if not isinstance(v, (list, str))}


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of one step, from the run's seed."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (2**63))


class Trainer:
    def __init__(self, config: dict, dataset, seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 save_dir: str | None = None,
                 checkpoint_path: str | None = None, mode: str = "train"):
        """save_dir: where checkpoints go (none saved without it);
        checkpoint_path: a checkpoint to resume from (mode "train") or to
        take the weights of (mode "finetune")."""
        if mode not in ("train", "finetune"):
            raise ValueError(f"mode {mode!r}: 'train' or 'finetune'")
        self.config = config
        self.save_dir = save_dir
        self.dataset = dataset
        self.device = resolve_device(device)
        self.seed = seed
        tp = config["train_params"]
        self.batch_size = tp["batch_size"]
        self.steps_per_epoch = max(1, len(dataset) // self.batch_size)
        self.num_epochs = tp["num_epochs"]
        self.ckpt_freq = tp.get("checkpoint_freq", 1)
        self.disc_every, self.gen_every = update_intervals(config)

        self.spec = build_gan_spec(config, dtype)
        for i, module in enumerate((self.spec.detector, self.spec.physique,
                                    self.spec.discriminator)):
            if module is not None:
                weights.init_weights(module, seed + i)
                module.to(self.device)
        self.state = TrainState(self.spec, tp, self.steps_per_epoch,
                                self.disc_every, self.gen_every)
        self.images_per_step = self.batch_size * len(self.spec.cam_id_list)
        self.epochs_run = 0
        if checkpoint_path is not None and mode == "finetune":
            ckpt.restore_finetune(checkpoint_path, self.state)
            print("Finetuning from checkpoint (optimizers reset)")
        elif checkpoint_path is not None:
            ckpt.restore_resume(checkpoint_path, self.state)
            self.epochs_run = self.state.epoch
            print(f"Resuming training from epoch {self.epochs_run}")

    def train(self, max_steps: int | None = None, log=print) -> list[dict]:
        """Runs the epochs (at most `max_steps` steps); returns each step's
        metrics as floats."""
        history = []
        for epoch in range(self.epochs_run, self.num_epochs):
            for it in range(self.steps_per_epoch):
                step = epoch * self.steps_per_epoch + it
                if max_steps is not None and step >= max_steps:
                    return history
                do_disc = (self.spec.discriminator is not None
                           and step % self.disc_every == 0)
                do_gen = step % self.gen_every == 0
                if not (do_disc or do_gen):
                    continue
                batch = to_device(self.dataset.batch(
                    it * self.batch_size, self.batch_size), self.device)
                t0 = time.perf_counter()
                metrics = train_step(
                    self.state, batch,
                    step_generator(self.seed, step, self.device),
                    do_disc=do_disc, do_gen=do_gen)
                metrics = {k: float(v) for k, v in sorted(metrics.items())}
                seconds = time.perf_counter() - t0
                history.append(metrics)
                log(f"step {step} ({seconds:.3f} s, "
                    f"{self.images_per_step / seconds:.1f} img/s) "
                    + " ".join(f"{k}={v:.6f}" for k, v in metrics.items()))
            self.state.epoch = epoch + 1
            if self.save_dir is not None and (
                    epoch % self.ckpt_freq == 0
                    or epoch == self.num_epochs - 1):
                path = ckpt.save_checkpoint(self.save_dir, epoch, self.state)
                log(f"checkpoint saved: {path}")
        return history
