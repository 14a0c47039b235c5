"""Training loop of the port (the JAX package's train/trainer.py, without
its checkpoints, TensorBoard logging, thread loader and multi-host mesh):
seeded modules, the GAN update cadence, a per-step dropout generator, and
per-step losses.

    python -m x_as_supervision_tpu_torch.train --config <yaml> --synthetic \\
        --seed 0 [--steps N] [--batch_size B] [--device cpu] [--fp32]

It trains on the CUDA card unless given ``--device cpu``; there the kernels'
plain versions run.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import weights
from ..serve import resolve_device
from .factory import build_gan_spec
from .state import TrainState, train_step


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
                 dtype: torch.dtype = torch.bfloat16, device=None):
        self.config = config
        self.dataset = dataset
        self.device = resolve_device(device)
        self.seed = seed
        tp = config["train_params"]
        self.batch_size = tp["batch_size"]
        self.steps_per_epoch = max(1, len(dataset) // self.batch_size)
        self.num_epochs = tp["num_epochs"]
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

    def train(self, max_steps: int | None = None, log=print) -> list[dict]:
        """Runs the epochs (at most `max_steps` steps); returns each step's
        metrics as floats."""
        history = []
        for epoch in range(self.num_epochs):
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
        return history
