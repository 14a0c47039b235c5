"""Training loop of the port (the JAX package's train/trainer.py): the run
directory, seeded modules (a seed of -1 taken from the clock), the ImageNet
backbone initialization, the epoch-shuffled prefetching loader, the GAN
update cadence, a per-step dropout generator, TensorBoard scalars every
``log_interval`` steps and image panels every ``lcm(50, log_interval)``,
the step timer, an optional profiler trace, and a checkpoint every
``checkpoint_freq`` epochs and at the last one, with resume and finetune
from one.

    python -m x_as_supervision_tpu_torch.train --config <yaml|json> \\
        [--synthetic] [--seed S] [--epoch N] [--steps N] [--batch_size B] \\
        [--worker N] [--backbone_init FILE] [--log_dir DIR] \\
        [--checkpoint <ckpt_dir>|auto] [--finetune] [--extra_tag T] \\
        [--device cpu] [--fp32] \\
        [--coordinator HOST:PORT --num_processes P --process_id R]

It trains on the CUDA card unless given ``--device cpu``; there the kernels'
plain versions run. A resumed run takes the same steps as one that was not
interrupted: epoch e's batches follow from the seed and e, and each step's
dropout generator from the seed and the step.

Data parallelism (parallel/; launched by torchrun or the ``--coordinator``
flags): P processes, one per card, compute what one process computes at the
global batch ``train_params.batch_size``. The rules by rank:

  * every rank trains on its own card (``cuda:<local rank>``) and its own
    rows of each global batch (the loader's shard ``process_index()`` of
    ``process_count()``), with the same modules, initialized from the same
    seed: ``--seed -1`` is drawn from rank 0's clock and broadcast;
  * the run directory and ``--checkpoint auto`` are decided on rank 0 and
    broadcast; every rank restores from the same checkpoint file;
  * rank 0 alone prints the step lines and writes TensorBoard, the
    profiler trace and the checkpoints; a barrier follows each save;
  * every rank's metrics are the global values.

Tensor parallelism (``train_params.model_parallelism`` = m > 1, the JAX
trainer's key): the P ranks form parallel/mesh.py's (P / m, m) grid (m
must divide P). After the modules are initialized (and restored from a
checkpoint, which is always the whole state) the train state is cut to each
rank's channel shards (parallel/tp.py:shard_state); the loader shards the
global batch over the P / m data ranks, so the m model ranks of one data
index read the same rows; the seed broadcast and rank 0's duties are as
above, and checkpoints are the whole state, gathered.
"""

from __future__ import annotations

import glob
import math
import os
import time
from shutil import copy as copy_file

import numpy as np
import torch

from .. import weights
from ..data.loader import BatchLoader
from ..parallel import mesh, tp
from ..serve import resolve_device
from ..spans import LOADER_WAIT, span
from . import checkpoint as ckpt
from .evaluator import fetch
from .factory import build_gan_spec
from .logging import tb_vis
from .profiling import Profiler, StepTimer
from .state import TrainState, train_step


def waited(batches):
    """The batches of a loader's epoch, each wait for one an
    ``xas.loader.wait`` span (spans.py)."""
    try:
        while True:
            with span(LOADER_WAIT):
                batch = next(batches, None)
            if batch is None:
                return
            yield batch
    finally:
        batches.close()


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
    # one name on every rank (their clocks may differ): rank 0's
    run_dir = mesh.broadcast_object(run_dir)
    if mesh.process_index() == 0:
        os.makedirs(run_dir, exist_ok=True)
        dst = os.path.join(run_dir, os.path.basename(config_path))
        if os.path.isfile(config_path) and not os.path.exists(dst):
            copy_file(config_path, run_dir)
    return run_dir


def auto_checkpoint(log_root: str, config_path: str) -> str | None:
    """``--checkpoint auto``: the newest checkpoint of the last run of this
    config under `log_root` (run directories in name order), or None; rank
    0's answer on every rank."""
    found = None
    if mesh.process_index() == 0:
        name = os.path.basename(config_path).split(".")[0]
        runs = sorted(glob.glob(os.path.join(log_root, name + "_*")))
        found = ckpt.latest_checkpoint(runs[-1]) if runs else None
    return mesh.broadcast_object(found)


def draw_seed(seed: int) -> int:
    """The run's seed: `seed`, or for -1 one from the clock; rank 0's on
    every rank."""
    return mesh.broadcast_object(
        seed if seed != -1 else int(time.time()) % (2**31))


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
                 checkpoint_path: str | None = None, mode: str = "train",
                 num_workers: int = 10, backbone_init: str | None = None):
        """save_dir: where checkpoints (and a profiler trace) go (none saved
        without it); checkpoint_path: a checkpoint to resume from (mode
        "train") or to take the weights of (mode "finetune"); seed -1: a
        seed from the clock; num_workers: the loader's threads;
        backbone_init: an ImageNet backbone file (else
        detector_params.backbone_init, else data/pretrained/)."""
        if mode not in ("train", "finetune"):
            raise ValueError(f"mode {mode!r}: 'train' or 'finetune'")
        self.config = config
        self.save_dir = save_dir
        self.dataset = dataset
        self.device = resolve_device(mesh.rank_device(device))
        self.seed = draw_seed(seed)
        self.rank = mesh.process_index()
        tp_params = config["train_params"]
        # the (data, model) grid: raises where the world does not divide
        mesh.make_grid(int(tp_params.get("model_parallelism", 1)))
        self.batch_size = tp_params["batch_size"]
        self.num_epochs = tp_params["num_epochs"]
        self.ckpt_freq = tp_params.get("checkpoint_freq", 1)
        self.disc_every, self.gen_every = update_intervals(config)
        # scalars every log_interval steps (each log is one device-to-host
        # fetch), image panels on the steps that are also log steps, every
        # lcm(50, log_interval) (reference: train.py:196-199)
        self.log_interval = int(tp_params.get("log_interval", 1))
        self.vis_interval = math.lcm(50, self.log_interval)

        self.spec = build_gan_spec(config, dtype)
        for i, module in enumerate((self.spec.detector, self.spec.physique,
                                    self.spec.discriminator)):
            if module is not None:
                weights.init_weights(module, self.seed + i)
        det_p = config["model_params"].get("detector_params", {})
        backbone_init = weights.resolve_backbone_init(
            backbone_init or det_p.get("backbone_init"),
            det_p.get("num_layers", 50))
        if backbone_init:
            weights.init_backbone(self.spec.detector, backbone_init)
            self._say(f"backbone initialized from {backbone_init}")
        for module in (self.spec.detector, self.spec.physique,
                       self.spec.discriminator):
            if module is not None:
                module.to(self.device)
        # the optimizers' milestones in steps of the epochs the dataset
        # holds, as the JAX trainer builds them
        self.state = TrainState(self.spec, tp_params,
                                max(1, len(dataset) // self.batch_size),
                                self.disc_every, self.gen_every)
        self.images_per_step = self.batch_size * len(self.spec.cam_id_list)
        self.epochs_run = 0
        if checkpoint_path is not None and mode == "finetune":
            ckpt.restore_finetune(checkpoint_path, self.state)
            self._say("Finetuning from checkpoint (optimizers reset)")
        elif checkpoint_path is not None:
            ckpt.restore_resume(checkpoint_path, self.state)
            self.epochs_run = self.state.epoch
            self._say(f"Resuming training from epoch {self.epochs_run}")
        # this rank's channel shards (nothing without tensor parallelism)
        tp.shard_state(self.state)

        # this rank's rows of each global batch (its data index's)
        self.loader = BatchLoader(dataset, batch_size=self.batch_size,
                                  shuffle=True, num_workers=num_workers,
                                  prefetch=2, seed=self.seed,
                                  num_shards=mesh.data_size(),
                                  shard_index=mesh.data_index())
        self.steps_per_epoch = len(self.loader)
        mp = config["model_params"]
        self.tb_parent_ids = np.array(mp["parent_ids"])
        self.tb_pair_ids = np.array(mp["flip_pairs"])
        self.profiler = (Profiler.from_config(config, save_dir)
                         if self.rank == 0 else Profiler(None))
        self.timer = StepTimer()

    def _say(self, line: str) -> None:
        if self.rank == 0:
            print(line)

    def train(self, max_steps: int | None = None, log=print,
              tb_logger=None) -> list[dict]:
        """Runs the epochs (at most `max_steps` steps), writing TensorBoard
        events to `tb_logger` when given; returns the metrics fetched on
        each log step (every log_interval steps), as floats. Only rank 0
        calls `log`."""
        log = log if self.rank == 0 else (lambda *_: None)
        history = []
        last_t, last_step = time.perf_counter(), None
        try:
            for epoch in range(self.epochs_run, self.num_epochs):
                for it, batch in enumerate(waited(self.loader.epoch(epoch))):
                    cur_step = epoch * self.steps_per_epoch + it
                    if max_steps is not None and cur_step >= max_steps:
                        return history
                    do_disc = (self.spec.discriminator is not None
                               and cur_step % self.disc_every == 0)
                    do_gen = cur_step % self.gen_every == 0
                    if not (do_disc or do_gen):
                        continue

                    self.profiler.maybe_start(cur_step)
                    want_outputs = (tb_logger is not None
                                    and cur_step % self.vis_interval == 0)
                    result = train_step(
                        self.state, to_device(batch, self.device),
                        step_generator(self.seed, cur_step, self.device),
                        do_disc=do_disc, do_gen=do_gen,
                        with_outputs=want_outputs)
                    metrics, outputs = result if want_outputs else (result,
                                                                    {})
                    self.profiler.maybe_stop(cur_step)
                    self.timer.tick()
                    if cur_step % 50 == 0:
                        self.timer.log(tb_logger, cur_step,
                                       self.images_per_step)
                    if cur_step % self.log_interval:
                        continue

                    # one device-to-host fetch of every scalar metric
                    keys = sorted(metrics)
                    packed = torch.stack([metrics[k].float().mean()
                                          for k in keys]).cpu().numpy()
                    fetched = {k: float(v) for k, v in zip(keys, packed)}
                    history.append(fetched)
                    seconds = (time.perf_counter() - last_t) / (
                        1 if last_step is None else cur_step - last_step)
                    log(f"step {cur_step} ({seconds:.3f} s, "
                        f"{self.images_per_step / seconds:.1f} img/s) "
                        + " ".join(f"{k}={v:.6f}"
                                   for k, v in fetched.items()))
                    if tb_logger is not None:
                        tb_vis(
                            tb_logger, cur_step, self.tb_pair_ids,
                            self.tb_parent_ids, fetched.get("loss_total"),
                            {k.split("loss/", 1)[1]: v
                             for k, v in fetched.items()
                             if k.startswith("loss/")},
                            fetched.get("loss_disc"),
                            fetch(outputs) if outputs else {}, batch,
                            self.config,
                            # the schedule counts generator updates
                            detector_lr=self.state.lr_det(
                                cur_step // self.gen_every))
                    # the next line's time leaves out this step's logging
                    last_t, last_step = time.perf_counter(), cur_step
                self.state.epoch = epoch + 1
                if self.save_dir is not None and (
                        epoch % self.ckpt_freq == 0
                        or epoch == self.num_epochs - 1):
                    path = ckpt.save_checkpoint(self.save_dir, epoch,
                                                self.state)
                    log(f"checkpoint saved: {path}")
        finally:
            self.profiler.close()
        return history
