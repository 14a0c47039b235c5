#!/usr/bin/env python3
"""Convert a JAX (Orbax) train checkpoint into the PyTorch port's own.

    python scripts/jax_checkpoint_to_torch.py --config <yaml|json> \\
        --checkpoint <orbax {epoch:05d}_ckpt dir> --out <save_dir>

Runs where JAX and Orbax are (the Orbax format needs tensorstore), on the
CPU. It restores the checkpoint without a target, as the JAX package's
train/checkpoint.py:_restore_raw does (so a checkpoint saved under tensor
parallelism comes back whole in one process), maps the state to the port's
names with x_as_supervision_tpu_torch/convert.py (parameters, BatchNorm
statistics, both Adams' moments and counts, the carried discriminator
gradient, step and epoch), builds the port's TrainState for the config on
the CPU, loads the arrays into it and writes
``<out>/{epoch:05d}_ckpt/state.pt`` through the port's save_checkpoint
(epoch: the epoch the JAX trainer saved it after). Copy that directory to
the machine with the card; there, with no further step, it

  * resumes:   python -m x_as_supervision_tpu_torch.train --config <cfg>
               --checkpoint <out>/<epoch>_ckpt
  * finetunes: ... --finetune --checkpoint <out>/<epoch>_ckpt
  * scores:    python -m x_as_supervision_tpu_torch.eval --config <cfg>
               --checkpoint <out>/<epoch>_ckpt
  * serves:    PoseEstimator(config, checkpoint_path=...), or
               python -m x_as_supervision_tpu_torch.infer --checkpoint ...
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def convert(config_path: str, checkpoint: str, out: str) -> str:
    """Writes the port's checkpoint of the JAX checkpoint `checkpoint`
    into `out`; returns its directory."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from x_as_supervision_tpu.train.checkpoint import _restore_raw
    from x_as_supervision_tpu_torch.config import load_config
    from x_as_supervision_tpu_torch.convert import (
        load_train_state,
        train_state_arrays_from_jax,
    )
    from x_as_supervision_tpu_torch.train.checkpoint import save_checkpoint
    from x_as_supervision_tpu_torch.train.factory import build_gan_spec
    from x_as_supervision_tpu_torch.train.state import TrainState

    config = load_config(config_path)
    arrays = train_state_arrays_from_jax(_restore_raw(checkpoint))
    spec = build_gan_spec(config, torch.float32)
    # steps per epoch only set the learning-rate milestones, which the
    # trainer recomputes from the dataset at every start
    state = TrainState(spec, config["train_params"], 1)
    load_train_state(spec, state, arrays)
    return save_checkpoint(out, max(state.epoch - 1, 0), state)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True,
                   help="the config the checkpoint was trained with")
    p.add_argument("--checkpoint", required=True,
                   help="the JAX trainer's {epoch:05d}_ckpt directory")
    p.add_argument("--out", required=True,
                   help="directory to write the port's checkpoint into")
    opt = p.parse_args(argv)
    path = convert(opt.config, opt.checkpoint, opt.out)
    print(f"converted {opt.checkpoint} -> {path}")
    return path


if __name__ == "__main__":
    main()
