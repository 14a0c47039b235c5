"""Checkpoints of the train state, with the JAX package's three restore
modes (its train/checkpoint.py, with orbax replaced by ``torch.save`` of a
plain dict):

  * resume   - the full state: the detector, physique net and discriminator
               (parameters and BatchNorm running statistics), both Adam
               states, the update counts, the carried discriminator
               gradient, step and epoch; reference: train.py:101-118.
  * finetune - weights and statistics only, fresh optimizers and counters
               ("do not load optimizer during finetune", reference:
               train.py:115-121); a checkpoint whose discriminator has other
               shapes leaves the fresh one in place ("Load new discriminator
               for ablation", reference: train.py:107-113).
  * detector - the detector's state_dict only, for eval.

A checkpoint is the directory ``<save_dir>/{epoch:05d}_ckpt`` (the JAX
package's name) holding ``state.pt``, which ``torch.load(weights_only=True)``
reads: tensors, numbers, strings, lists and dicts only. Every load names
its ``map_location``, so a checkpoint saved on the card restores on the CPU
and the other way round.

Data parallelism (parallel/): every rank holds the same state, so rank 0
alone writes it and every rank waits at a barrier until the file is whole;
every rank restores from that one file. Under tensor parallelism
(parallel/tp.py) the model ranks gather their shards into the whole state
first, so the file is the one a single process writes, whatever the
layout of the run that wrote it or reads it; a restore into a split state
takes this rank's shards of it.
"""

from __future__ import annotations

import os
import re

import torch

from ..parallel import mesh, tp
from .state import TrainState

_CKPT_RE = re.compile(r"^(\d{5})_ckpt$")
STATE_FILE = "state.pt"
_MODULES = ("detector", "physique", "discriminator")


def ckpt_path(save_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(save_dir), f"{epoch:05d}_ckpt")


def latest_checkpoint(save_dir: str) -> str | None:
    """The checkpoint of the highest epoch in `save_dir`, or None."""
    if not os.path.isdir(save_dir):
        return None
    found = []
    for name in os.listdir(save_dir):
        m = _CKPT_RE.match(name)
        if m:
            found.append((int(m.group(1)), name))
    if not found:
        return None
    found.sort()
    return os.path.join(os.path.abspath(save_dir), found[-1][1])


def state_dict(state: TrainState) -> dict:
    """The train state as a plain dict of state_dicts, tensors and ints."""
    out = {name: (getattr(state.spec, name).state_dict()
                  if getattr(state.spec, name) is not None else {})
           for name in _MODULES}
    out.update(
        opt_det=state.opt_det.state_dict(),
        opt_disc=(state.opt_disc.state_dict()
                  if state.opt_disc is not None else {}),
        det_updates=state.det_updates,
        disc_updates=state.disc_updates,
        pending_disc_grads=list(state.pending_disc_grads),
        step=state.step,
        epoch=state.epoch,
    )
    return out


def save_checkpoint(save_dir: str, epoch: int, state: TrainState) -> str:
    """Writes ``{epoch:05d}_ckpt/state.pt`` (through a temporary file, so a
    checkpoint that exists is whole; in a process group rank 0 writes the
    whole state, gathered over the model ranks, and every rank returns
    after it has); returns the directory."""
    path = ckpt_path(save_dir, epoch)
    whole = tp.gather_state(state, state_dict(state))
    if mesh.process_index() == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(whole, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
    mesh.barrier()
    return path


def load_raw(path: str, map_location="cpu") -> dict:
    """The checkpoint's dict, its tensors on `map_location`."""
    return torch.load(os.path.join(path, STATE_FILE),
                      map_location=map_location, weights_only=True)


def restore_resume(path: str, state: TrainState) -> TrainState:
    """Full-state restore (train resume), in place into `state`, whose
    modules and optimizers are built as for the saved run. The file is read
    onto the CPU; the weights and Adam moments go to the devices of the
    state's parameters, the Adam step counts stay on the CPU (as a fresh
    run keeps them) and the carried gradient goes to its parameter's
    device. A split state takes its shards (parallel/tp.py)."""
    return load_state(state, load_raw(path, "cpu"))


def load_state(state: TrainState, raw: dict) -> TrainState:
    """restore_resume from `raw`, a whole state_dict() (a checkpoint's, or
    a copy of another state's: the optimizers keep the tensors they are
    given)."""
    raw = tp.shard_raw(raw, state)
    for name in _MODULES:
        module = getattr(state.spec, name)
        if module is not None:
            module.load_state_dict(raw[name])
    state.opt_det.load_state_dict(raw["opt_det"])
    if state.opt_disc is not None:
        state.opt_disc.load_state_dict(raw["opt_disc"])
    state.det_updates = int(raw["det_updates"])
    state.disc_updates = int(raw["disc_updates"])
    state.pending_disc_grads = [g.to(p.device, copy=True) for g, p in zip(
        raw["pending_disc_grads"], state.disc_params, strict=True)]
    state.step = int(raw["step"])
    state.epoch = int(raw["epoch"])
    return state


def _same_shapes(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(a[k].shape == b[k].shape for k in a)


def restore_finetune(path: str, state: TrainState) -> TrainState:
    """Weights and statistics only, in place into a fresh `state`: its
    optimizers, counters, carried gradient, step and epoch stay fresh; a
    discriminator of other shapes stays fresh. A split state takes its
    shards."""
    raw = tp.shard_raw(load_raw(path, "cpu"), state, modules_only=True)
    for name in ("detector", "physique"):
        module = getattr(state.spec, name)
        if module is not None:
            module.load_state_dict(raw[name])
    disc = state.spec.discriminator
    if disc is not None:
        if _same_shapes(raw["discriminator"], disc.state_dict()):
            disc.load_state_dict(raw["discriminator"])
        else:
            print("Load new discriminator for ablation")
    return state


def restore_detector(path: str, map_location="cpu") -> dict:
    """The detector's state_dict (parameters and running statistics), for
    eval."""
    return load_raw(path, map_location)["detector"]
