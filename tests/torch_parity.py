"""Shared helpers of the tests that hold the PyTorch port to the JAX package:
one set of seeded weights and inputs, handed to both as numpy arrays, and a
JAX train state carried into the port."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from x_as_supervision_tpu.models.detector import build_detector as jax_build
from x_as_supervision_tpu.tools.convert_torch_resnet import (
    convert_full_detector,
)
from x_as_supervision_tpu_torch import weights
from step_bounds import assert_step_matches  # noqa: F401 (re-exported)
from x_as_supervision_tpu_torch.checks import load_train_state
from x_as_supervision_tpu_torch.models.detector import (
    build_detector as torch_build,
)


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)



def smpl_from_jax(jmodel, device=None):
    """A JAX SmplModel's arrays carried into the port's SmplModel."""
    from x_as_supervision_tpu_torch.models.smpl import smpl_from_arrays

    arrays = {k: np.asarray(v) for k, v in jmodel._asdict().items()}
    return smpl_from_arrays(arrays, device)


def conditioned_pair(det_params: dict, size: int, batch: int, seed: int):
    """A JAX detector initialized by flax, carried into the port through
    weights.py, conditioned there (weights.condition_for_eval on seeded
    images) and carried back through the JAX package's
    convert_full_detector.

    Returns (jax_detector, jax_variables, port_detector, images (N, S, S, 3)
    float32 in [0, 1))."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    jdet = jax_build(det_params, dtype=jnp.float32)
    init = jdet.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
                     train=False)
    tdet = torch_build(det_params)
    tdet.load_state_dict(weights.state_dict_from_variables(
        to_numpy_tree(init)))
    weights.condition_for_eval(tdet, nchw(images))
    sd = {k: v.numpy() for k, v in tdet.state_dict().items()}
    params, stats = convert_full_detector(sd, det_params.get("num_layers", 50))
    return jdet, {"params": params, "batch_stats": stats}, tdet, images


def _gen_sd(det, det_stats, phys, phys_stats) -> dict:
    sd = {"detector." + k: v for k, v in weights.state_dict_from_variables(
        {"params": to_numpy_tree(det),
         "batch_stats": to_numpy_tree(det_stats)}).items()}
    sd.update({"physique." + k: v for k, v in weights.physique_state_dict(
        {"params": to_numpy_tree(phys),
         "batch_stats": to_numpy_tree(phys_stats)}).items()})
    return sd


def jax_state_in_port_names(js) -> dict:
    """A JAX TrainState's variables (parameters and BatchNorm statistics)
    as a flat dict in the port's names (detector., physique.,
    discriminator.)."""
    sd = _gen_sd(js.det_params, js.det_stats, js.phys_params, js.phys_stats)
    sd.update({"discriminator." + k: v for k, v in
               weights.discriminator_state_dict(
                   to_numpy_tree(js.disc_params)).items()})
    return {k: v for k, v in sd.items() if "num_batches" not in k}


def train_state_arrays(js) -> dict:
    """A JAX TrainState as flat numpy arrays in the port's names, the
    layout checks.load_train_state reads (an npz of it reaches a process
    without JAX)."""
    out = {"var/" + k: np.asarray(v)
           for k, v in jax_state_in_port_names(js).items()}
    det_adam, disc_adam = js.opt_det[0], js.opt_disc[0]
    for tag, m in (("mu", det_adam.mu), ("nu", det_adam.nu)):
        out.update({f"{tag}/det/{k}": np.asarray(v) for k, v in _gen_sd(
            m["detector"], js.det_stats, m["physique"], js.phys_stats
        ).items()})
    for tag, m in (("mu", disc_adam.mu), ("nu", disc_adam.nu)):
        out.update({f"{tag}/disc/{k}": np.asarray(v) for k, v in
                    weights.discriminator_state_dict(
                        to_numpy_tree(m)).items()})
    out.update({"pending/" + k: np.asarray(v) for k, v in
                weights.discriminator_state_dict(
                    to_numpy_tree(js.pending_disc_grads)).items()})
    out["count/det"] = np.asarray(int(det_adam.count))
    out["count/disc"] = np.asarray(int(disc_adam.count))
    return out


def carry_train_state(pspec, state, js) -> None:
    """Carry a JAX TrainState into the port: parameters and BatchNorm
    statistics into the spec's modules; both Adam states, their update
    counts and the carried discriminator gradient into the TrainState."""
    load_train_state(pspec, state, train_state_arrays(js))
