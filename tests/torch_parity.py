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
from x_as_supervision_tpu_torch.convert import (
    load_train_state,
    module_arrays,
    train_state_arrays_from_jax,
)
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


def jax_state_in_port_names(js) -> dict:
    """A JAX TrainState's variables (parameters and BatchNorm statistics)
    as a flat dict of arrays in the port's names (detector., physique.,
    discriminator.): the port's convert.module_arrays."""
    return module_arrays(*(to_numpy_tree(getattr(js, f)) for f in (
        "det_params", "det_stats", "phys_params", "phys_stats",
        "disc_params")))


def raw_train_state(js) -> dict:
    """A live JAX TrainState as the tree an Orbax restore without a target
    returns: dicts keyed by its fields, each optimizer state a list (the
    Adam state as a dict, then the schedule's)."""
    def chain(opt):
        adam = opt[0]
        return [dict(count=adam.count, mu=adam.mu, nu=adam.nu),
                dict(count=opt[1].count)]

    return dict(det_params=js.det_params, det_stats=js.det_stats,
                phys_params=js.phys_params, phys_stats=js.phys_stats,
                disc_params=js.disc_params, opt_det=chain(js.opt_det),
                opt_disc=chain(js.opt_disc),
                pending_disc_grads=js.pending_disc_grads, step=js.step,
                epoch=js.epoch)


def train_state_arrays(js) -> dict:
    """A JAX TrainState as flat numpy arrays in the port's names, the
    layout convert.load_train_state reads (an npz of it reaches a process
    without JAX): the port's convert.train_state_arrays_from_jax."""
    return train_state_arrays_from_jax(to_numpy_tree(raw_train_state(js)))


def carry_train_state(pspec, state, js) -> None:
    """Carry a JAX TrainState into the port: parameters and BatchNorm
    statistics into the spec's modules; both Adam states, their update
    counts and the carried discriminator gradient into the TrainState."""
    load_train_state(pspec, state, train_state_arrays(js))
