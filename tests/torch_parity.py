"""Shared helpers of the tests that hold the PyTorch port to the JAX package:
one set of seeded weights and inputs, handed to both as numpy arrays."""

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
from x_as_supervision_tpu_torch.models.detector import (
    build_detector as torch_build,
)


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


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
