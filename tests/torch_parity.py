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


def _adam_state(opt, names, params, adam, mu: dict, nu: dict) -> None:
    for n, p in zip(names, params):
        opt.state[p] = {"step": torch.tensor(float(adam.count)),
                        "exp_avg": mu[n].clone(), "exp_avg_sq": nu[n].clone()}


def carry_train_state(pspec, state, js) -> None:
    """Carry a JAX TrainState into the port: parameters and BatchNorm
    statistics into the spec's modules; both Adam states, their update
    counts and the carried discriminator gradient into the TrainState."""
    sd = jax_state_in_port_names(js)
    for prefix in ("detector", "physique", "discriminator"):
        getattr(pspec, prefix).load_state_dict(
            {k[len(prefix) + 1:]: v for k, v in sd.items()
             if k.startswith(prefix + ".")}, strict=False)
    det_adam, disc_adam = js.opt_det[0], js.opt_disc[0]
    _adam_state(state.opt_det, state.gen_names, state.gen_params, det_adam,
                *(_gen_sd(m["detector"], js.det_stats, m["physique"],
                          js.phys_stats)
                  for m in (det_adam.mu, det_adam.nu)))
    _adam_state(state.opt_disc, state.disc_names, state.disc_params,
                disc_adam, *(weights.discriminator_state_dict(to_numpy_tree(m))
                             for m in (disc_adam.mu, disc_adam.nu)))
    state.det_updates = int(det_adam.count)
    state.disc_updates = int(disc_adam.count)
    pending = weights.discriminator_state_dict(
        to_numpy_tree(js.pending_disc_grads))
    state.pending_disc_grads = [pending[n].clone() for n in state.disc_names]


def assert_step_matches(want: dict, got: dict, before: dict, pspec,
                        lr: float) -> None:
    """Hold the port's parameters and BatchNorm statistics after one train
    step (`got`, tensors) to JAX's (`want`, arrays), both from the same
    state (`before`); lr is the step's learning rate."""
    assert sorted(got) == sorted(want)
    cancelled = {"physique." + n for n in pspec.physique.bn_cancelled_biases()}
    diffs, moved = [], 0.0
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        if "running" in k:
            # fp32 batch statistics of the same activations; a mean that
            # follows a cancelled bias moves with that bias (below)
            atol = 2 * lr if "physique.bns" in k and "mean" in k else 1e-6
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=k)
            continue
        if k in cancelled:
            # zero gradient up to rounding (a train-mode BN follows), which
            # Adam turns into a step of up to about lr of either sign
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr, err_msg=k)
            continue
        d = np.abs(g - w)
        # every weight within Adam's step bound of lr (g / (|g| + eps) of a
        # gradient near eps = 1e-8 is decided by rounding) ...
        assert d.max() <= 2 * lr, k
        diffs.append(d.ravel())
        moved = max(moved, float(np.abs(w - np.asarray(before[k])).max()))
    # ... half of them within 1e-3 of a step and all but 1e-3 of them within
    # 0.1 of a step: Adam divides each gradient by the root of its running
    # square, so a weight whose gradient is small next to its history
    # carries the gradient's relative rounding into its step (measured at
    # the third fused step: median 1.5e-4, 99.9th percentile 1.9e-2 of a
    # step)
    d = np.concatenate(diffs)
    assert np.quantile(d, 0.5) <= 1e-3 * lr
    assert np.mean(d > 0.1 * lr) <= 1e-3
    assert moved > 0.5 * lr  # the step did move the weights
