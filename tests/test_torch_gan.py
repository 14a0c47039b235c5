"""The port's composed GAN losses (x_as_supervision_tpu_torch/models/
composed.py) and their gradients against the JAX package's
generator_forward / discriminator_forward, on the tiny flagship config with
the same flax-initialized weights and synthetic batch, fp32, the
discriminator header's dropout off on both sides (flax's nn.Dropout is
patched to the identity inside this test only).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from x_as_supervision_tpu.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu.models.composed import (
    discriminator_forward as jax_disc_forward,
)
from x_as_supervision_tpu.models.composed import (
    generator_forward as jax_gen_forward,
)
from x_as_supervision_tpu.train.factory import build_gan_spec as jax_spec
from x_as_supervision_tpu.train.state import init_train_state, make_optimizers
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.models.composed import (
    discriminator_forward,
    generator_forward,
)
from x_as_supervision_tpu_torch.train.factory import (
    build_gan_spec,
    flagship_config,
)
from x_as_supervision_tpu_torch.train.trainer import to_device

BATCH = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def gan():
    cfg = _flagship_config(tiny=True)
    batch = SyntheticPoseDataset(num_samples=BATCH, cam_id_list=(0, 1),
                                 patch_size=64).device_batch(0, BATCH)
    spec = jax_spec(cfg)
    opt_det, opt_disc = make_optimizers(cfg["train_params"], 10)
    js = init_train_state(spec, jax.random.PRNGKey(0), batch, opt_det,
                          opt_disc)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def gen_loss(gen_params, disc_params):
        losses, _, _, _ = jax_gen_forward(
            spec, {"params": gen_params["detector"],
                   "batch_stats": js.det_stats},
            {"params": gen_params["physique"], "batch_stats": js.phys_stats},
            disc_params, jbatch, jax.random.PRNGKey(1), train=True)
        total = sum(jnp.mean(v) for v in losses.values())
        return total, {k: jnp.mean(v) for k, v in losses.items()}

    def disc_loss(disc_params):
        loss, _, _ = jax_disc_forward(
            spec, disc_params, {"params": js.det_params,
                                "batch_stats": js.det_stats},
            jbatch, jax.random.PRNGKey(2), train=True)
        return loss

    gen_params = {"detector": js.det_params, "physique": js.phys_params}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        (_, jlosses), (jg_gen, jg_disc) = jax.jit(jax.value_and_grad(
            gen_loss, argnums=(0, 1), has_aux=True))(gen_params,
                                                     js.disc_params)
        jloss_disc, jg_dd = jax.jit(jax.value_and_grad(disc_loss))(
            js.disc_params)

    pspec = build_gan_spec(flagship_config(tiny=True), torch.float32)
    pspec.detector.load_state_dict(weights.state_dict_from_variables(
        {"params": _np(js.det_params), "batch_stats": _np(js.det_stats)}))
    pspec.physique.load_state_dict(weights.physique_state_dict(
        {"params": _np(js.phys_params), "batch_stats": _np(js.phys_stats)}))
    pspec.discriminator.load_state_dict(
        weights.discriminator_state_dict(_np(js.disc_params)))
    pspec.discriminator.header.p_dropout = 0.0
    tbatch = to_device(batch, "cpu")
    losses, _ = generator_forward(pspec, tbatch)
    total = sum(v.mean() for v in losses.values())
    modules = {"detector": pspec.detector, "physique": pspec.physique,
               "discriminator": pspec.discriminator}
    names = [(m, n) for m, mod in modules.items()
             for n, _ in mod.named_parameters()]
    params = [p for mod in modules.values() for p in mod.parameters()]
    grads = torch.autograd.grad(total, params, allow_unused=True)
    pg = {(m, n): g for (m, n), g in zip(names, grads)}
    loss_disc = discriminator_forward(pspec, tbatch)
    dnames = [n for n, _ in pspec.discriminator.named_parameters()]
    pg_dd = dict(zip(dnames, torch.autograd.grad(
        loss_disc, list(pspec.discriminator.parameters()))))

    want = {"detector": weights.state_dict_from_variables(
                {"params": _np(jg_gen["detector"]),
                 "batch_stats": _np(js.det_stats)}),
            "physique": weights.physique_state_dict(
                {"params": _np(jg_gen["physique"]),
                 "batch_stats": _np(js.phys_stats)}),
            "discriminator": weights.discriminator_state_dict(_np(jg_disc))}
    return dict(jlosses=jlosses, losses=losses, want=want, got=pg,
                jloss_disc=float(jloss_disc), loss_disc=float(loss_disc),
                want_dd=weights.discriminator_state_dict(_np(jg_dd)),
                got_dd=pg_dd, cancelled=pspec.physique.bn_cancelled_biases())


def test_generator_losses_match_jax(gan):
    assert sorted(gan["losses"]) == sorted(gan["jlosses"])
    for k, v in gan["jlosses"].items():
        # fp32, the same weights and batch, summed in other orders
        np.testing.assert_allclose(float(gan["losses"][k]), float(v),
                                   rtol=2e-5, err_msg=k)


def test_discriminator_loss_matches_jax(gan):
    np.testing.assert_allclose(gan["loss_disc"], gan["jloss_disc"],
                               rtol=1e-5)


@pytest.mark.parametrize("module", ["detector", "physique", "discriminator"])
def test_generator_gradients_match_jax(gan, module):
    want = {k: v for k, v in gan["want"][module].items()
            if "running" not in k and "num_batches" not in k}
    for k, w in want.items():
        g = gan["got"][(module, k)]
        g = torch.zeros_like(w) if g is None else g
        w = w.numpy()
        if module == "physique" and k in gan["cancelled"]:
            # a train-mode BN cancels these biases: zero up to rounding
            scale = max(float(np.abs(v.numpy()).max())
                        for v in gan["want"]["physique"].values())
            assert np.abs(g.numpy()).max() <= 1e-5 * scale, k
            continue
        # fp32 backward through ResNet-18, the decode, the renderer, the
        # physique net and the discriminator, summed in other orders:
        # relative to the tensor's largest gradient
        tol = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=tol,
                                   err_msg=f"{module}.{k}")


def test_discriminator_gradients_match_jax(gan):
    for k, w in gan["want_dd"].items():
        w = w.numpy()
        np.testing.assert_allclose(
            gan["got_dd"][k].numpy(), w, rtol=1e-4,
            atol=1e-5 * float(np.abs(w).max()), err_msg=k)
