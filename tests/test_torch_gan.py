"""The port's composed GAN losses (x_as_supervision_tpu_torch/models/
composed.py) and their gradients against the JAX package's
generator_forward / discriminator_forward, on the tiny flagship config with
the same flax-initialized weights and synthetic batch, fp32, the
discriminator header's dropout off on both sides (flax's nn.Dropout is
patched to the identity inside this test only). The ReLU inputs within
float32 rounding of 0 are decided on both sides as the port's float64 run
decides them, and a gradient whose float32 rounding exceeds half its bound
is held to that run (tests/torch_ties.py).
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
from x_as_supervision_tpu.train.state import make_optimizers
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
from torch_parity import jax_init_state
from torch_ties import JaxRelus, assert_held, held_run
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

BATCH = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(js, batch, dtype):
    """The port's spec with the JAX state's weights, and the batch, in
    `dtype` (float64: every module and the batch in float64)."""
    pspec = build_gan_spec(flagship_config(tiny=True), dtype)
    pspec.detector.load_state_dict(weights.state_dict_from_variables(
        {"params": _np(js.det_params), "batch_stats": _np(js.det_stats)}))
    pspec.physique.load_state_dict(weights.physique_state_dict(
        {"params": _np(js.phys_params), "batch_stats": _np(js.phys_stats)}))
    pspec.discriminator.load_state_dict(
        weights.discriminator_state_dict(_np(js.disc_params)))
    pspec.discriminator.header.p_dropout = 0.0
    tbatch = to_device(batch, "cpu")
    if dtype == torch.float64:
        for m in (pspec.detector, pspec.physique, pspec.discriminator):
            m.double()
        tbatch = {k: v.double() if v.is_floating_point() else v
                  for k, v in tbatch.items()}
    return pspec, tbatch


def _grads(loss, modules: dict) -> dict:
    """d loss / d every parameter of `modules`, keyed (module, name), as
    float64 arrays (None where the parameter takes no part)."""
    names = [(m, n) for m, mod in modules.items()
             for n, _ in mod.named_parameters()]
    grads = torch.autograd.grad(
        loss, [p for mod in modules.values() for p in mod.parameters()],
        allow_unused=True)
    return {k: None if g is None else g.double().numpy()
            for k, g in zip(names, grads)}


@pytest.fixture(scope="module")
def gan(tmp_path_factory):
    cfg = _flagship_config(tiny=True)
    batch = SyntheticPoseDataset(num_samples=BATCH, cam_id_list=(0, 1),
                                 patch_size=64).device_batch(0, BATCH)
    spec = jax_spec(cfg)
    opt_det, opt_disc = make_optimizers(cfg["train_params"], 10)
    js = jax_init_state(tmp_path_factory, cfg, batch, opt_det, opt_disc, 10)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def gen_run(dtype):
        pspec, tbatch = _port(js, batch, dtype)
        losses, _ = generator_forward(pspec, tbatch)
        total = sum(v.mean() for v in losses.values())
        return dict(losses={k: float(v.detach().mean())
                            for k, v in losses.items()},
                    grads=_grads(total, {"detector": pspec.detector,
                                         "physique": pspec.physique,
                                         "discriminator":
                                             pspec.discriminator}),
                    cancelled=pspec.physique.bn_cancelled_biases())

    def disc_run(dtype):
        pspec, tbatch = _port(js, batch, dtype)
        loss = discriminator_forward(pspec, tbatch)
        return dict(loss=float(loss.detach()), grads=_grads(
            loss, {"discriminator": pspec.discriminator}))

    # the port in float32 and float64, and its ReLU near-ties decided as
    # the float64 run decides them (tests/torch_ties.py) ...
    got, exact, ties = held_run(gen_run)
    got_d, exact_d, ties_d = held_run(disc_run)

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

    # ... and so in JAX's jitted functions, traced here
    gen_params = {"detector": js.det_params, "physique": js.phys_params}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        with JaxRelus(ties) as relus:
            (_, jlosses), (jg_gen, jg_disc) = jax.jit(jax.value_and_grad(
                gen_loss, argnums=(0, 1), has_aux=True))(gen_params,
                                                         js.disc_params)
        assert relus.calls == len(ties.shapes)
        with JaxRelus(ties_d) as relus:
            jloss_disc, jg_dd = jax.jit(jax.value_and_grad(disc_loss))(
                js.disc_params)
        assert relus.calls == len(ties_d.shapes)

    def want(module, tree, stats=None, keep_stats=False):
        if module == "detector":
            sd = weights.state_dict_from_variables(
                {"params": _np(tree), "batch_stats": _np(stats)})
        elif module == "physique":
            sd = weights.physique_state_dict(
                {"params": _np(tree), "batch_stats": _np(stats)})
        else:
            sd = weights.discriminator_state_dict(_np(tree))
        return {k: v.numpy() for k, v in sd.items() if keep_stats
                or ("running" not in k and "num_batches" not in k)}

    return dict(
        jlosses=jlosses, losses=got["losses"], got=got["grads"],
        exact=exact["grads"], ties=ties, ties_d=ties_d,
        want={"detector": want("detector", jg_gen["detector"],
                               js.det_stats),
              "physique": want("physique", jg_gen["physique"],
                               js.phys_stats),
              "discriminator": want("discriminator", jg_disc)},
        jloss_disc=float(jloss_disc), loss_disc=got_d["loss"],
        want_dd=want("discriminator", jg_dd), got_dd=got_d["grads"],
        exact_dd=exact_d["grads"], cancelled=got["cancelled"],
        # the physique gradients' and running statistics' largest entry
        cancelled_scale=max(float(np.abs(v).max()) for v in want(
            "physique", jg_gen["physique"], js.phys_stats,
            keep_stats=True).values()))


def test_generator_losses_match_jax(gan):
    assert sorted(gan["losses"]) == sorted(gan["jlosses"])
    for k, v in gan["jlosses"].items():
        # fp32, the same weights and batch, summed in other orders
        np.testing.assert_allclose(gan["losses"][k], float(v), rtol=2e-5,
                                   err_msg=k)


def test_discriminator_loss_matches_jax(gan):
    np.testing.assert_allclose(gan["loss_disc"], gan["jloss_disc"],
                               rtol=1e-5)


@pytest.mark.parametrize("module", ["detector", "physique", "discriminator"])
def test_generator_gradients_match_jax(gan, module):
    """Under the near-ties' exact decisions on both sides (both phases'
    near-ties listed in tests/torch_ties.py's terms)."""
    want = gan["want"][module]
    for k, w in want.items():
        g = gan["got"][(module, k)]
        g = np.zeros_like(w) if g is None else g
        if module == "physique" and k in gan["cancelled"]:
            # a train-mode BN cancels these biases: zero up to rounding
            assert np.abs(g).max() <= 1e-5 * gan["cancelled_scale"], k
            continue
        e = gan["exact"][(module, k)]
        e = np.zeros_like(w) if e is None else e
        # fp32 backward through ResNet-18, the decode, the renderer, the
        # physique net and the discriminator, summed in other orders:
        # relative to the tensor's largest gradient (assert_held: against
        # the port's float64 where its own float32 rounding takes more
        # than half of that)
        tol = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        assert_held(g, w, e, rtol=1e-3, atol=tol, err_msg=f"{module}.{k}")


def test_discriminator_gradients_match_jax(gan):
    for k, w in gan["want_dd"].items():
        assert_held(gan["got_dd"][("discriminator", k)], w,
                    gan["exact_dd"][("discriminator", k)], rtol=1e-4,
                    atol=1e-5 * float(np.abs(w).max()), err_msg=k)
