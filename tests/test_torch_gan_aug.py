"""The port's rotation augmentation (smpl_disc_params.use_aug, models/
composed.py) against the JAX package's generator_forward and
discriminator_forward on the tiny flagship config with use_aug, the same
flax-initialized weights and synthetic batch, fp32, dropout off on both
sides (flax's nn.Dropout is patched to the identity inside this test only).
The rotations' uniforms are the JAX package's own: the generator phase's
from its k_rot = split(key, 3)[1], the discriminator phase's from its
k_rot = split(key, 4)[2], passed to the port as ``rot_u``.

Held: every loss; the smpl_gen loss's gradients, into the discriminator
and into the detector, which only the rotated (not detached) branch
carries; the discriminator loss, its gradients and the rotated
visualization outputs. The ReLU inputs within float32 rounding of 0 are
decided on both sides as the port's float64 run decides them, and a
gradient whose float32 rounding exceeds half its bound is held to that run
(tests/torch_ties.py).
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
GEN_KEY, DISC_KEY = 1, 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def aug_config(cfg: dict) -> dict:
    cfg["model_params"]["smpl_disc_params"]["use_aug"] = True
    return cfg


def jax_rot_draws(key, nc: int, b: int, nh: int) -> dict:
    """The uniforms of use_aug's two rotations under the JAX train step's
    key for one step: the phases' keys split from it as make_train_step
    splits them, then as generator_forward and discriminator_forward do."""
    k_disc, k_gen = jax.random.split(key)
    return rot_draws_of(k_gen, k_disc, nc, b, nh)


def rot_draws_of(k_gen, k_disc, nc: int, b: int, nh: int) -> dict:
    u_gen = jax.random.uniform(jax.random.split(k_gen, 3)[1], (nc * b * nh,))
    u_disc = jax.random.uniform(jax.random.split(k_disc, 4)[2], (nc * b,))
    return {"gen": torch.from_numpy(np.array(u_gen)),
            "disc": torch.from_numpy(np.array(u_disc))}


def _port(js, batch, dtype):
    """The port's use_aug spec with the JAX state's weights, and the batch,
    in `dtype` (float64: every module and the batch in float64)."""
    pspec = build_gan_spec(aug_config(flagship_config(tiny=True)), dtype)
    assert pspec.use_aug
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


def _named(module, grads) -> dict:
    return {n: None if g is None else g.double().numpy()
            for (n, _), g in zip(module.named_parameters(), grads)}


@pytest.fixture(scope="module")
def gan(tmp_path_factory):
    cfg = aug_config(_flagship_config(tiny=True))
    batch = SyntheticPoseDataset(num_samples=BATCH, cam_id_list=(0, 1),
                                 patch_size=64).device_batch(0, BATCH)
    spec = jax_spec(cfg)
    assert spec.use_aug
    opt_det, opt_disc = make_optimizers(cfg["train_params"], 10)
    js = jax_init_state(tmp_path_factory, cfg, batch, opt_det, opt_disc, 10,
                        jit=True)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    nh = cfg["model_params"]["detector_params"]["num_hypo"]
    draws = rot_draws_of(jax.random.PRNGKey(GEN_KEY),
                         jax.random.PRNGKey(DISC_KEY), 2, BATCH, nh)

    def port_gen(dtype, use_aug=True):
        pspec, tbatch = _port(js, batch, dtype)
        pspec.use_aug = use_aug
        rot_u = draws["gen"].to(dtype) if use_aug else None
        losses, _ = generator_forward(pspec, tbatch, rot_u=rot_u)
        grads = torch.autograd.grad(
            losses["smpl_gen"], list(pspec.detector.parameters())
            + list(pspec.discriminator.parameters()), allow_unused=True)
        n = len(list(pspec.detector.parameters()))
        return dict(losses={k: float(v.detach()) for k, v in losses.items()},
                    det=_named(pspec.detector, grads[:n]),
                    disc=_named(pspec.discriminator, grads[n:]))

    def port_disc(dtype):
        pspec, tbatch = _port(js, batch, dtype)
        outs = {}
        loss = discriminator_forward(pspec, tbatch, outputs=outs,
                                     rot_u=draws["disc"].to(dtype))
        grads = torch.autograd.grad(loss,
                                    list(pspec.discriminator.parameters()))
        return dict(loss=float(loss.detach()),
                    grads=_named(pspec.discriminator, grads),
                    outs={k: v.double().numpy() for k, v in outs.items()})

    # the port in float32 and float64, and its ReLU near-ties decided as
    # the float64 run decides them (tests/torch_ties.py) ...
    got, exact, ties = held_run(port_gen)
    plain = port_gen(torch.float32, use_aug=False)
    got_d, exact_d, ties_d = held_run(port_disc)

    def gen_loss(det_params, disc_params):
        losses, _, _, _ = jax_gen_forward(
            spec, {"params": det_params, "batch_stats": js.det_stats},
            {"params": js.phys_params, "batch_stats": js.phys_stats},
            disc_params, jbatch, jax.random.PRNGKey(GEN_KEY), train=True)
        return (jnp.mean(losses["smpl_gen"]),
                {k: jnp.mean(v) for k, v in losses.items()})

    def disc_loss(disc_params):
        loss, outputs, _ = jax_disc_forward(
            spec, disc_params, {"params": js.det_params,
                                "batch_stats": js.det_stats},
            jbatch, jax.random.PRNGKey(DISC_KEY), train=True)
        return loss, outputs

    # ... and so in JAX's jitted functions, traced here
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        with JaxRelus(ties) as relus:
            (_, jlosses), (jg_det, jg_disc) = jax.jit(jax.value_and_grad(
                gen_loss, argnums=(0, 1), has_aux=True))(js.det_params,
                                                         js.disc_params)
        assert relus.calls == len(ties.shapes)
        with JaxRelus(ties_d) as relus:
            (jloss_disc, jouts), jg_dd = jax.jit(jax.value_and_grad(
                disc_loss, has_aux=True))(js.disc_params)
        assert relus.calls == len(ties_d.shapes)

    det_want = weights.state_dict_from_variables(
        {"params": _np(jg_det), "batch_stats": _np(js.det_stats)})
    return dict(
        jlosses=jlosses, losses=got["losses"], g_det=got["det"],
        exact_det=exact["det"], g_det_plain=plain["det"],
        want_det={k: v.numpy() for k, v in det_want.items()
                  if k in got["det"]},
        g_disc=got["disc"], exact_disc=exact["disc"],
        want_disc={k: v.numpy() for k, v in
                   weights.discriminator_state_dict(_np(jg_disc)).items()},
        loss_disc=got_d["loss"], jloss_disc=float(jloss_disc),
        g_dd=got_d["grads"], exact_dd=exact_d["grads"],
        want_dd={k: v.numpy() for k, v in
                 weights.discriminator_state_dict(_np(jg_dd)).items()},
        outs=got_d["outs"], jouts=_np(jouts))


def test_generator_losses_match_jax(gan):
    assert sorted(gan["losses"]) == sorted(gan["jlosses"])
    for k, v in gan["jlosses"].items():
        # fp32, the same weights, batch and rotations, summed in other orders
        np.testing.assert_allclose(gan["losses"][k], float(v), rtol=2e-5,
                                   err_msg=k)


def _assert_grads(got: dict, want: dict, exact: dict, what: str) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, e = (np.zeros_like(w) if a is None else a
                for a in (got[k], exact[k]))
        # fp32 backward, relative to the tensor's largest gradient (against
        # the port's float64 where its own float32 rounding takes more than
        # half of that: tests/torch_ties.py:assert_held)
        assert_held(g, w, e, rtol=1e-3,
                    atol=1e-4 * max(np.abs(w).max(), 1e-30),
                    err_msg=f"{what}.{k}")


def test_smpl_gen_detector_gradient_is_the_rotated_branch(gan):
    # the rotated branch carries a gradient into the detector ...
    largest = max(float(np.abs(g).max()) for g in gan["g_det"].values()
                  if g is not None)
    assert largest > 0
    _assert_grads(gan["g_det"], gan["want_det"], gan["exact_det"],
                  "detector")
    # ... and nothing else does: without use_aug the branch is detached
    assert all(g is None or not g.any() for g in gan["g_det_plain"].values())


def test_smpl_gen_discriminator_gradient_matches_jax(gan):
    _assert_grads(gan["g_disc"], gan["want_disc"], gan["exact_disc"],
                  "discriminator")


def test_discriminator_phase_matches_jax(gan):
    np.testing.assert_allclose(gan["loss_disc"], gan["jloss_disc"],
                               rtol=1e-5)
    for k, w in gan["want_dd"].items():
        assert_held(gan["g_dd"][k], w, gan["exact_dd"][k], rtol=1e-4,
                    atol=1e-5 * float(np.abs(w).max()), err_msg=k)
    rot = sorted(k for k in gan["jouts"] if k.endswith("_rot"))
    assert rot == ["pose_smpl_3d_cam_0_rot", "pose_smpl_3d_cam_1_rot"]
    assert sorted(gan["outs"]) == sorted(gan["jouts"])
    for k in rot:
        np.testing.assert_allclose(gan["outs"][k], gan["jouts"][k],
                                   rtol=1e-6, atol=1e-4, err_msg=k)
