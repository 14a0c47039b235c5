"""The port's generator-only and discriminator-only train steps
(train/state.py, the update cadence of update_interval != 1) against the
JAX package's jitted step variants, on the tiny flagship config, fp32: a
generator-only step, which adds its smpl_gen gradient to the carried
discriminator gradient, then a discriminator-only step, which consumes it.
Each step starts from the JAX train state carried into the port. The
discriminator header's dropout is off on both sides (flax's nn.Dropout is
patched to the identity inside this test only).
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from torch_parity import (
    assert_step_matches,
    carry_train_state,
    jax_state_in_port_names,
    to_numpy_tree,
)
from x_as_supervision_tpu.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu.train.factory import build_gan_spec as jax_spec
from x_as_supervision_tpu.train.state import (
    make_optimizers,
    make_train_step,
)
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.train.factory import (
    build_gan_spec,
    flagship_config,
)
from x_as_supervision_tpu_torch.train.state import TrainState, train_step
from x_as_supervision_tpu_torch.train.trainer import (
    to_device,
    update_intervals,
)
from torch_parity import jax_init_state
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

BATCH = 2
LR = 1e-4
VARIANTS = ((False, True), (True, False))  # (do_disc, do_gen)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    cfg = _flagship_config(tiny=True)
    ds = SyntheticPoseDataset(num_samples=2 * BATCH, cam_id_list=(0, 1),
                              patch_size=64)
    spec = jax_spec(cfg)
    opt_det, opt_disc = make_optimizers(cfg["train_params"], 10)
    js = jax_init_state(tmp_path_factory, cfg, ds.device_batch(0, BATCH),
                        opt_det, opt_disc, 10)
    step = make_train_step(spec, opt_det, opt_disc)
    pspec = build_gan_spec(flagship_config(tiny=True), torch.float32)
    pspec.discriminator.header.p_dropout = 0.0
    state = TrainState(pspec, cfg["train_params"], 10)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        for i, (do_disc, do_gen) in enumerate(VARIANTS):
            batch = ds.device_batch(i * BATCH, BATCH)
            before = jax_state_in_port_names(js)
            carry_train_state(pspec, state, js)
            js, jmetrics, _ = step(js, batch, jax.random.PRNGKey(i),
                                   do_disc=do_disc, do_gen=do_gen,
                                   with_outputs=False)
            metrics = train_step(state, to_device(batch, "cpu"),
                                 do_disc=do_disc, do_gen=do_gen)
            got = {}
            for prefix in ("detector", "physique", "discriminator"):
                got.update({f"{prefix}.{k}": v.detach().clone() for k, v in
                            getattr(pspec, prefix).state_dict().items()
                            if "num_batches" not in k})
            out.append(dict(
                before=before, got=got, want=jax_state_in_port_names(js),
                want_metrics={k: float(v) for k, v in jmetrics.items()},
                metrics={k: float(v) for k, v in metrics.items()},
                want_pending=weights.discriminator_state_dict(
                    to_numpy_tree(js.pending_disc_grads)),
                pending=dict(zip(state.disc_names,
                                 state.pending_disc_grads))))
    return out, pspec


@pytest.mark.parametrize("i", range(len(VARIANTS)),
                         ids=["gen_only", "disc_only"])
def test_variant_matches_jax(steps, i):
    step, pspec = steps[0][i], steps[1]
    assert sorted(step["metrics"]) == sorted(step["want_metrics"])
    for k, v in step["want_metrics"].items():
        # fp32 from the same state, summed in other orders (see
        # test_torch_train.py)
        np.testing.assert_allclose(step["metrics"][k], v, rtol=1e-4,
                                   err_msg=k)
    assert_step_matches(step["want"], step["got"], step["before"], pspec, LR)
    want, got = step["want_pending"], step["pending"]
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for k in want:
        # zero after the discriminator-only step, as in JAX
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5 * max(scale, 1e-30),
                                   err_msg=k)


def test_generator_only_step_carries_and_disc_only_consumes(steps):
    gen_only, disc_only = steps[0]
    assert max(float(v.abs().max()) for v in gen_only["pending"].values()) > 0
    assert all(float(v.abs().max()) == 0 for v in disc_only["pending"].values())


@pytest.mark.parametrize("interval,want", [(1, (1, 1)), (2, (2, 1)),
                                           (0.5, (1, 2)), (0.25, (1, 4))])
def test_update_intervals_follow_the_jax_trainer(interval, want):
    cfg = flagship_config(tiny=True)
    cfg["model_params"]["loss_config"]["smpl_disc_loss"]["update_interval"] = (
        interval)
    assert update_intervals(cfg) == want
