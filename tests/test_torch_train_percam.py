"""The port's fused GAN train step with the multi-view options that the
shipped configs and the JAX factory add to the flagship
(model_params.per_camera_bn, smpl_disc_params.use_aug and the res_gcn
discriminator with use_bn) against the JAX
package's jitted step on the tiny flagship config, fp32, over a 3-step
trajectory, each step from the JAX train state carried into the port (as
test_torch_train.py does). Dropout is off on both sides (flax's nn.Dropout
patched to the identity inside this test only); the rotations' uniforms are
the JAX step's own, recomputed from its key and passed to the port's
train_step as ``rot_draws``. Then the same options through the train CLI to
a checkpoint and the eval CLI, on the CPU; the port's JSON copy of
config/Campaign_SurS2_percam.yaml; and model_params.fuse_gan_step.
"""

import json
import os

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from test_torch_gan_aug import jax_rot_draws
from torch_parity import (
    assert_step_matches,
    carry_train_state,
    jax_state_in_port_names,
    to_numpy_tree,
)
from x_as_supervision_tpu.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu.train.factory import build_gan_spec as jax_spec
from x_as_supervision_tpu.train.state import (
    init_train_state,
    make_optimizers,
    make_train_step,
)
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.config import load_config
from x_as_supervision_tpu_torch.models.discriminator import GCNDiscriminator
from x_as_supervision_tpu_torch.models.resnet import BatchNorm2d
from x_as_supervision_tpu_torch.train.factory import (
    build_gan_spec,
    flagship_config,
)
from x_as_supervision_tpu_torch.train.state import TrainState, train_step
from x_as_supervision_tpu_torch.train.trainer import to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2
STEPS = 3
STEPS_PER_EPOCH = 10
LR = 1e-4


def percam(cfg: dict) -> dict:
    """per_camera_bn, use_aug and res_gcn with use_bn on a config."""
    mp = cfg["model_params"]
    mp["per_camera_bn"] = True
    mp["smpl_disc_params"].update(name="res_gcn", use_bn=True, use_aug=True)
    return cfg


@pytest.fixture(scope="module")
def trajectories():
    cfg = percam(_flagship_config(tiny=True))
    ds = SyntheticPoseDataset(num_samples=BATCH * STEPS, cam_id_list=(0, 1),
                              patch_size=64)
    batches = [ds.device_batch(i * BATCH, BATCH) for i in range(STEPS)]
    spec = jax_spec(cfg)
    opt_det, opt_disc = make_optimizers(cfg["train_params"], STEPS_PER_EPOCH)
    js = init_train_state(spec, jax.random.PRNGKey(0), batches[0], opt_det,
                          opt_disc)
    step = make_train_step(spec, opt_det, opt_disc)
    pspec = build_gan_spec(percam(flagship_config(tiny=True)), torch.float32)
    assert isinstance(pspec.discriminator, GCNDiscriminator)
    assert len(pspec.discriminator.bns) == 4 and pspec.use_aug
    pspec.discriminator.p_dropout = 0.0
    state = TrainState(pspec, cfg["train_params"], STEPS_PER_EPOCH)
    nh = cfg["model_params"]["detector_params"]["num_hypo"]

    traj = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        for i, batch in enumerate(batches):
            before = jax_state_in_port_names(js)
            carry_train_state(pspec, state, js)
            key = jax.random.PRNGKey(i)
            js, jmetrics, _ = step(js, batch, key, do_disc=True,
                                   do_gen=True, with_outputs=False)
            metrics = train_step(state, to_device(batch, "cpu"),
                                 rot_draws=jax_rot_draws(key, 2, BATCH, nh))
            got = {}
            for prefix in ("detector", "physique", "discriminator"):
                got.update({f"{prefix}.{k}": v.detach().clone() for k, v in
                            getattr(pspec, prefix).state_dict().items()
                            if "num_batches" not in k})
            traj.append(dict(
                before=before,
                want_metrics={k: float(v) for k, v in jmetrics.items()},
                metrics={k: float(v) for k, v in metrics.items()},
                want=jax_state_in_port_names(js), got=got,
                want_pending=weights.discriminator_state_dict(
                    to_numpy_tree(js.pending_disc_grads)),
                pending=dict(zip(state.disc_names,
                                 state.pending_disc_grads))))
    return traj, pspec


@pytest.mark.parametrize("i", range(STEPS))
def test_percam_aug_res_gcn_losses_match_jax(trajectories, i):
    step = trajectories[0][i]
    want, got = step["want_metrics"], step["metrics"]
    assert sorted(got) == sorted(want)
    for k in want:
        # fp32 from the same state, summed in other orders (the bound of
        # test_torch_train.py)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_percam_aug_res_gcn_parameters_and_stats_match_jax(trajectories, i):
    """Every parameter within Adam's step bounds, and the running
    statistics after two sequential (per-camera) updates per BatchNorm."""
    step, pspec = trajectories[0][i], trajectories[1]
    assert_step_matches(step["want"], step["got"], step["before"], pspec, LR)


@pytest.mark.parametrize("i", range(STEPS))
def test_percam_aug_res_gcn_pending_grads_match_jax(trajectories, i):
    step = trajectories[0][i]
    want, got = step["want_pending"], step["pending"]
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    assert scale > 0
    for k in want:
        # fp32 gradients of both smpl_gen branches through the GCN
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_percam_json_is_the_yaml_config():
    yaml_cfg = load_config(os.path.join(REPO, "config",
                                        "Campaign_SurS2_percam.yaml"))
    json_cfg = load_config(os.path.join(
        REPO, "x_as_supervision_tpu_torch", "configs",
        "Campaign_SurS2_percam.json"))
    assert json_cfg == yaml_cfg
    mp = json_cfg["model_params"]
    assert mp["per_camera_bn"] and mp["cam_id_list"] == [0, 1, 2, 3]
    spec = build_gan_spec(dict(json_cfg, model_params=dict(
        mp, detector_params=dict(mp["detector_params"], num_layers=18))))
    assert {m.groups for m in spec.detector.modules()
            if isinstance(m, BatchNorm2d)} == {4}


def test_percam_train_then_eval_cli_on_cpu(tmp_path, capsys):
    """per_camera_bn, use_aug and res_gcn through the train CLI (4 steps of
    2 cameras x 16 at 64^2) to 00000_ckpt, then the eval CLI in best mode:
    finite losses and a finite eval_result.txt."""
    from x_as_supervision_tpu_torch.eval.__main__ import main as eval_main
    from x_as_supervision_tpu_torch.train.__main__ import main as train_main

    cfg = percam(flagship_config(tiny=True))
    cfg["train_params"].update(batch_size=16, num_epochs=1,
                               checkpoint_freq=1)
    path = tmp_path / "percam.json"
    path.write_text(json.dumps(cfg))
    log = tmp_path / "log"
    saved = torch.get_num_threads()
    torch.set_num_threads(2)  # beside the other test workers
    try:
        trainer = train_main(["--config", str(path), "--synthetic", "--seed",
                              "0", "--device", "cpu", "--fp32", "--log_dir",
                              str(log)])
        assert trainer.state.step == 4
        assert all(np.isfinite(list(h.values())).all()
                   for h in trainer.history)
        (run,) = os.listdir(log)
        ckpt = log / run / "00000_ckpt"
        assert ckpt.is_dir()
        ev = eval_main(["--config", str(path), "--checkpoint", str(ckpt),
                        "--synthetic", "--multi_hypo", "best", "--device",
                        "cpu"])
    finally:
        torch.set_num_threads(saved)
    assert "Ambiguity Ratio:" in capsys.readouterr().out
    lines = open(ev.result_path).read().splitlines()
    values = [float(ln.split(":")[1].rstrip(" %")) for ln in lines
              if ":" in ln]
    assert len(values) == 14 and np.isfinite(values).all()


def test_unfused_step_is_a_disc_step_then_a_gen_step():
    """model_params.fuse_gan_step false: one iteration is the
    discriminator-only step, then the generator-only step (each held to the
    JAX package's in test_torch_train_variants.py), as the JAX step runs
    it."""
    from x_as_supervision_tpu_torch.data.synthetic import (
        SyntheticPoseDataset as PortDataset,
    )

    cfg = flagship_config(tiny=True)
    cfg["model_params"]["fuse_gan_step"] = False
    batch = to_device(PortDataset(num_samples=BATCH, cam_id_list=(0, 1),
                                  patch_size=64).batch(0, BATCH), "cpu")
    states = []
    for _ in range(2):
        spec = build_gan_spec(cfg, torch.float32)
        assert not spec.fuse_gan_step
        for i, m in enumerate((spec.detector, spec.physique,
                               spec.discriminator)):
            weights.init_weights(m, i)
        spec.discriminator.header.p_dropout = 0.0
        states.append(TrainState(spec, cfg["train_params"], STEPS_PER_EPOCH))
    got = train_step(states[0], batch)
    want = train_step(states[1], batch, do_gen=False)
    want.update(train_step(states[1], batch, do_disc=False))
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    for prefix in ("detector", "physique", "discriminator"):
        a = getattr(states[0].spec, prefix).state_dict()
        b = getattr(states[1].spec, prefix).state_dict()
        for k in a:
            if "num_batches" not in k:
                torch.testing.assert_close(a[k], b[k], rtol=0, atol=0,
                                           msg=f"{prefix}.{k}")
