"""The port's fused GAN train step (x_as_supervision_tpu_torch/train) against
the JAX package's jitted step (train/state.py) on the tiny flagship config,
fp32, over a 3-step fused trajectory on synthetic batches.

Before each step the JAX train state (parameters, BatchNorm statistics,
both Adam states, the carried discriminator gradient) is carried into the
port through weights.py, so each step is compared from the same state: a
free-running Adam trajectory would part at the rate Adam's normalization
amplifies rounding, and hide what each step does. After each step: every
loss, loss_disc, every parameter, the BatchNorm running statistics (biased
variance) and pending_disc_grads. The discriminator header's dropout is off
on both sides (the frameworks draw different random bits; flax's
nn.Dropout is patched to the identity inside this test only). The ReLU
inputs within float32 rounding of 0 are decided on both sides as the
port's float64 step decides them (tests/torch_parity.py:HeldSteps).
"""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _flagship_config
from x_as_supervision_tpu.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu.train.factory import build_gan_spec as jax_spec
from x_as_supervision_tpu.train.state import (
    make_optimizers,
    make_train_step,
)
from torch_parity import (
    HeldSteps,
    assert_pending_matches,
    assert_step_matches,
)
from x_as_supervision_tpu_torch.train.factory import (
    build_gan_spec,
    flagship_config,
)
from x_as_supervision_tpu_torch.train.state import multistep_schedule
from torch_parity import jax_init_state
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2
STEPS = 3
STEPS_PER_EPOCH = 10
LR = 1e-4


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    cfg = _flagship_config(tiny=True)
    ds = SyntheticPoseDataset(num_samples=BATCH * STEPS, cam_id_list=(0, 1),
                              patch_size=64)
    batches = [ds.device_batch(i * BATCH, BATCH) for i in range(STEPS)]
    spec = jax_spec(cfg)
    opt_det, opt_disc = make_optimizers(cfg["train_params"], STEPS_PER_EPOCH)
    js = jax_init_state(tmp_path_factory, cfg, batches[0], opt_det, opt_disc,
                        STEPS_PER_EPOCH)

    def make_spec(dtype):
        pspec = build_gan_spec(flagship_config(tiny=True), dtype)
        pspec.discriminator.header.p_dropout = 0.0
        return pspec

    held = HeldSteps(make_spec, cfg["train_params"], STEPS_PER_EPOCH)
    traj = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        for i, batch in enumerate(batches):
            js, record = held.step(
                js, batch, lambda: make_train_step(spec, opt_det, opt_disc),
                jax.random.PRNGKey(i))
            traj.append(record)
    return traj, held.pspec


@pytest.mark.parametrize("i", range(STEPS))
def test_losses_match_jax(trajectories, i):
    step = trajectories[0][i]
    want, got = step["want_metrics"], step["metrics"]
    assert sorted(got) == sorted(want)
    for k in want:
        # fp32 through ResNet-18, the decode, the renderer and the physique
        # net from the same state, summed in other orders; the physique
        # net's BatchNorm sees a nearly binary mask, where flax's one-pass
        # variance and the port's two-pass one part most (measured 2.2e-5)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_parameters_and_stats_match_jax(trajectories, i):
    step, pspec = trajectories[0][i], trajectories[1]
    assert_step_matches(step["want"], step["got"], step["before"], pspec, LR)


@pytest.mark.parametrize("i", range(STEPS))
def test_pending_disc_grads_match_jax(trajectories, i):
    assert_pending_matches(trajectories[0][i])


def test_flagship_config_is_the_graft_entry_config():
    for tiny in (False, True):
        assert flagship_config(tiny) == _flagship_config(tiny)


def test_multistep_schedule_matches_optax():
    from x_as_supervision_tpu.train.state import (
        multistep_schedule as jax_schedule,
    )

    for every in (1, 2, 3):
        want = jax_schedule(1e-3, [2, 5], 7, every=every)
        got = multistep_schedule(1e-3, [2, 5], 7, every=every)
        for count in range(40):
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-6)


def test_train_cli_runs_on_cpu(tmp_path):
    import yaml

    cfg = flagship_config(tiny=True)
    cfg["train_params"]["batch_size"] = 2
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    res = subprocess.run(
        [sys.executable, "-m", "x_as_supervision_tpu_torch.train",
         "--config", str(tmp_path / "cfg.yaml"), "--synthetic", "--seed", "0",
         "--steps", "2", "--device", "cpu", "--fp32",
         "--log_dir", str(tmp_path / "log")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("step ")]
    assert len(lines) == 2
    for ln in lines:
        values = [float(kv.split("=")[1]) for kv in ln.split() if "=" in kv]
        assert len(values) == 7 and np.isfinite(values).all()


def test_synthetic_dataset_is_the_jax_packages():
    from x_as_supervision_tpu_torch.data.synthetic import (
        SyntheticPoseDataset as PortDataset,
    )

    want = SyntheticPoseDataset(num_samples=5, cam_id_list=(0, 2),
                                patch_size=32, seed=3).batch(1, 3)
    got = PortDataset(num_samples=5, cam_id_list=(0, 2), patch_size=32,
                      seed=3).batch(1, 3)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "act":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
