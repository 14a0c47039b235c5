"""The port's data-parallel GAN step, two CPU ranks over gloo, against the
port's own one-process step at the global batch, on the tiny flagship
config in fp32, 3 fused steps of global batch 4, with every path that is
not linear in the batch or draws at its shape:

  * ``percam_aug``: per_camera_bn (each camera's statistics over both
    ranks' slices of that camera), use_aug (the rotations' uniforms) and
    the decoupled discriminator's header dropout (p 0.2);
  * ``res_gcn``: the res_gcn discriminator with use_bn (StatelessBN over
    the global batch) and its dropout (p 0.5), pooled BatchNorm, and the
    physique loss weighted by the geodesic maps;

both with use_clip's active-pixel fraction, the symmetry loss and the
pseudo stream (minima over hypotheses of global means).

Each rank takes, at each step, the one-process step (in-process with no
process group seen, on the whole batch) and the data-parallel step from
the same state on its half of the batch, both with the step's generator
(tests/torch_dp.py:job_port_steps); the data-parallel state is held to the
one-process one with tests/test_torch_train.py's bounds
(assert_step_matches, in rank 0), the losses to 1e-4 relative, the
carried gradient as test_torch_train.py holds it, and the ranks' states
to each other bitwise. The port's draws are its own on both sides, so
dropout and the rotations are on: a rank that drew other bits would part
by O(1). As in test_torch_parallel_jax.py each residual branch's last
BatchNorm scale starts at 0.1.
"""

import json
import os
import shutil

import numpy as np
import pytest

from torch_dp import spawn
from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu_torch.train.factory import flagship_config
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

GLOBAL_BATCH = 4
STEPS = 3
STEPS_PER_EPOCH = 10
SEED = 5
LR = 1e-4


def _configs() -> dict:
    percam = flagship_config(tiny=True)
    percam["model_params"]["per_camera_bn"] = True
    percam["model_params"]["smpl_disc_params"]["use_aug"] = True
    gcn = flagship_config(tiny=True)
    gcn["model_params"]["smpl_disc_params"].update(name="res_gcn",
                                                   use_bn=True)
    gcn["model_params"]["loss_config"]["physique_recons_loss"][
        "use_dis_map"] = True
    return {"percam_aug": percam, "res_gcn": gcn}


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("dp_step"))
    ds = SyntheticPoseDataset(num_samples=GLOBAL_BATCH * STEPS,
                              cam_id_list=(0, 1), patch_size=64)
    for i in range(STEPS):
        np.savez(os.path.join(workdir, f"batch_{i}.npz"),
                 **ds.device_batch(i * GLOBAL_BATCH, GLOBAL_BATCH))
    with open(os.path.join(workdir, "plan.json"), "w") as f:
        json.dump({"configs": _configs(), "steps": STEPS, "seed": SEED,
                   "steps_per_epoch": STEPS_PER_EPOCH, "lr": LR}, f)
    try:
        return spawn("port_steps", 2, workdir, timeout=300)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


CASES = [(name, i) for name in _configs() for i in range(STEPS)]


@pytest.mark.parametrize("name,i", CASES)
def test_dp_losses_match_one_process(trajectories, name, i):
    want = trajectories[0][name][i]["want_metrics"]
    for rank in trajectories:
        step = rank[name][i]
        # every rank's one-process step is the same step
        assert step["want_metrics"] == want
        assert sorted(step["metrics"]) == sorted(want)
        for k, w in want.items():
            # tests/test_torch_train.py's bound: fp32 sums over the batch
            # in two halves, then over the ranks (measured: 1.6e-5 at most,
            # the geodesic-weighted physique loss, a mean of 32768 pixels)
            np.testing.assert_allclose(step["metrics"][k], w, rtol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("name,i", CASES)
def test_dp_state_matches_one_process(trajectories, name, i):
    step = trajectories[0][name][i]
    assert step["state_verdict"] is None, step["state_verdict"]
    want = step["want_pending"]
    scale = max(float(v.abs().max()) for v in want.values())
    assert scale > 0
    for k, w in want.items():
        # tests/test_torch_train.py's bound for the carried gradient
        np.testing.assert_allclose(step["pending"][k].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("name,i", CASES)
def test_dp_ranks_hold_the_same_state(trajectories, name, i):
    """Parameters, statistics, Adam moments and the carried gradient are
    bitwise equal on the two ranks after every step (a digest of each)."""
    a, b = (rank[name][i]["digests"] for rank in trajectories)
    assert len(a) > 100 and a == b
