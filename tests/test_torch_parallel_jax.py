"""The port's data-parallel GAN step, two CPU ranks over gloo, against the
JAX package's jitted step on a 2-device ``data`` mesh with the batch
sharded (as tests/test_train_step.py runs it), on the tiny flagship config
in fp32 over a 3-step fused trajectory, global batch 4; and the port's
tensor-parallel step, four ranks at (data 2, model 2)
(tests/torch_tp.py:job_tp_jax_steps), against the same JAX steps for the
first 2 of them, by the same bounds.

This process runs the JAX step and writes each step's JAX state before and
after it and its batch as npz; the two ranks (tests/torch_dp.py, JAX-free)
carry each step's JAX state in (checks.load_train_state, the JAX-free half
of tests/torch_parity.py:carry_train_state) and take the port's step on
their halves of the global batch; the four tensor-parallel ranks cut it to
their channel shards first, and rank 0 gathers the state after the step. Every loss, parameter, running statistic
and pending_disc_grads is held to JAX with tests/test_torch_train.py's
bounds (assert_step_matches, applied in rank 0 to its whole state), and
the two ranks' states, Adam moments included, to each other bitwise;
each tensor-parallel rank's replicated gradients and statistics to model
rank 0's bitwise before the step's broadcast (tp.replica_drift).
The discriminator header's dropout is off on both sides, as in
test_torch_train.py (the frameworks draw different bits).

The JAX state starts conditioned as chip_smoke.py's train-parity phase
conditions its weights: each residual branch's last BatchNorm scale 0.1.
At batch 4 a random-weight train-mode ResNet-18 carries fp32 rounding into
more Adam steps than those bounds allow: the one-process port against the
one-device JAX step at batch 4, unconditioned, misses them at steps 1 and
2 (a weight 2.1 steps apart), as the two ranks miss them at step 0 (more
than 0.1 % of the weights over a tenth of a step); conditioned, both pass.
"""

import os
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _flagship_config
from torch_dp import spawn
from torch_parity import (
    jax_state_in_port_names,
    to_numpy_tree,
    train_state_arrays,
)
from x_as_supervision_tpu.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu.parallel import mesh as M
from x_as_supervision_tpu.train.factory import build_gan_spec as jax_spec
from x_as_supervision_tpu.train.state import (
    init_train_state,
    make_optimizers,
    make_train_step,
)
from x_as_supervision_tpu_torch import weights

GLOBAL_BATCH = 4
STEPS = 3
STEPS_PER_EPOCH = 10
LR = 1e-4
TP_STEPS = 2


def _conditioned(det_params):
    """Each BasicBlock's last BatchNorm scale (its residual branch's) 0.1."""
    def scale(path, v):
        name = jax.tree_util.keystr(path)
        last_bn = "BasicBlock" in name and "_BN_1" in name
        return jnp.full_like(v, 0.1) if last_bn and "scale" in name else v

    return jax.tree_util.tree_map_with_path(scale, det_params)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's trajectory: each step's state before and after it and its
    batch as npz in a directory (removed after the module's tests), and
    each step's metrics and carried gradient."""
    workdir = str(tmp_path_factory.mktemp("dp_jax"))
    cfg = _flagship_config(tiny=True)
    ds = SyntheticPoseDataset(num_samples=GLOBAL_BATCH * STEPS,
                              cam_id_list=(0, 1), patch_size=64)
    batches = [ds.device_batch(i * GLOBAL_BATCH, GLOBAL_BATCH)
               for i in range(STEPS)]
    spec = jax_spec(cfg)
    opt_det, opt_disc = make_optimizers(cfg["train_params"], STEPS_PER_EPOCH)
    mesh = M.make_mesh(devices=jax.devices()[:2])
    js = init_train_state(spec, jax.random.PRNGKey(0), batches[0], opt_det,
                          opt_disc)
    js = M.replicate_state(
        js.replace(det_params=_conditioned(js.det_params)), mesh)
    step = make_train_step(spec, opt_det, opt_disc)
    np.savez(os.path.join(workdir, "meta.npz"), steps=STEPS,
             tp_steps=TP_STEPS, steps_per_epoch=STEPS_PER_EPOCH, lr=LR)
    want = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        for i, batch in enumerate(batches):
            host = jax.device_get(js)
            np.savez(os.path.join(workdir, f"before_{i}.npz"),
                     **train_state_arrays(host))
            np.savez(os.path.join(workdir, f"batch_{i}.npz"), **batch)
            js, jmetrics, _ = step(js, M.shard_batch(batch, mesh),
                                   jax.random.PRNGKey(i), do_disc=True,
                                   do_gen=True, with_outputs=False)
            host = jax.device_get(js)
            np.savez(os.path.join(workdir, f"after_{i}.npz"),
                     **{k: np.asarray(v) for k, v in
                        jax_state_in_port_names(host).items()})
            want.append(dict(
                metrics={k: float(v) for k, v in jmetrics.items()},
                pending=weights.discriminator_state_dict(
                    to_numpy_tree(host.pending_disc_grads))))
    try:
        yield workdir, want
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


@pytest.fixture(scope="module")
def trajectories(jax_run):
    workdir, want = jax_run
    return want, spawn("jax_steps", 2, workdir, timeout=300)


@pytest.fixture(scope="module")
def tp_trajectories(jax_run):
    # one intra-op thread a rank (tests/test_torch_tp_ranks.py's)
    workdir, want = jax_run
    return want, spawn("tp_jax_steps", 4, workdir, timeout=300, threads=1)


@pytest.mark.parametrize("i", range(STEPS))
def test_dp_losses_match_jax(trajectories, i):
    want, got = trajectories
    for rank in got:
        metrics = rank["steps"][i]["metrics"]
        assert sorted(metrics) == sorted(want[i]["metrics"])
        for k, w in want[i]["metrics"].items():
            # test_torch_train.py's bound: fp32 from the same state, summed
            # in other orders (here also over two ranks)
            np.testing.assert_allclose(metrics[k], w, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_dp_parameters_and_stats_match_jax(trajectories, i):
    verdict = trajectories[1][0]["steps"][i]["state_verdict"]
    assert verdict is None, verdict


@pytest.mark.parametrize("i", range(STEPS))
def test_dp_pending_disc_grads_match_jax(trajectories, i):
    want, got = trajectories
    pending = got[0]["steps"][i]["pending"]
    assert sorted(pending) == sorted(want[i]["pending"])
    scale = max(float(np.abs(np.asarray(v)).max())
                for v in want[i]["pending"].values())
    assert scale > 0
    for k, w in want[i]["pending"].items():
        # test_torch_train.py's bound for the carried gradient
        np.testing.assert_allclose(pending[k].numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_dp_ranks_hold_the_same_state(trajectories, i):
    """Parameters, statistics, Adam moments and the carried gradient are
    bitwise equal on the two ranks after every step (a digest of each)."""
    a, b = (rank["steps"][i]["digests"] for rank in trajectories[1])
    assert len(a) > 100 and a == b


@pytest.mark.parametrize("i", range(TP_STEPS))
def test_tp_losses_match_jax(tp_trajectories, i):
    want, got = tp_trajectories
    for rank in got:
        metrics = rank["steps"][i]["metrics"]
        assert sorted(metrics) == sorted(want[i]["metrics"])
        for k, w in want[i]["metrics"].items():
            # the data-parallel ranks' bound
            np.testing.assert_allclose(metrics[k], w, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("i", range(TP_STEPS))
def test_tp_parameters_and_stats_match_jax(tp_trajectories, i):
    """The four ranks' state gathered, against JAX's after the step."""
    step = tp_trajectories[1][0]["steps"][i]
    assert step["split"] > 100
    assert step["state_verdict"] is None, step["state_verdict"]


@pytest.mark.parametrize("i", range(TP_STEPS))
def test_tp_pending_disc_grads_match_jax(tp_trajectories, i):
    want, got = tp_trajectories
    pending = got[0]["steps"][i]["pending"]
    assert sorted(pending) == sorted(want[i]["pending"])
    scale = max(float(np.abs(np.asarray(v)).max())
                for v in want[i]["pending"].values())
    assert scale > 0
    for k, w in want[i]["pending"].items():
        np.testing.assert_allclose(pending[k].numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("i", range(TP_STEPS))
def test_tp_replicas_agree_before_the_broadcast(tp_trajectories, i):
    """Every rank's replicated gradients and running statistics bitwise
    equal to its model rank 0's before the step's broadcast."""
    assert [r["steps"][i]["replica_drift"]
            for r in tp_trajectories[1]] == [0.0] * 4
