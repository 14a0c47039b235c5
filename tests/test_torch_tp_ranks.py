"""The port's tensor parallelism (x_as_supervision_tpu_torch/parallel/tp.py
and the split layers of models/) on gloo CPU ranks laid out as the
(data, model) grid (tests/torch_tp.py's jobs, through tests/torch_dp.py's
spawn), held to the port's own one-process answer:

  * two model ranks (data 1): the model-group collectives and their
    backward; the link's Bottleneck (planes 256, train mode, batch 2 at
    4^2; pooled, per camera, and by the gathered-weight route), the
    physique net and two discriminators (dropout on), each against the
    whole module: output within 1e-5, every gradient within 1e-5 of its
    largest entry;
  * four ranks at (data 2, model 2), tiny flagship config, fp32, 2 fused
    steps of global batch 4, per camera (with use_aug and the header's
    dropout) and pooled (res_gcn with StatelessBN and dropout 0.5, the
    physique loss weighted by the geodesic maps; the configs of
    test_torch_parallel_step.py): the losses within 1e-4 relative, the
    gathered state by assert_step_matches, the carried gradient as
    test_torch_train.py holds it; each rank's replicated gradients and
    statistics bitwise equal to model rank 0's before the step's broadcast
    (tp.replica_drift), replicated tensors bitwise equal on all four ranks
    after it, split ones bitwise equal across the data ranks; a model axis
    that does not divide the world raises;
  * two model ranks' checkpoint (the same spawn as the modules): the train
    CLI with model_parallelism 2, the saved file read in one process
    bitwise equal to the ranks' gathered state, and a run resumed from it
    equal bitwise to a straight one.

The same four-rank step against JAX's jitted step is in
test_torch_parallel_jax.py, beside the data-parallel one it shares JAX's
trajectory with.

As in test_torch_parallel_step.py each residual branch's last BatchNorm
scale starts at 0.1 in the step test.
"""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest

from torch_dp import spawn
from x_as_supervision_tpu_torch.checks import flat
from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu_torch.train import checkpoint as ckpt
from x_as_supervision_tpu_torch.train.factory import flagship_config
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

GLOBAL_BATCH = 4
STEPS = 2
SEED = 5
LR = 1e-4
# intra-op threads a rank: the tiny config's steps take as long on one as
# on two, for two thirds of the CPU time
THREADS = 1
KINDS = ["bottleneck_link", "bottleneck_link_g2",
         "bottleneck_gathered_weight", "physique", "sage_disc",
         "res_gcn_disc"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two model ranks (data 1): the collectives and the split
    modules, then the train CLI, the checkpoint and the resume; with the
    checkpoint as one process reads it."""
    workdir = str(tmp_path_factory.mktemp("tp_two_ranks"))
    cfg = flagship_config(tiny=True)
    cfg["train_params"]["model_parallelism"] = 2
    with open(os.path.join(workdir, "cfg.json"), "w") as f:
        json.dump(cfg, f)
    try:
        ranks = spawn("tp_two_ranks", 2, workdir, timeout=400,
                      threads=THREADS)
        raw = ckpt.load_raw(ranks[0]["saved_path"])
        loaded = {k: v for k, v in flat(raw).items() if hasattr(v, "numpy")}
        return ranks, loaded
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


@pytest.fixture(scope="module")
def modules(two_ranks):
    return two_ranks[0]


@pytest.fixture(scope="module")
def checkpoint(two_ranks):
    return two_ranks


def _configs() -> dict:
    percam = flagship_config(tiny=True)
    percam["model_params"]["per_camera_bn"] = True
    percam["model_params"]["smpl_disc_params"]["use_aug"] = True
    gcn = flagship_config(tiny=True)
    gcn["model_params"]["smpl_disc_params"].update(name="res_gcn",
                                                   use_bn=True)
    gcn["model_params"]["loss_config"]["physique_recons_loss"][
        "use_dis_map"] = True
    for cfg in (percam, gcn):
        cfg["train_params"]["model_parallelism"] = 2
    return {"percam_aug": percam, "res_gcn": gcn}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("tp_steps"))
    ds = SyntheticPoseDataset(num_samples=GLOBAL_BATCH * STEPS,
                              cam_id_list=(0, 1), patch_size=64)
    for i in range(STEPS):
        np.savez(os.path.join(workdir, f"batch_{i}.npz"),
                 **ds.device_batch(i * GLOBAL_BATCH, GLOBAL_BATCH))
    with open(os.path.join(workdir, "plan.json"), "w") as f:
        json.dump({"configs": _configs(), "steps": STEPS, "seed": SEED,
                   "steps_per_epoch": 10, "lr": LR}, f)
    try:
        return spawn("tp_steps", 4, workdir, timeout=400, threads=THREADS)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def test_model_group_collectives(modules):
    for r, res in enumerate(modules):
        assert res["model"] == (2, r) and res["data"] == (1, 0)
        # gather: both channels in rank order; backward: rank r's weight
        assert res["gather"].tolist() == [[1.0, 2.0]]
        assert res["gather_grad"].tolist() == [[10.0 * 10 ** r]]
        # copy_to_model: the two ranks' gradients 1 and 2, summed
        assert res["copy_grad"].tolist() == [3.0, 3.0]
        # model_slice: rank r's half; the halves' gradients put together
        assert res["slice"].tolist() == [1.0 + 2 * r, 2.0 + 2 * r]
        assert res["slice_grad"].tolist() == [1.0, 1.0, 10.0, 10.0]
        assert res["psum_model"].tolist() == [3.0]
        assert res["broadcast"].tolist() == [0.0]


@pytest.mark.parametrize("kind", KINDS)
def test_split_module_matches_one_process(modules, kind):
    """Each module on two model ranks against itself whole in one process
    (tests/torch_tp.py:_module_cases): output, input gradient, every
    parameter's gradient (the split ones gathered) and every running
    statistic. The Bottleneck is the link kernel's module: a missing sum
    of the link's partial input gradients passes the forward and fails
    x_grad and bn1's gradients."""
    for res in modules:
        case = res["modules"][kind]
        assert case["split"], "nothing was split"
        errs = case["errs"]
        assert "y" in errs and "x_grad" in errs
        for name, e in errs.items():
            # fp32 sums of the same values in other orders; the physique's
            # six synced BatchNorms against native ones: up to 7.7e-6
            assert e <= 1e-5, (name, e)
        calls = case["collectives"]
        assert calls["all_gather/model"]["calls"] > 0
        assert calls["all_reduce/model"]["calls"] > 0
    a, b = (res["modules"][kind] for res in modules)
    assert a["errs"] == b["errs"]


def test_link_runs_on_the_cout_shard(modules):
    """The shard route gathers the link's input, scale and shift (3
    all-gathers) and no weight; the gathered-weight route one more, of
    conv2's weight."""
    cases = modules[0]["modules"]
    shard = cases["bottleneck_link"]["collectives"]["all_gather/model"]
    gathered = cases["bottleneck_gathered_weight"]["collectives"][
        "all_gather/model"]
    assert gathered["calls"] == shard["calls"] + 1
    assert gathered["bytes"] - shard["bytes"] == 256 * 256 * 9 * 4


def test_uneven_grid_raises(steps):
    for r, res in enumerate(steps):
        assert res["uneven_grid_raises"]
        assert res["grid"] == dict(data=(2, r // 2), model=(2, r % 2))


CASES = [(name, i) for name in _configs() for i in range(STEPS)]


@pytest.mark.parametrize("name,i", CASES)
def test_tp_losses_match_one_process(steps, name, i):
    want = steps[0][name][i]["want_metrics"]
    for rank in steps:
        step = rank[name][i]
        assert sorted(step["metrics"]) == sorted(want)
        for k, w in want.items():
            # test_torch_parallel_step.py's bound
            np.testing.assert_allclose(step["metrics"][k], w, rtol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("name,i", CASES)
def test_tp_state_matches_one_process(steps, name, i):
    step = steps[0][name][i]
    assert step["state_verdict"] is None, step["state_verdict"]
    want = step["want_pending"]
    scale = max(float(v.abs().max()) for v in want.values())
    assert scale > 0
    for k, w in want.items():
        np.testing.assert_allclose(step["pending"][k].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("name,i", CASES)
def test_tp_ranks_hold_their_state(steps, name, i):
    """Each rank's replicated gradients and running statistics bitwise
    equal to model rank 0's before the step's broadcast (tp.replica_drift:
    gloo's CPU ranks sum alike, so nothing is left for the broadcast to
    mend); after it, replicated tensors (parameters, statistics, Adam
    moments, the carried gradient) bitwise equal on all four ranks and
    split ones bitwise equal across the data ranks."""
    ranks = [rank[name][i] for rank in steps]
    assert [r["replica_drift"] for r in ranks] == [0.0] * 4
    whole, split = set(ranks[0]["whole_keys"]), set(ranks[0]["split_keys"])
    assert len(whole) > 100 and len(split) > 100
    for r in ranks:
        assert set(r["whole_keys"]) == whole and set(r["split_keys"]) == split
    digests = [r["digests"] for r in ranks]
    for k in whole:
        if k in digests[0]:
            assert len({d[k] for d in digests}) == 1, k
    for k in split:
        assert digests[0][k] == digests[2][k], k
        assert digests[1][k] == digests[3][k], k


def test_train_cli_with_model_parallelism(checkpoint):
    ranks, _ = checkpoint
    for r, res in enumerate(ranks):
        assert res["cli_grid"] == (1, 2)
        # one data index: both model ranks read the whole batch of 4
        assert res["cli_shard"] == (1, 0, 4)
        assert res["cli_split"] > 100
        assert len(res["cli_history"]) == 1
        assert all(np.isfinite(v) for v in res["cli_history"][0].values())
    assert ranks[0]["cli_history"] == ranks[1]["cli_history"]


def test_checkpoint_is_the_whole_state(checkpoint):
    """The file rank 0 wrote after the last epoch, read in one process,
    equals the ranks' gathered state bitwise, tensor by tensor (Adam
    moments included)."""
    ranks, loaded = checkpoint
    for res in ranks:
        assert res["straight"] == ranks[0]["straight"]
    got = {k: hashlib.sha256(v.contiguous().numpy().tobytes()).hexdigest()
           for k, v in loaded.items()}
    assert len(got) > 100 and got == ranks[0]["straight"]


def test_resume_into_split_state_equals_straight_run(checkpoint):
    ranks, _ = checkpoint
    for res in ranks:
        assert res["resumed_from"] == 1
        assert len(res["straight"]) > 100
        assert res["resumed"] == res["straight"]
