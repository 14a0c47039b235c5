"""The port's sharded eval (train/evaluator.py's shard_across_processes and
record(..., reduce_hosts=True); the eval CLI's --coordinator flags and
--reduce_hosts) in two CPU ranks over gloo, against the same evaluator in
one process without a process group, and against the JAX package's
evaluator in one process on the same weights.

The evaluator runs the anchored fixture of tests/test_torch_eval.py
(checks.AnchoredDataset: detections near the GT, so the DLT is well posed)
with the detector of its conditioned_pair, fp32, best mode, with equal
shards (2 batches) and unequal ones (3 batches: process 0 walks batches 0
and 2, process 1 batch 1; the CLI's 5), in the per-action H36M report and
the MPI one. Both processes hold the one-process result: eval_result.txt
with the same lines, each number within 1e-6 relative (sums of the same
batch values in another order: the MPI report adds float32 batch means,
as the JAX package's does; measured 9.9e-8), and the same ambiguity
ratio. The H36M reports
are also held to the JAX evaluator's with test_torch_eval.py's 1e-4
relative. Then the eval CLI (bf16) on a checkpoint of the same detector,
two ranks with --reduce_hosts against one process: the same
eval_result.txt to 1e-6, the TensorBoard panels on process 0 only.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_eval import BATCH, SIDE, _config, _JaxAnchored
from test_train_step import TINY_CONFIG
from torch_dp import spawn
from torch_parity import conditioned_pair
from x_as_supervision_tpu.data.synthetic import (
    SyntheticPoseDataset as JaxDataset,
)
from x_as_supervision_tpu.train.evaluator import Evaluator as JaxEvaluator
from x_as_supervision_tpu_torch.checks import AnchoredDataset, result_lines

# case: (samples, dataset)
CASES = {"hm36_even": (2 * BATCH, "hm36"), "hm36_uneven": (3 * BATCH, "hm36"),
         "mpi_uneven": (3 * BATCH, "mpi_inf_3dhp")}
CLI_BATCH = 12  # 5 batches of the CLI's 64 synthetic samples


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("dp_eval"))
    det_params = TINY_CONFIG["model_params"]["detector_params"]
    jdet, jvars, tdet, _ = conditioned_pair(det_params, SIDE, BATCH, seed=0)
    torch.save(tdet.state_dict(), os.path.join(workdir, "detector.pt"))
    for world in (0, 2):
        path = os.path.join(workdir, f"ckpt_{world}", "00000_ckpt")
        os.makedirs(path)
        torch.save({"detector": tdet.state_dict()},
                   os.path.join(path, "state.pt"))
    cli = _config("hm36")
    cli["train_params"]["patch_width"] = SIDE
    with open(os.path.join(workdir, "cli.json"), "w") as f:
        json.dump(cli, f)
    with open(os.path.join(workdir, "plan.json"), "w") as f:
        json.dump({"config": _config("hm36"), "side": SIDE,
                   "cli_batch": CLI_BATCH,
                   "cases": {k: n for k, (n, _) in CASES.items()},
                   "dataset": {k: d for k, (_, d) in CASES.items()}}, f)
    try:
        one = spawn("eval", 0, workdir, timeout=300)[0]
        ranks = spawn("eval", 2, workdir, timeout=300)
        for res in [one] + ranks:
            for case in res.values():
                case["lines"] = result_lines(case["path"])
        return one, ranks, _jax_reports(jdet, jvars, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _jax_reports(jdet, jvars, workdir) -> dict:
    """The JAX evaluator's eval_result.txt lines for the H36M cases."""
    reports, jax_step = {}, None
    for case, (samples, name) in CASES.items():
        if name != "hm36":
            continue
        ds = AnchoredDataset(JaxDataset(num_samples=samples,
                                        cam_id_list=(0, 1), patch_size=SIDE),
                             (0, 1), float(SIDE))
        jev = JaxEvaluator(_config(name), _JaxAnchored(jdet), jvars, ds,
                           os.path.join(workdir, f"jax_{case}"),
                           img_size=float(SIDE))
        # one jitted step for both (it compiles once)
        jax_step = jax_step or jev._device_step
        jev._device_step = jax_step
        reports[case] = result_lines(jev.record(*jev.eval(mode="best")))
    return reports


def _assert_same_report(got, want, rtol):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert np.isfinite(g), key
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=key)


@pytest.mark.parametrize("case", list(CASES) + ["cli"])
def test_reduced_eval_equals_one_process(runs, case):
    one, ranks, _ = runs
    assert one[case]["my_batches"] == list(range(len(
        one[case]["my_batches"])))
    # process p walks batches p, p + 2, ...
    walked = sorted(b for r in ranks for b in r[case]["my_batches"])
    assert walked == one[case]["my_batches"]
    assert ranks[0][case]["my_batches"] == walked[0::2]
    _assert_same_report(ranks[0][case]["lines"], one[case]["lines"], 1e-6)
    for r in ranks:
        np.testing.assert_allclose(r[case]["ratio"], one[case]["ratio"],
                                   rtol=1e-12)
    # process 0 writes; both hold the reduced ratio
    assert ranks[0][case]["path"] == ranks[1][case]["path"]


def test_unequal_shards_are_unequal(runs):
    _, ranks, _ = runs
    assert ranks[0]["hm36_uneven"]["my_batches"] == [0, 2]
    assert ranks[1]["hm36_uneven"]["my_batches"] == [1]
    assert ranks[1]["cli"]["my_batches"] == [1, 3]


def test_cli_panels_on_process_0_only(runs):
    one, ranks, _ = runs
    assert one["cli"]["tb"] and ranks[0]["cli"]["tb"]
    assert not ranks[1]["cli"]["tb"]


@pytest.mark.parametrize("case", ["hm36_even", "hm36_uneven"])
def test_reduced_eval_equals_jax(runs, case):
    _, ranks, jax_reports = runs
    # test_torch_eval.py's bound for the port's report against JAX's
    _assert_same_report(ranks[0][case]["lines"], jax_reports[case], 1e-4)
