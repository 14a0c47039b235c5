"""The port's data-parallel building blocks (x_as_supervision_tpu_torch/
parallel/ and the rank rules of train/), in two CPU ranks over gloo
(tests/torch_dp.py, one spawned pair for the module): the mesh helpers, the
collectives and their backward, the seed and run-directory broadcasts, the
train CLI's --coordinator flags, and the checkpoint's rank-0 save, barrier
and resume. Without a process group every helper is the one-process answer
and calls no collective (checked in this process).
"""

import json
import os
import shutil

import pytest
import torch

from torch_dp import spawn
from x_as_supervision_tpu_torch.parallel import collectives as C
from x_as_supervision_tpu_torch.parallel import mesh
from x_as_supervision_tpu_torch.train.factory import flagship_config


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("dp_basics"))
    cfg = flagship_config(tiny=True)
    with open(os.path.join(workdir, "cfg.json"), "w") as f:
        json.dump(cfg, f)
    try:
        return spawn("basics", 2, workdir, timeout=400)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def test_mesh_helpers(ranks):
    for r, res in enumerate(ranks):
        assert (res["count"], res["index"]) == (2, r)
        assert res["slice"] == (4, 4 * r)
        assert res["uneven_raises"]


@pytest.mark.parametrize("kind", ["bottleneck_g1", "bottleneck_g2", "bn_g2",
                                  "stateless_bn"])
def test_synced_module_matches_one_process(ranks, kind):
    """Each module with synced train-mode statistics, on a rank's rows of a
    camera-major batch, against the module on the whole batch in one
    process (tests/torch_dp.py:module_cases): output, input gradient, the
    parameter gradients summed over the ranks, the running statistics. The
    fused Bottleneck is the link kernel's module (its stats all-reduced
    between the kernel and bn2's fold), pooled and per camera."""
    for res in ranks:
        errs = res["modules"][kind]
        assert "y" in errs and "x_grad" in errs
        for name, e in errs.items():
            # fp32 sums over the batch in two halves, then over the ranks
            assert e <= 1e-5, (name, e)
    assert ranks[0]["modules"][kind]["y"] >= 0


def test_psum_and_pmean(ranks):
    # rank r holds w (r + 1): the sum is 3 w; the loss term of rank r is
    # 10^r y, so y's gradient is 1 + 10 on every rank and rank r's w gets
    # 11 (r + 1)
    for r, res in enumerate(ranks):
        assert res["psum"].tolist() == [3.0, 6.0]
        assert res["psum_grad"].tolist() == [11.0 * (r + 1)] * 2
        assert res["pmean"].tolist() == [0.5]


def test_ppermute_ring(ranks):
    # rank r receives rank r - 1's x; rank r's x gets the weight of the
    # rank that received it, ((r + 1) mod 2) + 1
    for r, res in enumerate(ranks):
        src = (r - 1) % 2
        assert res["ring"].tolist() == [src + 1.0, 10.0 * (src + 1)]
        dst = (r + 1) % 2
        assert res["ring_grad"].tolist() == [dst + 1.0] * 2


def test_all_gather_data(ranks):
    # every rank's rows in rank order; the gradient of rank r's row sums
    # over the ranks q of its weight 100^r (q + 1)
    for r, res in enumerate(ranks):
        assert res["gather"].tolist() == [[0.0, 0.5], [1.0, 1.5]]
        assert res["gather_stacked"].tolist() == [[0.0], [1.0]]
        assert res["gather_grad"].tolist() == [[3.0 * 100 ** r] * 2]


def test_cross_host_mean_and_sum(ranks):
    for res in ranks:
        assert res["mean"] == {"a": 0.5, "b": [1.0, 1.0], "c": (3.0, 4.5)}
        assert res["sum"] == {"a": 1.0, "b": [2.0, 2.0], "c": (6.0, 9.0)}


def test_psum_flat_and_counts(ranks):
    for res in ranks:
        (a, b), (c,) = res["flat"]
        assert a.tolist() == [1.0, 1.0] and b.tolist() == [2.0] * 3
        assert c.tolist() == [[4.0, 4.0], [4.0, 4.0]]
        counts = res["counts"]
        # psum forward + backward, pmean, all-gather's backward, two
        # cross-host sums (the mean is one), one flat bucket; all over the
        # data group, the world without tensor parallelism
        assert counts["all_reduce/data"]["calls"] == 7
        assert counts["all_gather/data"] == {"calls": 2,
                                             "bytes": 2 * 8 + 2 * 4}
        assert counts["ppermute/data"] == {"calls": 2, "bytes": 16}
    assert ranks[0]["counts"] == ranks[1]["counts"]


def test_seed_and_run_dir_broadcast_from_rank_0(ranks):
    """Rank 1's clock is set 12345 s ahead and its timestamps elsewhere:
    both ranks take rank 0's seed and run directory, and only rank 0 makes
    the directory."""
    assert ranks[0]["seed"] == ranks[1]["seed"]
    assert ranks[0]["run_dir"] == ranks[1]["run_dir"]
    assert "01_01_99" not in ranks[0]["run_dir"]
    assert ranks[0]["run_dirs_made"] == [os.path.basename(
        ranks[0]["run_dir"])]


def test_train_cli_with_coordinator_flags(ranks):
    """Each rank trains on its half of each batch of 4; the metrics are the
    global values, the same on both ranks; rank 0 alone writes the
    TensorBoard events."""
    for r, res in enumerate(ranks):
        assert res["cli_shard"] == (2, r, 2)
        assert len(res["cli_history"]) == 2
    assert ranks[0]["cli_history"] == ranks[1]["cli_history"]
    assert ranks[0]["cli_run_files"] == ["cfg.json", "tensorboard"]


def test_checkpoint_barrier_and_resume(ranks):
    """Rank 0 writes the checkpoint, the other rank finds it whole after
    the barrier, both resume from it, and the resumed two-rank run equals
    the straight one bitwise, on both ranks alike."""
    for res in ranks:
        assert res["ckpt_after_barrier"]
        assert res["resumed_from"] == 1
        # a digest of every tensor of the state, Adam moments included
        assert len(res["straight"]) > 100
        assert res["resumed"] == res["straight"]
    assert ranks[1]["straight"] == ranks[0]["straight"]


def test_one_process_helpers_call_no_collective():
    assert not mesh.is_distributed()
    assert mesh.initialize_multihost() is False
    assert (mesh.process_count(), mesh.process_index()) == (1, 0)
    assert mesh.process_local_batch_slice(8) == (8, 0)
    assert mesh.broadcast_object({"x": 1}) == {"x": 1}
    mesh.barrier()
    C.COUNTS.reset()
    x = torch.ones(3, requires_grad=True)
    for fn in (C.psum_data, C.pmean_data, C.data_share, C.all_gather_data,
               C.ppermute_ring):
        assert fn(x) is x
    lists = ([x], [x])
    assert all(a is b for a, b in zip(C.psum_flat(*lists), lists))
    tree = {"a": 1.0}
    assert C.cross_host_mean(tree) is tree and C.cross_host_sum(tree) is tree
    assert C.COUNTS.snapshot() == {}


def test_coordinator_needs_its_flags():
    with pytest.raises(ValueError):
        mesh.initialize_multihost("localhost:1")
    with pytest.raises(ValueError):
        mesh.initialize_multihost("auto", 2, 0)
    assert not mesh.is_distributed()
