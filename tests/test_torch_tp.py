"""The port's tensor-parallel rules (x_as_supervision_tpu_torch/parallel/
tp.py) in one process: the split rule against the JAX package's
``tp_spec`` on every leaf of the tiny and the flagship GAN at 1, 2, 3 and 4
model ranks; the link's route by the width of its Cout shard; the
backend a rank picks; and the one-process answers of the grid and the
tensor-parallel collectives. The multi-rank behaviour is in
test_torch_tp_ranks.py.

The JAX shapes come from ``jax.eval_shape`` of the JAX package's
``init_train_state``, so no ResNet-50 is computed. Each JAX leaf is filled
with a marker (its number, plus the index along the axis JAX splits) and
carried into the port's names through weights.py's mappings (with their
transposes and flips), so each torch tensor says which JAX leaf it came
from and along which of its own dims JAX's split axis runs.
"""

import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from torch_parity import jax_state_in_port_names
from x_as_supervision_tpu.data.synthetic import (
    SyntheticPoseDataset as JaxSyntheticPoseDataset)
from x_as_supervision_tpu.parallel.mesh import MODEL_AXIS
from x_as_supervision_tpu.parallel.tp import tp_spec as jax_tp_spec
from x_as_supervision_tpu.train.factory import build_gan_spec as jax_spec
from x_as_supervision_tpu.train.state import init_train_state, make_optimizers
from x_as_supervision_tpu_torch.models.resnet import Bottleneck
from x_as_supervision_tpu_torch.parallel import collectives as C
from x_as_supervision_tpu_torch.parallel import mesh, tp
from x_as_supervision_tpu_torch.train.factory import (
    build_gan_spec, flagship_config)

MARK = 10_000.0  # leaf number * MARK + index along JAX's split axis
SIZES = (1, 2, 3, 4)
_GROUPS = ("det_params", "det_stats", "phys_params", "phys_stats",
           "disc_params")


def _split_axis(leaf, m: int):
    """The axis of a JAX leaf that JAX's tp_spec splits over m, or None."""
    spec = tuple(jax_tp_spec(leaf, m))
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _varying_dims(t: torch.Tensor) -> list:
    """The dims along which t's values change."""
    return [d for d in range(t.dim())
            if t.shape[d] > 1 and not torch.equal(
                t.narrow(d, 0, 1).expand_as(t), t)]


@pytest.fixture(scope="module", params=[True, False], ids=["tiny",
                                                           "flagship"])
def carried(request):
    """Each port tensor's JAX leaf and where JAX's split axis went: (the
    port's spec, {port key: (JAX leaf number, torch dim of the axis JAX
    splits at some m, or None)}, {leaf number: {m: JAX split axis}}).

    Every JAX leaf is filled with a marker (its number, plus the index
    along the axis JAX splits it at any of SIZES) and carried into the
    port's names through weights.py's mappings (with their transposes and
    flips), once; the split axis is the same at every m that splits."""
    tiny = request.param
    cfg = _flagship_config(tiny=tiny)
    side = 64 if tiny else 256
    batch = JaxSyntheticPoseDataset(
        num_samples=1, cam_id_list=tuple(cfg["model_params"]["cam_id_list"]),
        patch_size=side).device_batch(0, 1)
    spec = jax_spec(cfg)
    opt_det, opt_disc = make_optimizers(cfg["train_params"], 10)
    abstract = jax.eval_shape(lambda: init_train_state(
        spec, jax.random.PRNGKey(0), batch, opt_det, opt_disc))
    axes, count = {}, [0]

    def mark(leaf):
        count[0] += 1
        n = count[0]
        axes[n] = {m: _split_axis(leaf, m) for m in SIZES}
        arr = np.full(leaf.shape, n * MARK, np.float32)
        split = {a for a in axes[n].values() if a is not None}
        assert len(split) <= 1
        if split:
            (axis,) = split
            shape = [1] * len(leaf.shape)
            shape[axis] = leaf.shape[axis]
            arr += np.arange(leaf.shape[axis], dtype=np.float32).reshape(
                shape)
        return arr

    marked = type("Marked", (), {g: jax.tree.map(mark, getattr(abstract, g))
                                 for g in _GROUPS})
    port = {}
    for key, v in jax_state_in_port_names(marked).items():
        t = torch.from_numpy(np.asarray(v))
        dims = _varying_dims(t)
        assert len(dims) <= 1, key
        port[key] = (int(t.min().item() // MARK), dims[0] if dims else None)
    # the leaves came across one to one
    assert len({leaf for leaf, _ in port.values()}) == len(port) == count[0]
    pspec = build_gan_spec(flagship_config(tiny=tiny), torch.float32)
    return pspec, port, axes


@pytest.mark.parametrize("m", SIZES)
def test_split_rule_is_jax_tp_spec_on_every_leaf(carried, m):
    """Every parameter and running statistic of the port is split where
    JAX splits the leaf it comes from, along the torch dim JAX's split axis
    became (a ConvTranspose's output dim is 1, a Linear's 0), and nowhere
    else."""
    pspec, port, axes = carried
    dims = tp.state_shardings(pspec, m)
    assert sorted(port) == sorted(k for k in dims if "num_batches" not in k)
    assert all(dims[k] is None for k in dims if "num_batches" in k)
    split = 0
    for key, (leaf, torch_dim) in port.items():
        if axes[leaf][m] is None:
            assert dims[key] is None, key
            continue
        assert dims[key] == torch_dim is not None, (key, dims[key],
                                                    torch_dim)
        split += 1
    assert (split > 0) == (m > 1)


def test_link_route_by_cout_shard():
    """layer3's links (256 planes) run on their shard at 2 and 4 model
    ranks, and by the gathered weight at 8 (32 channels, below the
    kernel's 64); layer4's (512) on their shard at 8."""
    assert tp.link_route(256 // 2) == "shard"
    assert tp.link_route(256 // 4) == "shard"
    assert tp.link_route(256 // 8) == "gathered_weight"
    assert tp.link_route(512 // 8) == "shard"
    assert tp.link_route(512 // 16) == "gathered_weight"


@pytest.mark.parametrize("cards,local,device,want", [
    (1, "2", None, "gloo"),    # two ranks on one card: NCCL refuses them
    (1, "1", None, "nccl"),
    (4, "4", None, "nccl"),
    (4, "8", None, "gloo"),
    (1, None, None, "nccl"),   # not under torchrun: one rank a card
    (1, "1", "cpu", "gloo"),
    (0, "1", None, "gloo"),    # no card
])
def test_default_backend(cards, local, device, want):
    env = {} if local is None else {"LOCAL_WORLD_SIZE": local}
    with mock.patch.dict(os.environ, env, clear=False), \
            mock.patch.object(torch.cuda, "is_available",
                              lambda: cards > 0), \
            mock.patch.object(torch.cuda, "device_count", lambda: cards):
        if local is None:
            os.environ.pop("LOCAL_WORLD_SIZE", None)
        assert mesh.default_backend(device) == want


def test_one_process_grid_and_collectives():
    """One process is a world of one: a model axis of 2 does not divide
    it; without a grid every tensor-parallel helper is the identity and
    nothing is split."""
    assert not mesh.is_distributed()
    with pytest.raises(ValueError, match="not divisible by model=2"):
        mesh.make_grid(2)
    mesh.make_grid(1)
    assert (mesh.model_size(), mesh.model_index()) == (1, 0)
    assert (mesh.data_size(), mesh.data_index()) == (1, 0)
    assert mesh.data_group() is None and mesh.model_group() is None
    C.COUNTS.reset()
    x = torch.ones(4, requires_grad=True)
    for fn in (C.psum_model, C.copy_to_model, C.gather_channels,
               C.model_slice):
        assert fn(x) is x
    assert C.broadcast_model_(x) is x
    assert tp.full_param(x, 4) is x and tp.full_channels(x, 4, 0) is x
    block = Bottleneck(1024, 256)
    assert tp.shard_module(block, 1) == {}
    assert C.COUNTS.snapshot() == {}


def test_take_shard_and_split_rule():
    t = torch.arange(12.0).reshape(4, 3)
    assert tp.take_shard(t, 0, 2, 1).tolist() == [[6.0, 7.0, 8.0],
                                                 [9.0, 10.0, 11.0]]
    # a width that does not divide m comes back whole (another model)
    assert tp.take_shard(t, 1, 2, 0) is t
    assert tp.tp_spec(torch.empty(64), 2) == 0
    assert tp.tp_spec(torch.empty(32), 2) is None      # below MIN_VECTOR
    assert tp.tp_spec(torch.empty(66), 4) is None      # does not divide
    assert tp.tp_spec(torch.empty(32, 16, 3, 3), 2) == 0
    assert tp.tp_spec(torch.empty(16, 32, 4, 4), 2, out_dim=1) == 1
    assert tp.tp_spec(torch.empty(1, 512), 2) is None  # one output
    assert tp.tp_spec(torch.empty(512, 64), 1) is None


def test_replica_drift_reading():
    """replica_drift: the largest per-tensor distance from model rank 0's
    values relative to rank 0's largest entry (absolute where rank 0's is
    all zero), the tensors not held left out, the largest since the last
    reading; None where nothing was synced."""
    assert tp.replica_drift() is None
    rank0 = torch.tensor([2.0, -4.0, 0.0, 0.0, 1.0, 1.0])
    mine = torch.tensor([2.0, -4.02, 0.0, 0.001, 1.0, 3.0])
    # tensors (2,), (2,), (2,): 0.02 / 4, 0.001 absolute, the third not held
    tp._note_drift(mine, rank0, [2, 2, 2], [True, True, False])
    tp._note_drift(rank0, rank0, [6], [True])
    assert tp.replica_drift() == pytest.approx(0.005)
    assert tp.replica_drift() is None
    tp._note_drift(rank0, rank0, [6], [True])
    assert tp.replica_drift() == 0.0
