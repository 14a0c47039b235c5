"""The port's ResNet Bottleneck in train mode (models/resnet.py: the fused
BN -> ReLU -> conv3x3 link with batch statistics, ops/conv_bn.py's
autograd.Function) against the JAX package's Bottleneck(fuse_bn=True)
(Pallas link in interpret mode, its hand-written XLA backward) and
Bottleneck(fuse_bn=False), in train mode: outputs, gradients of the input
and every parameter, and both link BatchNorms' updated running statistics.
Also the BatchNorm repair: running variance folds the biased batch
variance, with flax's momentum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x_as_supervision_tpu.models.resnet import Bottleneck as JaxBottleneck
from x_as_supervision_tpu.models.resnet import _BN as JaxBN
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.models import resnet as R
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

X_SHAPE = (2, 6, 6, 1024)  # NHWC; the link sees n = 2 * 6 * 6 = 72 pixels


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(4)
    x = rng.normal(size=X_SHAPE).astype(np.float32)
    r = rng.normal(size=X_SHAPE).astype(np.float32)
    variables = _np(JaxBottleneck(256, fuse_bn=False).init(
        jax.random.PRNGKey(1), jnp.asarray(x), train=False))
    for i in range(3):  # non-trivial BN parameters and statistics
        p = variables["params"][f"_BN_{i}"]["BatchNorm_0"]
        s = variables["batch_stats"][f"_BN_{i}"]["BatchNorm_0"]
        c = p["scale"].shape[0]
        p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        p["bias"] = rng.normal(size=c).astype(np.float32) * 0.2
        s["mean"] = rng.normal(size=c).astype(np.float32) * 0.2
        s["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)

    want = {}
    for fuse in (True, False):
        block = JaxBottleneck(256, fuse_bn=fuse)

        def loss(params, x_):
            y, mut = block.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                x_, train=True, mutable=["batch_stats"])
            return (y * r).sum(), (y, mut["batch_stats"])

        (_, (y, stats)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                               jnp.asarray(x))
        want[fuse] = dict(y=np.asarray(y), stats=_np(stats), gp=_np(gp),
                          gx=np.asarray(gx))

    block = R.Bottleneck(1024, 256).train()
    assert block.fused_link
    sd = {}
    for i in range(3):
        sd[f"conv{i + 1}.weight"] = weights._conv(
            variables["params"][f"Conv_{i}"]["kernel"])
        weights._bn(sd, f"bn{i + 1}", variables["params"][f"_BN_{i}"],
                    variables["batch_stats"][f"_BN_{i}"])
    block.load_state_dict(sd)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    y = block(xt)
    names = [n for n, _ in block.named_parameters()]
    grads = torch.autograd.grad(
        (y * torch.from_numpy(r.transpose(0, 3, 1, 2).copy())).sum(),
        [xt] + list(block.parameters()))
    got = dict(y=y.detach().permute(0, 2, 3, 1).numpy(),
               gx=grads[0].permute(0, 2, 3, 1).numpy(),
               gp=dict(zip(names, grads[1:])), sd=block.state_dict())
    return want, got


def _flax(name: str) -> tuple:
    """Port parameter name -> (flax module, leaf) of the Bottleneck tree."""
    mod, leaf = name.split(".")
    i = int(mod[-1]) - 1
    if mod.startswith("conv"):
        return f"Conv_{i}", "kernel"
    return f"_BN_{i}", {"weight": "scale", "bias": "bias"}[leaf]


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_train_forward_and_input_gradient_match_jax(case, fuse):
    want, got = case
    # fp32, three convs and four batch reductions in other orders
    np.testing.assert_allclose(got["y"], want[fuse]["y"], rtol=1e-4,
                               atol=1e-4)
    scale = np.abs(want[fuse]["gx"]).max()
    np.testing.assert_allclose(got["gx"], want[fuse]["gx"], rtol=1e-3,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_train_parameter_gradients_match_jax(case, fuse):
    want, got = case
    for name, g in got["gp"].items():
        mod, leaf = _flax(name)
        w = want[fuse]["gp"][mod]
        w = w[leaf] if mod.startswith("Conv") else w["BatchNorm_0"][leaf]
        if leaf == "kernel":
            w = w.transpose(3, 2, 0, 1)
        # fp32 sums over the batch's pixels in another order, relative to
        # the tensor's largest gradient
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_train_running_statistics_match_jax(case, fuse):
    want, got = case
    for i in range(3):
        s = want[fuse]["stats"][f"_BN_{i}"]["BatchNorm_0"]
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            # biased variance, momentum 0.9 (flax) == 0.1 (torch); the link's
            # bn2 folds the one-pass variance of its (sum, sumsq)
            np.testing.assert_allclose(got["sd"][f"bn{i + 1}.{ours}"].numpy(),
                                       s[theirs], rtol=1e-4, atol=1e-5,
                                       err_msg=f"bn{i + 1}.{ours}")


def test_batchnorm_folds_the_biased_variance_like_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, size=(4, 3, 3, 8)).astype(np.float32)  # n = 36
    jbn = JaxBN()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    y, mut = jbn.apply(variables, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    bn = R.BatchNorm2d(8).train()
    got = bn(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    s = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(s["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(s["var"]),
                               rtol=1e-6)
    biased = x.reshape(-1, 8).var(axis=0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * biased,
                               rtol=1e-6)
    # nn.BatchNorm2d folds the unbiased variance, 36/35 of it
    ref = torch.nn.BatchNorm2d(8).train()
    ref(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert not np.allclose(ref.running_var.numpy(), bn.running_var.numpy(),
                           rtol=1e-4)
