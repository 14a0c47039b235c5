"""The port's physique mask generator (x_as_supervision_tpu_torch/models/
physique.py) against the JAX package's PhysiqueMaskGenerator (its default
NHWC path), with flax-initialized weights carried through weights.py, in
train mode: outputs, input and parameter gradients, and the BatchNorm
statistics; and in eval mode. fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x_as_supervision_tpu.models.physique import (
    PhysiqueMaskGenerator as JaxPhysique,
)
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.models.physique import (
    PhysiqueMaskGenerator,
    stages,
)

LAYERS = (4, 8, 16)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    # a rendered-line-like input: mostly small, a few bright strokes
    x = np.exp(-rng.uniform(0, 8, (3, 32, 32, 1))).astype(np.float32)
    jnet = JaxPhysique(num_features=LAYERS)
    variables = _np(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              train=False))
    for name, bn in variables["params"].items():  # non-trivial affine
        if name.startswith("_BN_"):
            c = bn["BatchNorm_0"]["scale"].shape[0]
            bn["BatchNorm_0"]["scale"] = rng.uniform(0.5, 1.5, c).astype(
                np.float32)
            bn["BatchNorm_0"]["bias"] = (rng.normal(size=c) * 0.1).astype(
                np.float32)
    net = PhysiqueMaskGenerator(LAYERS)
    net.load_state_dict(weights.physique_state_dict(variables))
    return jnet, variables, net, x


def test_stage_list_matches_jax(pair):
    jnet = pair[0]
    assert stages(LAYERS) == jnet._stages()
    # 1->4, 4->4, 4->8 s2, 8->8, 8->16 s2; 16->16, up, 16->8; 8->8, up,
    # 8->4; and the final conv to one channel
    assert len(pair[2].convs) == 10


def test_train_forward_gradients_and_stats_match_jax(pair):
    jnet, variables, net, x = pair
    r = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def loss(params, x_):
        y, mut = jnet.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            x_, train=True, mutable=["batch_stats"])
        return (y * r).sum(), (y, mut["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                           jnp.asarray(x))
    net.train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    y = net(xt)
    assert y.dtype == torch.float32 and y.shape == (3, 1, 32, 32)
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(
        (y * torch.from_numpy(r.transpose(0, 3, 1, 2).copy())).sum(),
        [xt] + list(net.parameters()))
    # fp32 through ten convs and nine batch normalizations
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-5)
    gx = np.asarray(gx)
    np.testing.assert_allclose(grads[0].permute(0, 2, 3, 1).numpy(), gx,
                               rtol=1e-3, atol=1e-4 * np.abs(gx).max())
    want_g = weights.physique_state_dict(
        {"params": _np(gp), "batch_stats": _np(stats)})
    cancelled = set(net.bn_cancelled_biases())
    for n, g in zip(names, grads[1:]):
        w = want_g[n].numpy()
        if n in cancelled:
            # a train-mode BN cancels these biases: zero up to rounding
            assert np.abs(g.numpy()).max() <= 1e-4 * np.abs(gx).max(), n
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=n)
    sd = net.state_dict()
    for k, v in want_g.items():
        if "running" in k:
            # biased variance, flax momentum; fp32 batch reductions
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_eval_forward_matches_jax(pair):
    jnet, variables, net, x = pair
    want = jnet.apply(variables, jnp.asarray(x), train=False)
    net.load_state_dict(weights.physique_state_dict(variables))  # fresh stats
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    net.train()
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-5)


def test_convs_go_through_the_conv_wrapper(pair, monkeypatch):
    from x_as_supervision_tpu_torch.ops import conv3x3 as C

    net, x = pair[2], pair[3]
    calls = []
    real = C.conv3x3_kernel
    monkeypatch.setattr(C, "conv3x3_kernel",
                        lambda *a: calls.append(a[3]) or real(*a))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    y = net(xt)
    assert calls == [1, 1, 2, 1, 2, 1, 1, 1, 1, 1]
    torch.autograd.grad(y.sum(), xt)
    # the input gradients of the eight stride-1 convs reuse the kernel
    assert len(calls) == 18


def _nhwc_strides(t):
    b, c, h, w = t.shape
    return t.stride() == (h * w * c, 1, w * c, c)


def test_every_conv_call_gets_channels_last(pair, monkeypatch):
    """The net keeps its activations channels-last: each of the 18 conv
    calls (10 forwards, 8 stride-1 input gradients) receives dense NHWC
    strides, a C = 1 tensor included, and the net still matches JAX."""
    from x_as_supervision_tpu_torch.ops import conv3x3 as C

    jnet, variables, net, x = pair
    seen = []
    real = C.conv3x3_kernel
    monkeypatch.setattr(C, "conv3x3_kernel",
                        lambda *a: seen.append((tuple(a[0].shape),
                                                _nhwc_strides(a[0])))
                        or real(*a))
    net.load_state_dict(weights.physique_state_dict(variables))
    net.train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    y = net(xt)
    (gx,) = torch.autograd.grad(y.sum(), xt)
    assert len(seen) == 18
    assert all(ok for _, ok in seen), [s for s, ok in seen if not ok]
    assert sum(s[1] == 1 for s, _ in seen) == 2  # first conv, last dgrad

    def loss(x_):
        out, _ = jnet.apply(variables, x_, train=True, mutable=["batch_stats"])
        return out.sum(), out

    (_, want), want_gx = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(x))
    # fp32 through ten convs and nine batch normalizations, as above
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-5)
    want_gx = np.asarray(want_gx)
    np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(), want_gx,
                               rtol=1e-3, atol=1e-4 * np.abs(want_gx).max())
