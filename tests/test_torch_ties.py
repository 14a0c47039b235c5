"""The decisions that part the port's train step from the JAX package's at
some thread counts, each built at a tiny size from a seed:

  * a leaky ReLU at an input of exactly 0: JAX's jnp.where(x >= 0, ...)
    passes the gradient whole, and so does the port's physique net
    (models/physique.py:leaky_relu; F.leaky_relu would pass the slope);
  * a ReLU input within float32 rounding of 0 (a near-tie): both packages
    decide it by its sign, and their rounding decides the sign, so the
    parity tests decide it on both sides as the port's float64 run does
    (tests/torch_ties.py), which holds every gradient to the tolerance that
    a flip of it breaks;
  * Adam's largest step at its t-th update (tests/step_bounds.py).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from step_bounds import adam_step_bound
from torch_ties import JaxRelus, PortRelus, find_ties, positive_side
from x_as_supervision_tpu.models.composed import cal_links as jax_links
from x_as_supervision_tpu.models.discriminator import (
    build_discriminator as jax_disc,
)
from x_as_supervision_tpu.models.physique import (
    PhysiqueMaskGenerator as JaxPhysique,
)
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.models import physique
from x_as_supervision_tpu_torch.models.composed import cal_links
from x_as_supervision_tpu_torch.models.discriminator import (
    build_discriminator,
)
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

PARENTS = [0, 0, 1, 2, 0, 4, 5, 0, 17, 8, 9, 17, 11, 12, 17, 14, 15, 7]
RES_GCN = dict(name="res_gcn", input_dim=16, hidden_dim=16, output_dim=16,
               num_node=18, disc_sup_dim=3, num_layers=2,
               use_self_loop=True, use_bn=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_leaky_relu_passes_the_whole_gradient_at_zero_as_jax():
    x = np.random.default_rng(0).normal(size=64).astype(np.float32)
    x[::4] = 0.0
    x[1] = -0.0
    jy, jvjp = jax.vjp(lambda v: fnn.leaky_relu(v, negative_slope=0.01),
                       jnp.asarray(x))
    g = np.random.default_rng(1).normal(size=64).astype(np.float32)
    (jg,) = jvjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = physique.leaky_relu(xt, 0.01)
    (gt,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jg))
    # at 0 the whole gradient, where F.leaky_relu passes the slope
    np.testing.assert_array_equal(gt.numpy()[::4], g[::4])


def test_physique_net_on_its_kink_matches_jax():
    """An empty mask through a one-stage physique net: its conv sees a
    constant, its BatchNorm normalizes each zero-variance channel to
    exactly its bias, 0, and the leaky ReLU after it sits on its kink. The
    BatchNorm's bias gradient is the final conv's input gradient passed
    through that kink: JAX's, where F.leaky_relu would scale it by the
    slope."""
    x = np.zeros((2, 16, 16, 1), np.float32)
    r = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    jnet = JaxPhysique(num_features=(4,))
    variables = _np(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              train=False))

    def loss(params):
        y, _ = jnet.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), train=True, mutable=["batch_stats"])
        return (y * r).sum()

    want = weights.physique_state_dict(
        {"params": _np(jax.grad(loss)(variables["params"])),
         "batch_stats": variables["batch_stats"]})
    net = physique.PhysiqueMaskGenerator((4,))
    net.load_state_dict(weights.physique_state_dict(variables))
    net.train()
    y = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    grads = dict(zip([n for n, _ in net.named_parameters()],
                     torch.autograd.grad(
                         (y * torch.from_numpy(
                             r.transpose(0, 3, 1, 2).copy())).sum(),
                         list(net.parameters()))))
    assert np.abs(want["bns.0.bias"].numpy()).min() > 0
    for n in ("bns.0.weight", "bns.0.bias", "convs.1.weight",
              "convs.1.bias"):
        # the conv before the BatchNorm is off the kink's path: its input
        # is 0 and its bias is cancelled
        w = want[n].numpy()
        np.testing.assert_allclose(grads[n].numpy(), w, rtol=1e-5,
                                   atol=1e-7, err_msg=n)


@pytest.fixture(scope="module")
def near_tie():
    """The res_gcn discriminator (StatelessBN) on seeded poses, with the
    bias of its second BatchNorm moved so that one input of the ReLU after
    it lies at the float32 rounding of that BatchNorm's output from 0."""
    parents, children = jax_links(PARENTS, list(range(17)), extension=False)
    jnet = jax_disc(RES_GCN, parents, children)
    kps = np.random.default_rng(3).normal(0, 0.3, (6, 18, 3)).astype(
        np.float32)
    params = _np(jnet.init(jax.random.PRNGKey(0), jnp.asarray(kps),
                           train=False)["params"])

    def port(dtype, p):
        net = build_discriminator(RES_GCN, *cal_links(
            PARENTS, list(range(17)), extension=False))
        net.load_state_dict(weights.discriminator_state_dict(p))
        net.p_dropout = 0.0
        return net.to(dtype)

    # the exact output of the second BatchNorm (bias 0 there) ...
    outs = []
    net = port(torch.float64, params)
    net.bns[1].register_forward_hook(lambda m, i, o: outs.append(o.detach()))
    net(torch.from_numpy(kps).double())
    z = outs[0] - net.bns[1].bias.detach()
    row, node, c = 4, 7, 5
    # ... and its bias: the float32 nearest to minus that element's value
    bias = np.array(params["_StatelessBN_1"]["bias"])
    bias[c] = np.float32(-float(z[row, node, c]))
    params["_StatelessBN_1"]["bias"] = bias
    return jnet, params, port, kps, (row, node, c)


def _port_grads(port, params, kps, dtype, relus):
    net = port(dtype, params)
    x = torch.from_numpy(kps).to(dtype)
    with relus:
        y = net(x)
        grads = torch.autograd.grad(y.sum(), list(net.parameters()))
    return y.detach().double().numpy(), {
        n: g.double().numpy()
        for (n, _), g in zip(net.named_parameters(), grads)}


def test_a_near_tie_is_found_and_decided_on_both_sides(near_tie):
    jnet, params, port, kps, (row, node, c) = near_tie
    r32, r64 = PortRelus(), PortRelus()
    _port_grads(port, params, kps, torch.float32, r32)
    _port_grads(port, params, kps, torch.float64, r64)
    ties = find_ties(r32, r64)
    # the ReLU after the second BatchNorm: the first GCN layer's, the first
    # block's two
    call = 2
    flat = np.ravel_multi_index((row, node, c), ties.shapes[call])
    index, positive = ties.port[call]
    assert flat in index.tolist()
    exact = float(r64.inputs[call].flatten()[flat])
    scale = float(r64.inputs[call].abs().max())
    assert abs(exact) < 1e-6 * scale  # within float32's rounding of 0

    y, got = _port_grads(port, params, kps, torch.float32,
                         PortRelus(ties.port))
    with JaxRelus(ties) as relus:
        jy, jg = jax.value_and_grad(
            lambda p: jnet.apply({"params": p}, jnp.asarray(kps),
                                 train=False).sum())(params)
    assert relus.calls == len(ties.shapes)
    # the biases a StatelessBN follows get a gradient of 0 up to rounding
    cancelled = set(port(torch.float32, params).bn_cancelled_biases())
    want = {k: v.numpy() for k, v in
            weights.discriminator_state_dict(_np(jg)).items()
            if k not in cancelled}
    np.testing.assert_allclose(y.sum(), float(jy), rtol=1e-5)
    for k, w in want.items():
        # the discriminator tests' bound
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)

    # the other decision at that element breaks that bound: the decision,
    # not rounding, is what the tests hold
    flipped = {call: (index, torch.where(
        index == flat, ~positive, positive))}
    _, other = _port_grads(port, params, kps, torch.float32,
                           PortRelus(flipped))
    assert any(
        not np.allclose(other[k], w, rtol=1e-4, atol=1e-5 * np.abs(w).max())
        for k, w in want.items())


def test_a_recomputed_relu_is_decided_as_its_forward_call():
    """A ReLU inside a rematerialized segment runs again in the backward;
    PortRelus decides it there as in the forward, so the gradient follows
    the forced decision."""
    x = torch.tensor([-1.0, 2.0, 3.0, -4.0], requires_grad=True)
    w = torch.tensor([1.0, -1.0, 1.0, -1.0])
    forced = {0: (torch.tensor([0, 1]), torch.tensor([True, False]))}
    calls = []
    with PortRelus(forced) as relus:
        y = checkpoint(lambda v: calls.append(1) or F.relu(v * w), x,
                       use_reentrant=False)
        (g,) = torch.autograd.grad(y.sum(), x)
    assert len(calls) == 2  # the forward, and its recomputation
    assert len(relus.inputs) == 1 and relus.applied == {0}
    # inputs -1, -2, 3, 4: element 0 forced to pass, element 1 not to;
    # 2 and 3 by their sign
    np.testing.assert_array_equal(g.numpy(), [1.0, 0.0, 1.0, -1.0])
    assert positive_side(torch.tensor(0.0), "leaky")
    assert not positive_side(torch.tensor(0.0), "relu")


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_adam_step_bound_is_the_largest_step(count):
    """S(t) (step_bounds.adam_step_bound) against torch's Adam(0.5, 0.999)
    on the gradient history that attains it, and the values 1.000, 1.054,
    1.134 and 1.229."""
    b1, b2 = 0.5, 0.999
    s = adam_step_bound(count)
    np.testing.assert_allclose(s, (1.0, 1.054, 1.134, 1.229)[count - 1],
                               atol=6e-4)
    i = np.arange(1, count + 1)
    history = ((1 - b1) * b1 ** (count - i)) / ((1 - b2) * b2 ** (count - i))
    p = torch.zeros(1, dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([p], lr=1e-3, betas=(b1, b2), eps=0.0)
    steps = []
    for g in history:
        before = float(p.detach())
        p.grad = torch.tensor([g], dtype=torch.float64)
        opt.step()
        steps.append(float(p.detach()) - before)
    np.testing.assert_allclose(abs(steps[-1]), s * 1e-3, rtol=1e-12)
    # and no other history steps further
    rng = np.random.default_rng(count)
    for _ in range(200):
        q = torch.zeros(1, dtype=torch.float64, requires_grad=True)
        opt = torch.optim.Adam([q], lr=1e-3, betas=(b1, b2), eps=0.0)
        for g in rng.normal(size=count) * 10.0 ** rng.uniform(-3, 3, count):
            before = float(q.detach())
            q.grad = torch.tensor([g], dtype=torch.float64)
            opt.step()
        assert abs(float(q.detach()) - before) <= s * 1e-3 * (1 + 1e-12)
