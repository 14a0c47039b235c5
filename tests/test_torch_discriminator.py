"""The port's discriminators (x_as_supervision_tpu_torch/models/
discriminator.py) against the JAX package's, with flax-initialized weights
carried through weights.py: the decoupled SAGE discriminator, the SAGE one
(res_sage_gcn) and the GCN ones (res_gcn with and without use_bn,
simple_gcn): outputs and gradients with dropout off (the frameworks draw
different random bits), and the port's dropout on its own: keep rate 0.8 in
the decoupled header and 0.5 in res_gcn, kept values scaled by the inverse,
driven by an explicit generator. fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x_as_supervision_tpu.models.composed import cal_links as jax_links
from x_as_supervision_tpu.models.discriminator import (
    build_discriminator as jax_build,
)
from x_as_supervision_tpu.models.discriminator import (
    positional_encoding as jax_pe,
)
from x_as_supervision_tpu.models.discriminator import (
    skeleton_adjacency as jax_adj,
)
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.models.composed import cal_links
from x_as_supervision_tpu_torch.models.discriminator import (
    FFNHeader,
    GCNDiscriminator,
    GCNDiscriminatorDecouple,
    GCNSAGEDiscriminator,
    StatelessBN,
    build_discriminator,
    positional_encoding,
    skeleton_adjacency,
    sym_normalize,
)
from x_as_supervision_tpu.models.discriminator import (
    sym_normalize as jax_sym_normalize,
)

PARENTS = [0, 0, 1, 2, 0, 4, 5, 0, 17, 8, 9, 17, 11, 12, 17, 14, 15, 7]
PARAMS = dict(name="res_sage_gcn_decouple", input_dim=16, hidden_dim=16,
              output_dim=16, num_node=18, disc_sup_dim=3, num_layers=2,
              use_self_loop=True, use_pe=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    parents, children = jax_links(PARENTS, list(range(17)), extension=False)
    jdisc = jax_build(PARAMS, parents, children)
    kps = np.random.default_rng(0).normal(0, 0.3, (6, 18, 3)).astype(
        np.float32)
    params = _np(jdisc.init(jax.random.PRNGKey(0), jnp.asarray(kps),
                            train=False)["params"])
    disc = build_discriminator(PARAMS, *cal_links(PARENTS, list(range(17)),
                                                  extension=False))
    disc.load_state_dict(weights.discriminator_state_dict(params))
    return jdisc, params, disc, kps


def test_graph_constants_match_jax():
    parents, children = cal_links(PARENTS, list(range(17)), extension=False)
    np.testing.assert_array_equal(
        skeleton_adjacency(parents, children, 18, 1.0),
        jax_adj(parents, children, 18, 1.0))
    np.testing.assert_array_equal(positional_encoding(18, 3),
                                  jax_pe(18, 3))


def test_forward_and_gradients_match_jax_with_dropout_off(pair):
    jdisc, params, disc, kps = pair
    r = np.random.default_rng(1).normal(size=(6, 1)).astype(np.float32)

    def loss(p, k):
        out = jdisc.apply({"params": p}, k, train=False)
        return (out * r).sum(), out

    (_, want), (gp, gk) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(params,
                                                           jnp.asarray(kps))
    disc.train()
    disc.header.p_dropout = 0.0
    kt = torch.from_numpy(kps).requires_grad_(True)
    out = disc(kt)
    names = [n for n, _ in disc.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                [kt] + list(disc.parameters()))
    # fp32 through two SAGE streams and the FFN header
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gk), rtol=1e-4,
                               atol=1e-6)
    want_g = weights.discriminator_state_dict(_np(gp))
    assert sorted(names) == sorted(want_g)
    for n, g in zip(names, grads[1:]):
        w = want_g[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(w).max(), 1.0),
                                   err_msg=n)


def test_dropout_keeps_080_and_scales_by_its_inverse():
    head = FFNHeader(8, hidden=4096, p_dropout=0.2).train()
    with torch.no_grad():
        head.dense0.weight.zero_()
        head.dense0.bias.fill_(1.0)  # every hidden unit is exactly 1
    captured = []
    head.dense1.register_forward_pre_hook(lambda m, a: captured.append(a[0]))
    x = torch.zeros(16, 8)
    head(x, torch.Generator().manual_seed(0))
    h = captured[0]
    kept = h != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    torch.testing.assert_close(h[kept], torch.full_like(h[kept], 1 / 0.8))
    # the same generator seed draws the same mask; another seed another
    head(x, torch.Generator().manual_seed(0))
    head(x, torch.Generator().manual_seed(1))
    assert torch.equal(captured[1], h) and not torch.equal(captured[2], h)
    head.eval()
    head(x, torch.Generator().manual_seed(0))
    assert torch.equal(captured[3], torch.ones_like(h))  # no dropout in eval


VARIANTS = {
    "res_sage_gcn": dict(name="res_sage_gcn", use_pe=True),
    "res_sage_gcn_nope": dict(name="res_sage_gcn", use_pe=False,
                              use_self_loop=False),
    "res_gcn": dict(name="res_gcn", use_bn=False),
    "res_gcn_bn": dict(name="res_gcn", use_bn=True, num_layers=3),
    "simple_gcn": dict(name="simple_gcn", use_self_loop=False),
}


def _variant_pair(key, seed=0):
    params = dict(PARAMS, **VARIANTS[key])
    links = jax_links(PARENTS, list(range(17)), extension=False)
    jdisc = jax_build(params, *links)
    kps = np.random.default_rng(seed).normal(0, 0.3, (6, 18, 3)).astype(
        np.float32)
    jparams = _np(jdisc.init(jax.random.PRNGKey(seed), jnp.asarray(kps),
                             train=False)["params"])
    disc = build_discriminator(params, *cal_links(PARENTS, list(range(17)),
                                                  extension=False))
    disc.load_state_dict(weights.discriminator_state_dict(jparams))
    return jdisc, jparams, disc, kps


@pytest.mark.parametrize("key", sorted(VARIANTS))
def test_other_discriminators_match_jax_with_dropout_off(key):
    jdisc, params, disc, kps = _variant_pair(key)
    want_type = {"res_sage_gcn": GCNSAGEDiscriminator,
                 "res_gcn": GCNDiscriminator,
                 "simple_gcn": GCNDiscriminator}[VARIANTS[key]["name"]]
    assert type(disc) is want_type
    r = np.random.default_rng(1).normal(size=(6, 1)).astype(np.float32)

    def loss(p, k):
        out = jdisc.apply({"params": p}, k, train=False)
        return (out * r).sum(), out

    (_, want), (gp, gk) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(params,
                                                           jnp.asarray(kps))
    disc.train()
    if isinstance(disc, GCNDiscriminator):
        disc.p_dropout = 0.0
    kt = torch.from_numpy(kps).requires_grad_(True)
    out = disc(kt)
    names = [n for n, _ in disc.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                [kt] + list(disc.parameters()))
    # fp32 through the stack and the header (the GCN's adjacency, its
    # degree normalization and, with use_bn, batch statistics over 6 x 18)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gk), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(gk)).max())
    want_g = weights.discriminator_state_dict(_np(gp))
    assert sorted(names) == sorted(want_g)
    for n, g in zip(names, grads[1:]):
        w = want_g[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(w).max(), 1.0),
                                   err_msg=n)


@pytest.mark.parametrize("key", sorted(VARIANTS) + ["decouple"])
def test_weights_mapping_carries_every_parameter(key):
    """JAX params -> state_dict: a strict load, and every JAX number lands
    in exactly one port tensor (the same multiset of values)."""
    if key == "decouple":
        params = dict(PARAMS)
        links = jax_links(PARENTS, list(range(17)), extension=False)
        jparams = _np(jax_build(params, *links).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 18, 3)),
            train=False)["params"])
        disc = build_discriminator(params, *cal_links(
            PARENTS, list(range(17)), extension=False))
        assert isinstance(disc, GCNDiscriminatorDecouple)
    else:
        _, jparams, disc, _ = _variant_pair(key)
    sd = weights.discriminator_state_dict(jparams)
    disc.load_state_dict(sd)  # strict
    leaves = np.sort(np.concatenate([np.ravel(v) for v in
                                     jax.tree_util.tree_leaves(jparams)]))
    mapped = np.sort(np.concatenate([v.numpy().ravel()
                                     for v in sd.values()]))
    np.testing.assert_array_equal(leaves, mapped)


def test_res_gcn_dropout_keeps_half_and_scales_by_two():
    disc = build_discriminator(dict(PARAMS, name="res_gcn", input_dim=64,
                                    hidden_dim=64, output_dim=64), PARENTS[1:],
                               list(range(1, 18))).train()
    captured = []
    disc.gcn[2].register_forward_pre_hook(lambda m, a: captured.append(a[0]))
    with torch.no_grad():
        for layer in disc.gcn[:2]:
            layer.lin.weight.zero_()
            layer.bias.fill_(1.0)  # every unit before the dropout is 1
    x = torch.randn(32, 18, 3)
    disc(x, torch.Generator().manual_seed(0))
    h = captured[0]
    kept = h != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.02
    torch.testing.assert_close(h[kept], torch.full_like(h[kept], 2.0))
    disc(x, torch.Generator().manual_seed(0))
    disc(x, torch.Generator().manual_seed(1))
    assert torch.equal(captured[1], h) and not torch.equal(captured[2], h)
    disc.eval()
    disc(x, torch.Generator().manual_seed(0))
    assert torch.equal(captured[3], torch.ones_like(h))


def test_stateless_bn_uses_batch_statistics_in_eval_too():
    bn = StatelessBN(8)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    x = torch.randn(5, 18, 8) * 3 + 1
    train = bn.train()(x)
    torch.testing.assert_close(bn.eval()(x), train, rtol=0, atol=0)
    assert not list(bn.buffers())  # no running statistics
    y = (train - bn.bias) / bn.weight
    torch.testing.assert_close(y.mean(dim=(0, 1)), torch.zeros(8),
                               rtol=0, atol=1e-5)


def test_sym_normalize_matches_jax_and_guards_zero_degree():
    adj = np.random.default_rng(2).uniform(0, 1, (3, 6, 6)).astype(
        np.float32)
    adj[:, 2, :] = 0.0  # an isolated node (row of zeros)
    adj[:, :, 2] = 0.0
    got = sym_normalize(torch.from_numpy(adj)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_sym_normalize(
        jnp.asarray(adj))), rtol=1e-6, atol=1e-7)
    assert np.isfinite(got).all() and not got[:, 2].any()


def test_unknown_names_raise():
    for name in ("res_gcn_x", "mlp"):
        with pytest.raises(NotImplementedError):
            build_discriminator(dict(PARAMS, name=name), [0], [1])
