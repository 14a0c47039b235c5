"""The port's small-channel 3x3 conv (x_as_supervision_tpu_torch/ops/
conv3x3.py) and its autograd.Function against the JAX package's Pallas conv
(ops/conv_pallas.py:conv3x3_nhcw, interpret mode) and its XLA reference,
forward and gradients, on the same seeded inputs.

JAX activations are NHCW (B, H, C, W) with HWIO weights; the port's are
NCHW with OIHW weights, so the port gets the same arrays permuted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x_as_supervision_tpu.ops.conv_pallas import _xla_ref, conv3x3_nhcw
from x_as_supervision_tpu_torch.ops.conv3x3 import (
    conv3x3,
    conv3x3_kernel,
    conv3x3_plain,
)

CASES = [
    # (B, Cin, Cout, H, W, stride)
    (2, 1, 4, 8, 16, 1),   # Cin = 1: the physique net's first conv
    (2, 4, 1, 8, 16, 1),   # Cout = 1: its last conv
    (2, 4, 8, 8, 16, 2),   # stride 2
    (1, 8, 8, 16, 8, 1),
    (2, 8, 4, 8, 8, 2),
]


def _case(b, cin, cout, h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, cin, w)).astype(np.float32)  # NHCW
    wt = (rng.normal(size=(3, 3, cin, cout)) * 0.3).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    return x, wt, bias


def _port(x, wt, bias):
    return (torch.from_numpy(x.transpose(0, 2, 1, 3).copy()),
            torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(bias))


def _nhcw(t):
    return t.detach().permute(0, 2, 1, 3).numpy()


def _xla(x, w, b, stride):
    return _xla_ref(x, w, stride) + b.reshape(1, 1, -1, 1)


@pytest.mark.parametrize("b,cin,cout,h,w,stride", CASES)
def test_forward_matches_pallas_and_xla(b, cin, cout, h, w, stride):
    x, wt, bias = _case(b, cin, cout, h, w)
    got = conv3x3_plain(*_port(x, wt, bias), stride)
    jargs = tuple(map(jnp.asarray, (x, wt, bias)))
    # fp32, 9 * Cin products summed in another order
    for want in (conv3x3_nhcw(*jargs, stride), _xla(*jargs, stride)):
        np.testing.assert_allclose(_nhcw(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("b,cin,cout,h,w,stride", CASES)
def test_gradients_match_pallas_vjp_and_xla(b, cin, cout, h, w, stride):
    x, wt, bias = _case(b, cin, cout, h, w, seed=1)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = np.random.default_rng(2).normal(size=(b, ho, cout, wo)).astype(
        np.float32)
    jargs = tuple(map(jnp.asarray, (x, wt, bias)))
    want = jax.vjp(lambda *a: conv3x3_nhcw(*a, stride), *jargs)[1](
        jnp.asarray(g))
    want_xla = jax.vjp(lambda *a: _xla(*a, stride), *jargs)[1](jnp.asarray(g))
    args = [t.requires_grad_(True) for t in _port(x, wt, bias)]
    y = conv3x3(*args, stride)
    gx, gw, gb = torch.autograd.grad(
        y, args, torch.from_numpy(g.transpose(0, 2, 1, 3).copy()))
    got = (_nhcw(gx), gw.permute(2, 3, 1, 0).numpy(), gb.numpy())
    # fp32 sums over up to B*H*W terms in another order
    for ref in (want, want_xla):
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a, np.asarray(r), rtol=1e-4,
                                       atol=1e-4)


def test_cpu_wrapper_is_the_plain_version():
    x, wt, bias = _port(*_case(2, 4, 8, 8, 8))
    before = conv3x3_kernel.launches
    for stride in (1, 2):
        torch.testing.assert_close(conv3x3_kernel(x, wt, bias, stride),
                                   conv3x3_plain(x, wt, bias, stride),
                                   rtol=0, atol=0)
    assert conv3x3_kernel.launches == before  # no kernel on the CPU


def test_bf16_keeps_the_input_type():
    x, wt, bias = _port(*_case(2, 4, 8, 8, 8))
    y = conv3x3(x.bfloat16(), wt, bias, 2)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 8, 4, 4)
