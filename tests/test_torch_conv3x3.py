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
    CC,
    TC,
    THIN,
    conv3x3,
    conv3x3_kernel,
    conv3x3_path,
    conv3x3_plain,
)
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

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


# the shapes of the card's thin kernel (1->32, 32->1) and of a
# tensor-parallel rank's shards (16->32, 32->16), each at both strides and
# the two strides in both types, B = 1 and 2, odd sides at stride 1 (the
# JAX kernel folds 2x2 at stride 2, so even sides there; the card tests and
# chip_smoke.py's phase 3 take odd sides at stride 2); one Pallas call in
# interpret mode costs seconds, so each shape and stride once
SLICE_CASES = [
    (1, 1, 32, 9, 11, 1, "float32"), (2, 1, 32, 10, 12, 2, "bfloat16"),
    (1, 32, 1, 11, 9, 1, "bfloat16"), (2, 32, 1, 8, 14, 2, "float32"),
    (2, 16, 32, 7, 13, 1, "bfloat16"), (1, 16, 32, 12, 10, 2, "float32"),
    (2, 32, 16, 13, 7, 1, "float32"), (1, 32, 16, 10, 8, 2, "bfloat16"),
]


@pytest.mark.parametrize("b,cin,cout,h,w,stride,dtype", SLICE_CASES)
def test_slice_shapes_match_pallas_forward_and_vjp(dtype, b, cin, cout, h,
                                                   w, stride):
    """Forward and gradients of conv3x3 (its CPU path) against the Pallas
    conv and its custom VJP in interpret mode, x and g in `dtype`, the
    weights and bias fp32 on both sides (each casts w to x's type)."""
    x, wt, bias = _case(b, cin, cout, h, w, seed=3)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = np.random.default_rng(4).normal(size=(b, ho, cout, wo)).astype(
        np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    want_y, vjp = jax.vjp(lambda *a: conv3x3_nhcw(*a, stride), jx,
                          jnp.asarray(wt), jnp.asarray(bias))
    want = (want_y,) + vjp(jg)
    tx, tw, tb = _port(x, wt, bias)
    args = [tx.to(tdt).requires_grad_(True), tw.requires_grad_(True),
            tb.requires_grad_(True)]
    y = conv3x3(*args, stride)
    assert y.dtype == tdt
    got = (y,) + torch.autograd.grad(
        y, args, torch.from_numpy(g.transpose(0, 2, 1, 3).copy()).to(tdt))
    got = [_nhcw(got[0].float()), _nhcw(got[1].float()),
           got[2].permute(2, 3, 1, 0).numpy(), got[3].numpy()]
    for i, (a, r) in enumerate(zip(got, want)):
        r = np.asarray(r.astype(jnp.float32))
        if dtype == "float32":
            # fp32: the file's tolerances (9 * Cin products forward, up to
            # B*H*W terms in the gradients, summed in other orders)
            tol = (1e-5, 1e-5) if i == 0 else (1e-4, 1e-4)
            np.testing.assert_allclose(a, r, rtol=tol[0], atol=tol[1])
        else:
            # bf16: y, dx and dw are fp32 sums of the same bf16 products
            # rounded to bf16 on both sides, one step (2^-8) apart at most;
            # db is an fp32 sum of bf16 g on both sides
            tol = 2 ** -7 if i < 3 else 1e-5
            np.testing.assert_allclose(a, r, rtol=0,
                                       atol=tol * np.abs(r).max())


def test_slice_shapes_take_their_kernels():
    """On the card the slice's shapes run the thin kernel (one side 1) and
    the tensor cores' 16-channel instance (bf16 shards), the FMA kernel in
    fp32; the stride-1 input gradient takes the swapped shape's path."""
    for b, cin, cout, h, w, stride, _ in SLICE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            want = (THIN if 1 in (cin, cout) else
                    TC if dtype == torch.bfloat16 else CC)
            assert conv3x3_path(dtype, cin, cout) == want
            assert conv3x3_path(dtype, cout, cin) == want


def test_cpu_wrapper_is_the_plain_version():
    x, wt, bias = _port(*_case(2, 4, 8, 8, 8))
    counters = ("launches", "launches_tc", "launches_thin",
                "launches_cuda_core")
    before = [getattr(conv3x3_kernel, c) for c in counters]
    for stride in (1, 2):
        torch.testing.assert_close(conv3x3_kernel(x, wt, bias, stride),
                                   conv3x3_plain(x, wt, bias, stride),
                                   rtol=0, atol=0)
        # the input gradient's launch carries no bias
        torch.testing.assert_close(conv3x3_kernel(x, wt, None, stride),
                                   conv3x3_plain(x, wt, None, stride),
                                   rtol=0, atol=0)
    # no kernel on the CPU
    assert [getattr(conv3x3_kernel, c) for c in counters] == before


def test_bf16_keeps_the_input_type():
    x, wt, bias = _port(*_case(2, 4, 8, 8, 8))
    y = conv3x3(x.bfloat16(), wt, bias, 2)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 8, 4, 4)
