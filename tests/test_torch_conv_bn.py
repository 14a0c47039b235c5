"""The port's fused BN->ReLU->conv3x3->stats link
(x_as_supervision_tpu_torch/ops/conv_bn.py) against the JAX package's Pallas
kernel (interpret mode) and its XLA chain, on the same seeded inputs.

JAX is NHWC with HWIO weights; the port is NCHW with OIHW weights, so the
port gets the same arrays permuted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x_as_supervision_tpu.ops import conv_bn_pallas as J
from x_as_supervision_tpu_torch.ops.conv_bn import (
    bn_relu_conv_plain,
    fused_bn_relu_conv,
    make_stats_fold,
)
from torch_parity import few_torch_threads  # noqa: F401 (autouse)


def _case(b, h, w, c, co, seed=0, shift_mean=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, c, co)) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = (shift_mean + rng.normal(size=c) * 0.1).astype(np.float32)
    return x, wt, scale, shift


def _port_args(x, wt, scale, shift, dtype=torch.float32):
    return (torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype),
            torch.from_numpy(wt.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(scale), torch.from_numpy(shift))


def _nhwc(y: torch.Tensor) -> np.ndarray:
    return y.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize(
    "b,h,w,c,co,shift_mean",
    [
        (2, 8, 8, 128, 128, 0.0),   # stage-4-like
        (3, 8, 16, 128, 128, 0.0),  # non-square, odd batch
        (1, 8, 8, 128, 256, 0.0),   # widening link
        # shift > 0 everywhere: relu(shift) > 0, so a halo of relu(shift)
        # instead of zero would change every border pixel
        (2, 6, 6, 128, 128, 2.0),
    ],
)
def test_plain_link_matches_pallas_and_xla(b, h, w, c, co, shift_mean):
    x, wt, scale, shift = _case(b, h, w, c, co, shift_mean=shift_mean)
    y, stats = bn_relu_conv_plain(*_port_args(x, wt, scale, shift))
    jargs = tuple(map(jnp.asarray, (x, wt, scale, shift)))
    # fp32: one conv summed in another order (the JAX package's own kernel
    # test holds the Pallas kernel to XLA at the same tolerances)
    for ref_y, ref_s in (J.fused_bn_relu_conv(*jargs),
                         J.xla_bn_relu_conv(*jargs)):
        np.testing.assert_allclose(_nhwc(y), np.asarray(ref_y),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(stats.numpy(), np.asarray(ref_s),
                                   rtol=1e-4, atol=1e-2)


def test_zero_halo_is_after_activation():
    x, wt, scale, shift = _case(1, 4, 4, 32, 64, shift_mean=2.0)
    tx, tw, ts, tsh = _port_args(x, wt, scale, shift)
    y, _ = bn_relu_conv_plain(tx, tw, ts, tsh)
    a = torch.relu(tx * ts.view(1, -1, 1, 1) + tsh.view(1, -1, 1, 1))
    a = torch.nn.functional.pad(a, (1, 1, 1, 1))  # zeros after activation
    want = torch.nn.functional.conv2d(a, tw)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def test_bf16_link_matches_pallas():
    x, wt, scale, shift = _case(2, 8, 8, 128, 128)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    y, stats = bn_relu_conv_plain(
        *_port_args(xb, wt, scale, shift, torch.bfloat16))
    assert y.dtype == torch.bfloat16
    ref_y, ref_s = J.fused_bn_relu_conv(
        jnp.asarray(xb, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16),
        jnp.asarray(scale), jnp.asarray(shift))
    # both round the activation and w to bf16 and accumulate in fp32; y is
    # then rounded to bf16, where a different summation order can move it
    # by one bf16 step (2^-8 relative)
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref_y, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(stats.numpy(), np.asarray(ref_s),
                               rtol=1e-4, atol=1e-2)


def test_cpu_wrapper_is_the_plain_version():
    args = _port_args(*_case(1, 4, 4, 32, 64))
    before = fused_bn_relu_conv.launches
    for got, want in zip(fused_bn_relu_conv(*args),
                         bn_relu_conv_plain(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fused_bn_relu_conv.launches == before  # no kernel on the CPU


def test_make_stats_fold_matches_jax():
    rng = np.random.default_rng(2)
    n = 64
    y = rng.normal(1.0, 2.0, size=(n, 16)).astype(np.float32)
    y[:, 3] = 7.0  # constant channel: one-pass variance may cancel below 0
    stats = np.stack([y.sum(0), (y * y).sum(0)])
    gamma = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    beta = rng.normal(size=16).astype(np.float32)
    got = make_stats_fold(*map(torch.from_numpy, (stats, gamma, beta)), n)
    want = J.make_stats_fold(*map(jnp.asarray, (stats, gamma, beta)), n)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)
