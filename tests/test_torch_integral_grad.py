"""Gradients of the port's integral decode (x_as_supervision_tpu_torch/ops/
integral*.py) against the JAX package's: jax.grad of the XLA decode, and the
VJP of the Pallas marginals kernel in interpret mode, on the same seeded
logits. JAX logits are (B, H, W, K*D) and the port's (B, K*D, H, W) with the
same channel index, so gradients are compared after a permute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x_as_supervision_tpu.ops import integral as J
from x_as_supervision_tpu.ops.integral_pallas import marginals_pallas
from x_as_supervision_tpu_torch.ops import integral as T
from x_as_supervision_tpu_torch.ops.integral_kernel import (
    marginals,
    marginals_backward,
    marginals_backward_plain,
)
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

K, D = 3, 8


def _logits(seed=11, b=2, h=8, w=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, K * D)) * 2).astype(np.float32)


def _peaky(seed=3):
    """Joint 1 has one interior depth peak and joint 2 none, so the extra
    hypotheses land on zero-scored slots (see test_torch_integral.py)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 8, 8, K, D)) * 2).astype(np.float32)
    a = rng.normal(size=(2, 8, 8, 1)).astype(np.float32)
    dd = np.arange(D, dtype=np.float32)
    x[..., 1, :] = a - np.abs(dd - 3.0)
    x[..., 2, :] = a + 0.5 * dd
    return x.reshape(2, 8, 8, K * D)


def _port(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _cotangents(seed=5, b=2, h=8, w=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, K, n)).astype(np.float32) for n in (w, h, D)]


def test_marginals_backward_matches_pallas_vjp():
    x = _logits()
    gs = _cotangents()
    _, vjp = jax.vjp(lambda v: marginals_pallas(v, K), jnp.asarray(x))
    (want,) = vjp(tuple(map(jnp.asarray, gs)))
    _, xla_vjp = jax.vjp(lambda v: J.heatmap_marginals(v, K), jnp.asarray(x))
    (want_xla,) = xla_vjp(tuple(map(jnp.asarray, gs)))
    got = marginals_backward_plain(_port(x), *map(torch.from_numpy, gs), K)
    # fp32, the same softmax Jacobian summed in another order
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want_xla), atol=1e-5)


def test_autograd_function_on_cpu_is_the_plain_backward():
    x = _port(_logits()).requires_grad_(True)
    gs = [torch.from_numpy(g) for g in _cotangents()]
    before = marginals_backward.launches
    ax, ay, az, m, z = marginals(x, K)
    assert not m.requires_grad and not z.requires_grad
    (got,) = torch.autograd.grad((ax, ay, az), x, gs)
    want = marginals_backward_plain(x.detach(), *gs, K)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert marginals_backward.launches == before  # no kernel on the CPU


def test_autograd_function_takes_missing_cotangents_as_zero():
    x = _port(_logits()).requires_grad_(True)
    _, _, az, _, _ = marginals(x, K)
    gz = torch.from_numpy(_cotangents()[2])
    (got,) = torch.autograd.grad(az, x, gz)
    zeros = [torch.zeros(2, K, 8), torch.zeros(2, K, 8)]
    want = marginals_backward_plain(x.detach(), *zeros, gz, K)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("logits", [_logits(), _peaky()],
                         ids=["random", "fewer_peaks"])
@pytest.mark.parametrize("multi", [False, True])
def test_decode_gradient_matches_jax(logits, multi):
    rng = np.random.default_rng(7)
    nh = 3 if multi else 1
    r = rng.normal(size=(2, nh, K, 3)).astype(np.float32)

    def jloss(v):
        dec = (J.decode_multi(v, K, num_hypo=3, neighbor_size=3) if multi
               else J.decode_single(v, K))
        return (dec.kps * r).sum() + (dec.depth_prob_map ** 2).sum()

    want = jax.grad(jloss)(jnp.asarray(logits))
    x = _port(logits).requires_grad_(True)
    dec = (T.decode_multi(x, K, num_hypo=3, neighbor_size=3) if multi
           else T.decode_single(x, K))
    loss = (dec.kps * torch.from_numpy(r)).sum() + (dec.depth_prob_map ** 2
                                                    ).sum()
    (got,) = torch.autograd.grad(loss, x)
    # fp32 gradients of O(1e-2): the same chain summed in another order
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)
