"""The port's integral decode (x_as_supervision_tpu_torch/ops/integral*.py)
against the JAX package's, on the same seeded logits.

JAX logits are (B, H, W, K*D) and the port's (B, K*D, H, W) with the same
channel index k*D + d, so the port gets the JAX input permuted. The Pallas
kernel runs in interpret mode, as the JAX package's own tests run it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x_as_supervision_tpu.ops import integral as J
from x_as_supervision_tpu.ops.integral_pallas import heatmap_marginals_pallas
from x_as_supervision_tpu_torch.ops import integral as T
from x_as_supervision_tpu_torch.ops.integral_kernel import (
    integral_marginals,
    marginals_plain,
)
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

# fp32 throughout: the same math, summed in another order
MARGINAL_ATOL = 1e-6
KPS_ATOL = 1e-5


def _logits(b=2, h=8, w=8, k=3, d=8, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, k * d)) * 2).astype(np.float32)


def _port(x_nhwc: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy()).to(dtype)


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_marginals_match_jax_and_pallas(bf16):
    x = _logits()
    if bf16:
        # the same bf16 values in both frameworks; both upcast to fp32
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    ref = J.heatmap_marginals(jx, 3)
    pal = heatmap_marginals_pallas(jx, 3)
    ax, ay, az, m, z = marginals_plain(
        _port(x, torch.bfloat16 if bf16 else torch.float32), 3)
    for got, want, pwant in zip((ax, ay, az), ref, pal):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MARGINAL_ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(pwant),
                                   atol=MARGINAL_ATOL)
    vol = x.reshape(2, 8, 8, 3, 8)
    np.testing.assert_array_equal(m.numpy(), vol.max(axis=(1, 2, 4)))
    np.testing.assert_allclose(
        z.numpy(),
        np.exp(vol - vol.max(axis=(1, 2, 4), keepdims=True)).sum(
            axis=(1, 2, 4)),
        rtol=1e-5,
    )


def test_cpu_wrapper_is_the_plain_version():
    x = _port(_logits())
    before = integral_marginals.launches
    for got, want in zip(integral_marginals(x, 3), marginals_plain(x, 3)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert integral_marginals.launches == before  # no kernel on the CPU


def _peaky_logits(seed=3):
    """(B, H, W, K*D) logits, D = 8: joint 0 random (several depth peaks),
    joint 1 one interior depth peak, joint 2 a rising depth profile (no
    peak). Joints 1-2 are separable, a(h, w) + p(d), so their depth
    marginal is exp(p) normalized: fewer peaks than hypotheses."""
    rng = np.random.default_rng(seed)
    b, h, w, d = 2, 8, 8, 8
    x = (rng.normal(size=(b, h, w, 3, d)) * 2).astype(np.float32)
    a = rng.normal(size=(b, h, w, 1)).astype(np.float32)
    dd = np.arange(d, dtype=np.float32)
    x[..., 1, :] = a - np.abs(dd - 3.0)
    x[..., 2, :] = a + 0.5 * dd
    return x.reshape(b, h, w, 3 * d)


@pytest.mark.parametrize("logits", [_logits(), _peaky_logits()],
                         ids=["random", "fewer_peaks"])
def test_decode_matches_jax(logits):
    single = T.decode_single(_port(logits), 3)
    jsingle = J.decode_single(jnp.asarray(logits), 3)
    np.testing.assert_allclose(single.kps.numpy(), np.asarray(jsingle.kps),
                               atol=KPS_ATOL)
    multi = T.decode_multi(_port(logits), 3, num_hypo=3, neighbor_size=3)
    jmulti = J.decode_multi(jnp.asarray(logits), 3, num_hypo=3,
                            neighbor_size=3)
    assert multi.kps.shape == (2, 3, 3, 3)
    np.testing.assert_allclose(multi.kps.numpy(), np.asarray(jmulti.kps),
                               atol=KPS_ATOL)
    np.testing.assert_allclose(multi.depth_prob_map.numpy(),
                               np.asarray(jmulti.depth_prob_map),
                               atol=MARGINAL_ATOL)


def test_find_peaks_tie_order_matches_lax_top_k():
    """One peak at index 6 of 16 (inner index 5 of 14): the two zero-scored
    slots rank the lowest indices first, as lax.top_k ranks them."""
    marg = np.zeros((1, 2, 16), np.float32)
    marg[0, 0, 6] = 1.0
    marg[0, 1] = 0.25  # flat: every inner position is a tied peak
    got = T.find_peaks(torch.from_numpy(marg), 3).numpy()
    want = np.asarray(J.find_peaks(jnp.asarray(marg), 3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], [6, 1, 2])
    np.testing.assert_array_equal(got[0, 1], [1, 2, 3])


@pytest.mark.parametrize("window", [3, 15])
def test_window_sums_match_jax(window):
    x = np.random.default_rng(5).uniform(size=(2, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        T._window_sums(torch.from_numpy(x), window).numpy(),
        np.asarray(J._window_sums(jnp.asarray(x), window)), atol=1e-6,
    )
