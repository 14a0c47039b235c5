"""The port's numpy copy of JAX's threefry stream
(x_as_supervision_tpu_torch/tools/prng.py) against jax.random, and the
campaign renderer's pose draws (rule prior from a key) against the JAX
package's: split and uniform bit-equal, normal within 4 ulp (XLA's log1p
rounds differently now and then), the rule prior's zero pattern identical
and its values within 1e-6.
"""

import warnings

import jax
import numpy as np
import pytest

from test_torch_geometry_rest import jax_rule_draws
from x_as_supervision_tpu.ops import geometry as JG
from x_as_supervision_tpu.tools import render_campaign as JR
from x_as_supervision_tpu_torch.ops import geometry as G
from x_as_supervision_tpu_torch.tools import prng
from x_as_supervision_tpu_torch.tools import render_campaign as R
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

SEEDS = (0, 1, 7, 9973 * 64 + 3, 70001, 2**31 - 1)
SHAPES = ((), (7,), (64,), (64, 10))


def _ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance of two float32 arrays in units in the last place."""
    def ordered(x):
        i = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("seed", SEEDS + (-5, 2**33 + 3))
def test_key_and_split_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    k = prng.prng_key(seed)
    np.testing.assert_array_equal(k, np.asarray(jax.random.key_data(key)))
    for n in (2, 3, 74):
        np.testing.assert_array_equal(prng.split(k, n),
                                      np.asarray(jax.random.split(key, n)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uniform_bit_equal(seed, shape):
    key = jax.random.PRNGKey(seed)
    k = prng.prng_key(seed)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no numpy overflow warnings
        got = prng.uniform(k, shape)
        got_range = prng.uniform(k, shape, -2.5, 3.0)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, np.asarray(jax.random.uniform(key,
                                                                     shape)))
    np.testing.assert_array_equal(
        got_range, np.asarray(jax.random.uniform(key, shape, minval=-2.5,
                                                 maxval=3.0)))


def test_normal_within_4_ulp():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.normal(key, (100_000,)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = prng.normal(prng.prng_key(3), (100_000,))
    assert got.dtype == np.float32
    ulp = _ulp(got, want)
    # measured: 99.0 % bit-equal, at most 3 ulp
    assert (ulp == 0).mean() >= 0.90, (ulp == 0).mean()
    assert ulp.max() <= 4, ulp.max()


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_normal_shapes(shape):
    key = jax.random.PRNGKey(11)
    got = prng.normal(prng.prng_key(11), shape)
    assert got.shape == shape
    assert _ulp(got, np.asarray(jax.random.normal(key, shape))).max() <= 4


@pytest.mark.parametrize("seed", (0, 5, 9973 * 64))
def test_rule_draws_match_jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    want = jax_rule_draws(key, 64)
    got = prng.rule_draws_from_key(prng.prng_key(seed), 64)
    assert got.keys() == want.keys()
    for name in ("u_ignore", "u_sign"):
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy())
    for name in ("normal", "beta_normal"):
        assert got[name].shape == want[name].shape
        assert _ulp(got[name].numpy(), want[name].numpy()).max() <= 4


@pytest.mark.parametrize("gen_negative", [False, True])
@pytest.mark.parametrize("seed", (0, 293, 70001 + 131))
def test_rule_prior_from_key_matches_jax(seed, gen_negative):
    want_pose, want_beta = (np.asarray(v) for v in JG.rule_transformation(
        jax.random.PRNGKey(seed), 64, gen_negative))
    pose, beta = (v.numpy() for v in G.rule_transformation_from(
        prng.rule_draws_from_key(prng.prng_key(seed), 64, gen_negative),
        gen_negative))
    assert pose.shape == (64, 72) and beta.shape == (64, 10)
    # the ignored and degenerate entries: the same zeros
    np.testing.assert_array_equal(pose == 0, want_pose == 0)
    assert (pose == 0).any() and (pose != 0).any()
    np.testing.assert_allclose(pose, want_pose, rtol=0, atol=1e-6)
    np.testing.assert_allclose(beta, want_beta, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", (0, 3))
def test_sample_poses_matches_jax(seed):
    # 70 poses: two batches of 64, the second truncated
    want_pose, want_beta = JR._sample_poses(70, seed)
    pose, beta = R._sample_poses(70, seed)
    assert pose.dtype == beta.dtype == np.float32
    assert pose.shape == (70, 72) and beta.shape == (70, 10)
    np.testing.assert_array_equal(pose == 0, want_pose == 0)
    np.testing.assert_allclose(pose, want_pose, rtol=0, atol=1e-6)
    np.testing.assert_allclose(beta, want_beta, rtol=0, atol=1e-6)
