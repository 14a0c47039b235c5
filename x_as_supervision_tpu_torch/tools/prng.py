"""The random stream of the JAX package's offline tools, drawn in numpy.

The campaign renderer draws its SMPL poses from a threefry key
(``PRNGKey(seed)`` -> ``split`` -> ``uniform`` / ``normal``). This module is
the port's copy of those draws, so the port renders the same campaign from
the same ``--seed``: threefry-2x32 with 20 rounds over the partitionable
counter layout (a 64-bit iota split into high and low words), 32-bit draws
as the xor of the two output words, uniforms from the top 23 bits as the
mantissa of a float in [1, 2), normals as sqrt(2) erfinv(u) through the
single-precision erfinv polynomial of XLA (M. Giles' approximation). split
and uniform are bit-exact; normal is within a few ulp (XLA's log1p rounds
differently now and then).

The hash works on uint32 arrays, which wrap and never widen or warn.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's single-precision erfinv: coefficients for w = -log1p(-x^2) below 5
# (shifted by 2.5) and at or above it (sqrt(w) shifted by 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _u32(x) -> np.ndarray:
    return np.asarray(x, np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The threefry-2x32 hash of the counter pairs (x0, x1) under `key`
    (two uint32 words): two uint32 arrays of x0's shape."""
    k0, k1 = (_u32(k).reshape(1) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x0 = _u32(x0).reshape(-1) + ks[0]
    x1 = _u32(x1).reshape(-1) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(shape) -> tuple[np.ndarray, np.ndarray]:
    """The high and low words of a 64-bit iota of `shape`, flattened."""
    n = math.prod(shape)
    iota = np.arange(n, dtype=np.uint64)
    return ((iota >> np.uint64(32)).astype(np.uint32),
            (iota & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def prng_key(seed: int) -> np.ndarray:
    """The key of ``jax.random.PRNGKey(seed)`` in JAX's default 32-bit mode:
    a zero high word and the seed's low 32 bits (two's complement)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    hi, lo = _counters((num,))
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape=()) -> np.ndarray:
    """32 random bits per element of `shape`, as uint32."""
    shape = tuple(shape)
    hi, lo = _counters(shape)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key: np.ndarray, shape=(), minval=0.0,
            maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: [minval, maxval). The scale and
    shift is one fused multiply-add, as XLA's CPU code computes it (a
    float64 product and sum, rounded once)."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's single-precision erfinv polynomial (float32 in and out), its
    multiply-adds fused as XLA's CPU code fuses them (a float64 product and
    sum, rounded once), its log1p taken in float64."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float64)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
    for lt5, ge5 in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(lt5), np.float32(ge5))
        p = (c.astype(np.float64) + p.astype(np.float64) * w).astype(
            np.float32)
    out = p * x
    return np.where(np.abs(x) == np.float32(1.0),
                    x * np.float32(np.finfo(np.float32).max),
                    out).astype(np.float32)


def normal(key: np.ndarray, shape=()) -> np.ndarray:
    """``jax.random.normal`` in float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(math.sqrt(2)) * erfinv(u)).astype(np.float32)


def rule_draws_from_key(key: np.ndarray, batch: int,
                        gen_negative: bool = False) -> dict:
    """The draws the JAX package's ``rule_transformation(key, batch)``
    makes, as the dict ``ops.geometry.rule_transformation_from`` takes
    (float32 tensors on the CPU): one key per range and one for the betas
    (the last), each split into its ignore, sign and normal keys.
    `gen_negative` picks nothing here (both range sets have one key per
    range, so their draws are the same); it is taken for symmetry with
    rule_transformation_from."""
    import torch

    from ..ops.geometry import NUM_BETAS, RULE_RANGES

    del gen_negative
    n = len(RULE_RANGES) + 1
    u_ignore, u_sign, normals = [], [], []
    for i, k in enumerate(split(key, n)):
        k_ig, k_sign, k_n = split(k, 3)
        u_sign.append(uniform(k_sign))
        normals.append(normal(k_n, (batch, NUM_BETAS) if i == n - 1
                              else (batch,)))
        u_ignore.append(uniform(k_ig))
    return dict(u_ignore=torch.from_numpy(np.stack(u_ignore)),
                u_sign=torch.from_numpy(np.stack(u_sign)),
                normal=torch.from_numpy(np.stack(normals[:-1])),
                beta_normal=torch.from_numpy(normals[-1]))
