"""The decode-forward kernel's launch plan and its split-and-combine, on the
CPU (x_as_supervision_tpu_torch/ops/integral_kernel.py and
csrc/integral_marginals.cu).

- ``marginals_plan``: variant, access width, ring stages, blocks per joint
  (the cluster) and chunks per slice at the serving, training and
  H*W > 4096 shapes.
- ``kernel_model``: the kernel's algorithm in plain torch: per-warp running
  maxima over a block's slices, each slice's partial stored with the max it
  was taken against, per-chunk x/y sums against the block max, and one
  combine of the cluster's blocks. Held against ``marginals_plain`` and the
  JAX package's ``heatmap_marginals`` and ``heatmap_marginals_pallas``
  (interpret mode, as tests/test_torch_integral.py runs it) on seeded numpy
  logits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x_as_supervision_tpu.ops import integral as J
from x_as_supervision_tpu.ops.integral_pallas import heatmap_marginals_pallas
from x_as_supervision_tpu_torch.ops.integral_kernel import (
    BLOCKS_PER_SM,
    THREADS,
    marginals_plain,
    marginals_plan,
)

H100_SMS = 132
NEG = -1e30  # the kernel's running-max start
# fp32 sums of the same exponentials in another order; marginals are <= 1
MARGINAL_ATOL = 1e-6
Z_RTOL = 1e-5


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("shape,dtype,want", [
    # (B, K, D, H, W): variant, bytes per access, ring stages, split,
    # chunks per slice
    ((32, 18, 64, 64, 64), torch.float32, (0, 16, 4, 2, 1)),   # serving
    ((128, 18, 64, 64, 64), torch.bfloat16, (1, 16, 6, 1, 1)),  # training
    ((32, 18, 64, 64, 64), torch.bfloat16, (1, 16, 6, 2, 1)),
    ((128, 18, 64, 64, 64), torch.float32, (0, 16, 4, 1, 1)),
    ((64, 18, 64, 64, 64), torch.bfloat16, (1, 16, 6, 1, 1)),
    ((2, 3, 8, 96, 96), torch.float32, (0, 16, 4, 4, 3)),       # H*W > 4096
    ((1, 2, 4, 68, 100), torch.bfloat16, (2, 8, 6, 4, 2)),      # W % 8 != 0
    ((1, 2, 5, 6, 12), torch.bfloat16, (2, 8, 6, 4, 1)),
    ((1, 2, 1, 4, 8), torch.float32, (0, 16, 4, 1, 1)),         # D = 1
    ((4, 1, 3, 512, 512), torch.bfloat16, (1, 16, 6, 2, 64)),
])
def test_plan_at_the_paths_shapes(shape, dtype, want):
    b, k, d, h, w = shape
    plan = marginals_plan(b, k, d, h, w, dtype, H100_SMS)
    got = (plan.variant, plan.access_bytes, plan.stages, plan.split,
           plan.chunks)
    assert got == want
    assert plan.blocks == b * k * plan.split
    assert plan.split <= d
    # a chunk is 4096 logits, one 64x64 slice
    assert THREADS * plan.vectors * plan.vec == 4096
    # at 16-byte copies, at least 32 KB of logits per block in flight while
    # a slice is computed (P - 1 slices), and three blocks fit an SM
    if plan.access_bytes == 16:
        assert THREADS * plan.vectors * (plan.stages - 1) * 16 >= 32 * 1024
    assert BLOCKS_PER_SM * (plan.smem_bytes + 1024) <= 228 * 1024


def test_plan_fills_the_card_at_the_serving_batch():
    """B = 32 on 132 SMs: split 1 would be 1.5 waves with the last one 45 %
    full; the plan's split leaves the last wave at least 90 % full."""
    plan = marginals_plan(32, 18, 64, 64, 64, torch.float32, H100_SMS)
    resident = H100_SMS * BLOCKS_PER_SM
    assert plan.waves == pytest.approx(576 * plan.split / resident)
    assert plan.waves / np.ceil(plan.waves) >= 0.9
    assert 576 / resident / np.ceil(576 / resident) < 0.9


@pytest.mark.parametrize("shape,dtype", [
    ((1, 1, 4, 4, 6), torch.float32),     # W % 4 != 0
    ((1, 1, 4, 4, 8), torch.float16),     # no fp16 kernel
    ((1, 1, 20000, 8, 8), torch.float32),  # shared memory over 227 KB
])
def test_plan_refuses_what_the_kernel_does_not_take(shape, dtype):
    with pytest.raises(ValueError):
        marginals_plan(*shape, dtype, H100_SMS)


# ------------------------------------------------------------------ model


def _segment(v: torch.Tensor, seg: torch.Tensor, n: int, how: str):
    """Per-segment max or sum over the last axis of (J, P) values."""
    init = float("-inf") if how == "amax" else 0.0
    out = torch.full((v.shape[0], n), init, dtype=v.dtype)
    return out.scatter_reduce(1, seg.expand_as(v), v, how, include_self=True)


def kernel_model(logits: torch.Tensor, k: int, split: int, vec: int,
                 vectors: int, threads: int = THREADS):
    """The forward kernel's split-and-combine in plain torch (fp32), with its
    layout: block r of a joint's cluster takes slices [r*D/split,
    (r+1)*D/split) and walks them in chunks of threads*vectors accesses of
    vec logits; warp w of a chunk holds the accesses of threads 32w..32w+31.
    Returns (ax, ay, az, m, z) as marginals_plain does."""
    b, c, h, w = logits.shape
    d = c // k
    joints = b * k
    x = logits.reshape(joints, d, h * w).float()
    warps = threads // 32
    pos = torch.arange(h * w)
    access = pos // vec
    chunk_of = access // (threads * vectors)
    warp_of = (access % threads) // 32
    col, row = pos % w, pos // w
    blocks = []
    for r in range(split):
        d0, d1 = r * d // split, (r + 1) * d // split
        m = torch.full((joints, warps), NEG)        # each warp's running max
        zs = torch.zeros((joints, warps, d1 - d0))  # slice partials ...
        mz = torch.full((joints, warps, d1 - d0), NEG)  # ... and their max
        mblk = torch.full((joints,), NEG)
        sx, sy = torch.zeros((joints, w)), torch.zeros((joints, h))
        for ci in range(int(chunk_of.max()) + 1):
            p = pos[chunk_of == ci]
            wg = warp_of[p]
            live = torch.zeros(warps, dtype=torch.bool)
            live[wg] = True
            s_acc = torch.zeros((joints, p.numel()))
            for dl in range(d1 - d0):
                v = x[:, d0 + dl, p]
                nm = torch.maximum(m, _segment(v, wg, warps, "amax"))
                s_acc = s_acc * torch.exp(m - nm)[:, wg]
                m = nm
                e = torch.exp(v - m[:, wg])
                s_acc = s_acc + e
                s = _segment(e, wg, warps, "sum")
                upd = zs[:, :, dl] * torch.exp(mz[:, :, dl] - m) + s
                zs[:, live, dl] = upd[:, live]
                mz[:, live, dl] = m[:, live]
            # the chunk's sums against the block's max
            nmb = torch.maximum(mblk, m.amax(dim=1))
            f = torch.exp(mblk - nmb)[:, None]
            sx, sy, mblk = sx * f, sy * f, nmb
            a = s_acc * torch.exp(m - mblk[:, None])[:, wg]
            sx = sx.index_add(1, col[p], a)
            sy = sy.index_add(1, row[p], a)
        zb = (zs * torch.exp(mz - mblk[:, None, None])).sum(dim=1)
        blocks.append((mblk, zb.sum(dim=1), sx, sy, zb))
    # the cluster's one combine
    mj = torch.stack([blk[0] for blk in blocks]).amax(dim=0)
    scale = [torch.exp(blk[0] - mj) for blk in blocks]
    z = sum(blk[1] * f for blk, f in zip(blocks, scale))
    zinv = torch.where(z > 0, 1.0 / z, torch.ones_like(z))[:, None]
    ax = sum(blk[2] * f[:, None] for blk, f in zip(blocks, scale)) * zinv
    ay = sum(blk[3] * f[:, None] for blk, f in zip(blocks, scale)) * zinv
    az = torch.cat([blk[4] * f[:, None] for blk, f in zip(blocks, scale)],
                   dim=1) * zinv
    return (ax.view(b, k, w), ay.view(b, k, h), az.view(b, k, d),
            mj.view(b, k), z.view(b, k))


def _logits(kind: str, b=2, h=8, w=8, k=3, d=8, seed=21) -> np.ndarray:
    """(B, H, W, K*D) seeded logits (the JAX layout), channel k*D + d."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, h, w, k, d)) * 3).astype(np.float32)
    if kind == "tie":
        # the max of every joint twice, in slices 1 and D-2: in different
        # blocks at every split > 1
        x[:, 2, 3, :, 1] = 20.0
        x[:, 5, 1, :, d - 2] = 20.0
    elif kind == "constant":
        x[:] = 0.75
    elif kind == "underflow":
        # slices more than 80 apart: every rescale of an earlier slice's
        # sums by exp(old max - new max) underflows to 0
        x += 110.0 * ((5 * np.arange(d)) % 7).astype(np.float32)
    return x.reshape(b, h, w, k * d)


def _port(x_nhwc: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy()).to(dtype)


# (split, vec, vectors, threads): the kernel's layout on the card at these
# small shapes, and smaller blocks that give several warps and chunks
_LAYOUTS = [(4, 4, 4, THREADS), (2, 4, 1, 32), (4, 8, 1, 64), (1, 4, 2, 32),
            (3, 4, 1, 64)]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["random", "tie", "constant", "underflow"])
def test_kernel_model_matches_plain_and_jax(kind, bf16):
    x = _logits(kind)
    if bf16:
        # the same bf16 values in both frameworks; both upcast to fp32
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    dtype = torch.bfloat16 if bf16 else torch.float32
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    ref = J.heatmap_marginals(jx, 3)
    pal = heatmap_marginals_pallas(jx, 3)
    port = _port(x, dtype)
    plain = marginals_plain(port, 3)
    want_m = x.reshape(2, 8, 8, 3, 8).max(axis=(1, 2, 4))
    for split, vec, vectors, threads in _LAYOUTS:
        got = kernel_model(port, 3, split, vec, vectors, threads)
        for g, p, r, pr in zip(got[:3], plain[:3], ref, pal):
            np.testing.assert_allclose(g.numpy(), p.numpy(),
                                       atol=MARGINAL_ATOL, rtol=0)
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       atol=MARGINAL_ATOL, rtol=0)
            np.testing.assert_allclose(g.numpy(), np.asarray(pr),
                                       atol=MARGINAL_ATOL, rtol=0)
        np.testing.assert_array_equal(got[3].numpy(), want_m)  # exact
        np.testing.assert_array_equal(got[3].numpy(), plain[3].numpy())
        np.testing.assert_allclose(got[4].numpy(), plain[4].numpy(),
                                   rtol=Z_RTOL, atol=0)


@pytest.mark.parametrize("shape,dtype", [
    ((1, 2, 4, 68, 100), torch.bfloat16),  # 8-byte reads, two chunks
    ((2, 3, 8, 96, 96), torch.float32),     # three chunks, the last partial
    ((1, 2, 5, 6, 12), torch.bfloat16),     # 18 accesses: one live warp
])
def test_kernel_model_at_the_plans_layout(shape, dtype):
    """The model with the layout the plan gives the card at shapes past one
    chunk per slice, and with most warps idle, against the plain version."""
    b, k, d, h, w = shape
    plan = marginals_plan(b, k, d, h, w, dtype, H100_SMS)
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(size=(b, k * d, h, w)) * 3).astype(
        np.float32)).to(dtype)
    got = kernel_model(x, k, plan.split, plan.vec, plan.vectors)
    want = marginals_plain(x, k)
    for g, r in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, r, atol=MARGINAL_ATOL, rtol=0)
    torch.testing.assert_close(got[3], want[3], atol=0, rtol=0)
    torch.testing.assert_close(got[4], want[4], atol=0, rtol=Z_RTOL)
