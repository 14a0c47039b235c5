"""The port's skeleton line renderer (ops/geometry.py:draw_lines) and loss
primitives (ops/losses.py) against the JAX package's, values and gradients,
on the same seeded inputs, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x_as_supervision_tpu.models.composed import cal_links as jax_links
from x_as_supervision_tpu.ops import geometry as JG
from x_as_supervision_tpu.ops import losses as JL
from x_as_supervision_tpu_torch.models.composed import cal_links
from x_as_supervision_tpu_torch.ops import geometry as TG
from x_as_supervision_tpu_torch.ops import losses as TL

PARENTS = [0, 0, 1, 2, 0, 4, 5, 0, 17, 8, 9, 17, 11, 12, 17, 14, 15, 7]


def _grad_pair(jfn, tfn, *arrays, atol=1e-5, rtol=1e-5):
    """Values and gradients of jfn (JAX) and tfn (torch) at the same inputs;
    the cotangent of the output is a fixed random array."""
    jout = jfn(*map(jnp.asarray, arrays))
    r = np.random.default_rng(9).normal(size=np.shape(jout)).astype(
        np.float32)
    want = jax.grad(lambda *a: (jfn(*a) * r).sum(), argnums=tuple(
        range(len(arrays))))(*map(jnp.asarray, arrays))
    targs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    tout = tfn(*targs)
    got = torch.autograd.grad((tout * torch.from_numpy(r)).sum(), targs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=rtol, atol=atol)
    for g, w in zip(got, want):
        scale = max(float(np.abs(np.asarray(w)).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5 * scale)


def test_cal_links_match_jax():
    for ext in (True, False):
        assert cal_links(PARENTS, list(range(17)), extension=ext) == \
            jax_links(PARENTS, list(range(17)), extension=ext)


@pytest.mark.parametrize("lines", [25, 17], ids=["extended", "plain"])
def test_draw_lines_matches_jax(lines):
    """25 lines (the flagship's 17 + 8) render the arm bones 2x sharper;
    17 do not."""
    rp, rc = cal_links(PARENTS, list(range(17)), extension=lines == 25)
    assert len(rp) == lines
    rng = np.random.default_rng(0)
    kps = rng.uniform(-0.8, 0.8, (3, 18, 2)).astype(np.float32)
    kps[0, 3] = kps[0, 2]  # a zero-length bone: the 1e-8 in t's denominator
    body = 3.0e-3 * 10  # wide enough that most pixels carry gradient
    _grad_pair(lambda k: JG.draw_lines(k, 24, rp, rc, body),
               lambda k: TG.draw_lines(k, 24, rp, rc, body), kps)


def test_arm_lines_are_sharper_with_21_or_more_lines():
    rp, rc = cal_links(PARENTS, list(range(17)))
    kps = torch.zeros(1, 18, 2)
    kps[0, :, 0] = torch.linspace(-0.5, 0.5, 18)
    hm = TG.draw_lines(kps, 16, rp, rc, 0.05)
    plain = TG.draw_lines(kps, 16, rp[:20], rc[:20], 0.05)
    torch.testing.assert_close(hm[:, 11], plain[:, 11] ** 2)
    torch.testing.assert_close(hm[:, 10], plain[:, 10])


@pytest.mark.parametrize("use_clip", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_mask_reconstruction_loss_matches_jax(use_clip, weighted):
    rng = np.random.default_rng(1)
    mask = rng.uniform(0, 0.3, (2, 8, 8, 1)).astype(np.float32)
    gt = (rng.uniform(size=(2, 8, 8, 1)) > 0.5).astype(np.float32)
    w = rng.uniform(1, 2, (2, 8, 8, 1)).astype(np.float32)
    if weighted:
        _grad_pair(lambda m, g, ww: JL.compute_mask_reconstruction_loss(
                       m, g, ww, use_clip=use_clip),
                   lambda m, g, ww: TL.compute_mask_reconstruction_loss(
                       m, g, ww, use_clip=use_clip), mask, gt, w)
    else:
        _grad_pair(lambda m, g: JL.compute_mask_reconstruction_loss(
                       m, g, use_clip=use_clip),
                   lambda m, g: TL.compute_mask_reconstruction_loss(
                       m, g, use_clip=use_clip), mask, gt)


def test_symmetry_losses_match_jax():
    kps = np.random.default_rng(2).normal(0, 300, (4, 18, 3)).astype(
        np.float32)
    _grad_pair(JL.compute_bone_sym_loss, TL.compute_bone_sym_loss, kps)
    _grad_pair(JL.compute_kp_sym_loss, TL.compute_kp_sym_loss, kps)
    _grad_pair(lambda k: JL.compute_kp_sym_loss(k[..., :2], is_3d=False),
               lambda k: TL.compute_kp_sym_loss(k[..., :2], is_3d=False), kps)


def test_supervision_loss_matches_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(4, 18, 3)).astype(np.float32) for _ in range(2))
    _grad_pair(JL.compute_supervision, TL.compute_supervision, a, b)


def test_disc_loss_matches_jax_and_splits_ties():
    rng = np.random.default_rng(4)
    pred = rng.normal(size=(4, 3, 1)).astype(np.float32)
    pred[1, 2] = pred[1, 0]  # a tie in the min over hypotheses
    pred[2, :] = 0.25  # a three-way tie
    real = rng.normal(size=(4, 1)).astype(np.float32)
    _grad_pair(lambda p: JL.compute_disc_loss(p, None),
               lambda p: TL.compute_disc_loss(p, None), pred)
    _grad_pair(JL.compute_disc_loss, TL.compute_disc_loss, pred, real)
    p = torch.from_numpy(pred).requires_grad_(True)
    (g,) = torch.autograd.grad(TL.compute_disc_loss(p, None), p)
    # the three tied hypotheses share the gradient evenly
    np.testing.assert_allclose(g[2, :, 0].numpy(),
                               np.full(3, 2 * (0.25 - 1) / 4 / 3), rtol=1e-6)
