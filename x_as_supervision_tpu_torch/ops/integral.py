"""Integral (soft-argmax) heatmap decoding, single- and multi-hypothesis.

The port of the JAX package's ops/integral.py. The detector head emits
(B, K*D, H, W) logits (channel k*D + d); decoding is a softmax over each
joint's (D, H, W) volume, marginalization onto each axis, and either a plain
expectation (single hypothesis) or 1-D peak finding plus a windowed
expectation on the depth marginal (multi-hypothesis).

The marginals come from ops/integral_kernel.py: the CUDA kernels (forward
and backward) for a CUDA tensor, their plain versions for a CPU tensor.
Everything here is differentiable; the peak indices carry no gradient, the
gather of the window sums at them does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .integral_kernel import marginals


class IntegralDecode(NamedTuple):
    kps: torch.Tensor  # (B, num_hypo, K, 3) in [-1, 1]
    depth_prob_map: torch.Tensor  # (K, D) z-marginal of batch element 0


def heatmap_marginals(logits: torch.Tensor, num_joints: int):
    """(B, K*D, H, W) logits -> normalized softmax marginals accu_x (B, K, W),
    accu_y (B, K, H), accu_z (B, K, D), in fp32."""
    ax, ay, az, _, _ = marginals(logits, num_joints)
    return ax, ay, az


def _expectation(marginal: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(marginal.shape[-1], dtype=marginal.dtype,
                       device=marginal.device)
    return (marginal * idx).sum(dim=-1)


def decode_single(logits: torch.Tensor, num_joints: int) -> IntegralDecode:
    """Single-hypothesis integral decode -> kps (B, 1, K, 3) in [-1, 1].

    x is normalized by H and y by W, as in the JAX package and its
    reference (the same when H == W, which every shipped config has)."""
    accu_x, accu_y, accu_z = heatmap_marginals(logits, num_joints)
    h, w = logits.shape[2], logits.shape[3]
    d = logits.shape[1] // num_joints
    x = _expectation(accu_x) / h * 2.0 - 1.0
    y = _expectation(accu_y) / w * 2.0 - 1.0
    z = _expectation(accu_z) / d * 2.0 - 1.0
    kps = torch.stack([x, y, z], dim=-1)[:, None]
    return IntegralDecode(kps, accu_z[0])


def find_peaks(marginal: torch.Tensor, num_hypo: int) -> torch.Tensor:
    """Indices of the top-`num_hypo` 1-D local maxima of (B, K, D) marginals.

    A position i in [1, D-2] is a peak when m[i] >= m[i-1] and
    m[i] >= m[i+1]; peaks are ranked by their marginal mass. Ties rank the
    lower index first, as ``lax.top_k`` does (``torch.topk`` does not), so
    the zero-scored slots of a joint with fewer than `num_hypo` peaks match
    the JAX package: a stable descending sort, first `num_hypo` kept.
    """
    inner = marginal[..., 1:-1]
    is_peak = (inner >= marginal[..., :-2]) & (inner >= marginal[..., 2:])
    scores = torch.where(is_peak, inner, torch.zeros_like(inner))
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :num_hypo] + 1


def _window_sums(x: torch.Tensor, window: int) -> torch.Tensor:
    """Sliding-window sums along the last axis of (B, K, D) with zero
    padding of window//2 on both sides. Plain fp32 sums: a conv1d with ones
    would run in TF32 through cuDNN on the card."""
    pad = window // 2
    return F.pad(x, (pad, pad)).unfold(-1, window, 1).sum(dim=-1)


def decode_multi(logits: torch.Tensor, num_joints: int, num_hypo: int,
                 neighbor_size: int) -> IntegralDecode:
    """Multi-hypothesis decode: shared x/y expectations, per-peak windowed
    z expectations -> kps (B, num_hypo, K, 3), hypothesis 0 the most
    confident peak."""
    accu_x, accu_y, accu_z = heatmap_marginals(logits, num_joints)
    h, w = logits.shape[2], logits.shape[3]
    d = logits.shape[1] // num_joints

    x = _expectation(accu_x) / h * 2.0 - 1.0  # (B, K)
    y = _expectation(accu_y) / w * 2.0 - 1.0

    peak_idx = find_peaks(accu_z, num_hypo)  # (B, K, num_hypo)
    idx = torch.arange(d, dtype=accu_z.dtype, device=accu_z.device)
    num = _window_sums(accu_z * idx, neighbor_size)
    den = _window_sums(accu_z, neighbor_size)
    z = num.gather(-1, peak_idx) / den.gather(-1, peak_idx)  # (B, K, hypo)
    z = z / d * 2.0 - 1.0

    b = x.shape[0]
    xy = torch.stack([x, y], dim=-1)[:, None].expand(b, num_hypo,
                                                      num_joints, 2)
    kps = torch.cat([xy, z.permute(0, 2, 1)[..., None]], dim=-1)
    return IntegralDecode(kps, accu_z[0])
