"""Weights made from the run's seed, on the device, by the benchmark.

Every convolution takes He-normal weights (fan-out), every linear layer
LeCun-normal ones (standard deviation fan_in^-1/2), biases zero, norms one
and zero. The last BatchNorm scale of each residual branch is 0.1, so that
50 layers of random weights stay well conditioned (a small residual scale,
as in Goyal et al. 2017). All normal draws come from one call of a
``torch.Generator`` on the card. ``condition_running_stats`` gives the
BatchNorms of an eval forward the batch statistics of one training forward.

The head's output bias carries a depth prior: on every joint's depth
axis three bumps of distinct heights (``DEPTH_PEAKS``). Random weights
alone give each joint a flat depth marginal, whose local maxima and three
hypotheses tie to rounding, so that a bfloat16 and a float32 run of the
same step pick different hypotheses, and the gradient of a minimum over
them jumps. With the prior the three hypotheses are distinct, as a
trained detector's are.

The modules are the reference's (reference/gan.py), whose parameter names
are the program's: the state dicts load into either.
"""

from __future__ import annotations

import math

import torch

from reference import gan as R

BRANCH_GAMMA = 0.1
# the head's depth prior: logit bumps at these shares of the depth axis,
# of these heights and of this width (a share of the depth bins)
DEPTH_PEAKS = ((0.25, 4.0), (0.5, 3.0), (0.75, 2.0))
DEPTH_PEAK_WIDTH = 1 / 32


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` for stream `stream` of the run's seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def _fill(module: torch.nn.Module, seed: int) -> None:
    normal, zeros, ones = [], [], []
    for m in module.modules():
        if isinstance(m, (R.Conv, R.Deconv, R.Conv3x3)):
            fan_out = m.weight.shape[0] * math.prod(m.weight.shape[2:])
            normal.append((m.weight, math.sqrt(2.0 / fan_out)))
        elif isinstance(m, R.Linear):
            normal.append((m.weight, m.weight.shape[1] ** -0.5))
        elif isinstance(m, (R.BN, R.GraphNorm)):
            ones.append(m.weight)
            zeros.append(m.bias)
            if isinstance(m, R.BN):
                zeros.append(m.running_mean)
                ones.append(m.running_var)
                zeros.append(m.num_batches_tracked)
            continue
        if getattr(m, "bias", None) is not None and isinstance(
                m.bias, torch.nn.Parameter):
            zeros.append(m.bias)
    total = sum(p.numel() for p, _ in normal)
    device = normal[0][0].device
    draw = torch.randn(total, generator=generator(seed, device, 1 << 20),
                       device=device)
    with torch.no_grad():
        at = 0
        for p, std in normal:
            n = p.numel()
            p.copy_(draw[at:at + n].view_as(p)).mul_(std)
            at += n
        for t in zeros:
            t.zero_()
        for t in ones:
            t.fill_(1)
        for m in module.modules():
            if isinstance(m, R.Bottleneck):
                m.bn3.weight.fill_(BRANCH_GAMMA)
            elif isinstance(m, R.BasicBlock):
                m.bn2.weight.fill_(BRANCH_GAMMA)
            elif isinstance(m, R.Detector):
                m.net.head.features[-1].bias.view(m.k, m.d).copy_(
                    depth_prior(m.d, device))


def depth_prior(d: int, device) -> torch.Tensor:
    """(d,) logits: the sum of DEPTH_PEAKS' Gaussian bumps, each centred
    on a bin, so that no two bins tie at a peak."""
    x = torch.arange(d, dtype=torch.float32, device=device)
    out = torch.zeros(d, device=device)
    for at, height in DEPTH_PEAKS:
        centre = round(at * (d - 1))
        out += height * torch.exp(-0.5 * ((x - centre)
                                          / (DEPTH_PEAK_WIDTH * d)) ** 2)
    return out


def reference_gan(config: dict, seed: int, device) -> R.Gan:
    """The reference GAN of `config` in float32 on `device`, with the
    seed's weights."""
    with torch.device(device):
        gan = R.Gan(config)
    gan = gan.to(device)
    _fill(gan, seed)
    return gan


@torch.no_grad()
def condition_running_stats(det: R.Detector, images: torch.Tensor) -> None:
    """Every BatchNorm's running statistics become the batch statistics of
    one training forward over `images` (N, 3, S, S)."""
    bns = [m for m in det.modules() if isinstance(m, R.BN)]
    for bn in bns:
        bn.record = True
    det.train()
    try:
        x = images
        for stage in det.net.backbone.stages():
            x = stage(x)
        det.net.head(x)
    finally:
        for bn in bns:
            bn.record = False
        det.eval()
