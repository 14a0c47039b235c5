"""Physique mask generator: the conv encoder/decoder that inflates the
rendered skeleton-line mask into a body silhouette, ported from the JAX
package's models/physique.py (its default NHWC path).

NCHW: the input is (B, 1, S, S) and the output (B, 1, S, S) in fp32 after a
sigmoid (float64 for a float64 net). The input is put in channels-last
memory once, and every activation stays channels-last between layers
(conv, BatchNorm, leaky ReLU, bilinear upsample, and their gradients), so
no layout copy sits between layers and cuDNN and PyTorch's BatchNorm run
their NHWC forms. Every 3x3 conv runs through ops/conv3x3.py (the CUDA
kernels on the card).
Parameters and BatchNorm statistics are fp32; the input is cast to the
working type ``dtype`` and each conv casts its weight to it. BatchNorm
(models/resnet.py:BatchNorm2d) pools its statistics over the whole batch,
all cameras together, as the JAX package does, or with ``bn_groups`` takes
them per camera slice.

Under tensor parallelism (parallel/tp.py) each conv computes its output
channel shard where its width divides the model ranks, and each BatchNorm
gathers the channels: after normalizing its shard (64 and 128 channels),
or before it where it is replicated (32 channels, below tp.MIN_VECTOR).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import channels_last, conv3x3
from .resnet import BatchNorm2d, set_bn_groups, split_input


class _LeakyReLU(torch.autograd.Function):
    """F.leaky_relu forward; the backward steps where the output is >= 0."""

    @staticmethod
    def forward(ctx, x, negative_slope: float):
        y = F.leaky_relu(x, negative_slope)
        ctx.negative_slope = negative_slope
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y >= 0, g, g * ctx.negative_slope), None


def leaky_relu(x, negative_slope: float = 0.01):
    """The JAX package's leaky ReLU, jnp.where(x >= 0, x, slope x): the
    values of F.leaky_relu, and a gradient of 1 at an input of 0, where
    F.leaky_relu's is the slope (the output is >= 0 exactly where the input
    is, so the backward reads the output, which the next conv keeps)."""
    return _LeakyReLU.apply(x, negative_slope)


class Conv3x3(nn.Module):
    """3x3 SAME conv with bias through ops/conv3x3.py; a weight of fewer
    than `cout` output channels is this rank's shard under tensor
    parallelism (models/resnet.py:split_input), and the output is that
    channel shard."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.cout = cout
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        # He-normal, fan-out, as the JAX package's _KAIMING
        nn.init.kaiming_normal_(self.weight, mode="fan_out",
                                nonlinearity="relu")

    def forward(self, x):
        bias = self.bias
        if self.weight.shape[0] != self.cout:
            x, bias = split_input(x, bias, self.weight.shape[0])
        return conv3x3(x, self.weight, bias, self.stride)


def stages(num_features: Sequence[int]) -> list:
    """Encoder: conv -> (conv, stride-2 conv) per scale; decoder mirrors it:
    (conv, 2x upsample, conv). ("conv", cout, stride) or ("up",)."""
    nf = list(num_features)
    ops = [("conv", nf[0], 1)]
    for i in range(1, len(nf)):
        ops += [("conv", nf[i - 1], 1), ("conv", nf[i], 2)]
    for i in range(len(nf) - 1, 0, -1):
        ops += [("conv", nf[i], 1), ("up",), ("conv", nf[i - 1], 1)]
    return ops


class PhysiqueMaskGenerator(nn.Module):
    def __init__(self, num_features: Sequence[int],
                 dtype: torch.dtype = torch.float32, bn_groups: int = 1):
        super().__init__()
        self.dtype = dtype
        self.ops = stages(num_features)
        convs, bns = [], []
        cin = 1
        for op in self.ops:
            if op[0] == "conv":
                convs.append(Conv3x3(cin, op[1], op[2]))
                bns.append(BatchNorm2d(op[1], eps=1e-5, momentum=0.1))
                cin = op[1]
        convs.append(Conv3x3(cin, 1))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        set_bn_groups(self, bn_groups)

    def bn_cancelled_biases(self) -> list[str]:
        """Names of the conv biases that a train-mode BatchNorm follows: its
        mean subtraction cancels them, so their gradient is zero up to
        rounding (and Adam turns that rounding into steps of either sign)."""
        return [f"convs.{i}.bias" for i in range(len(self.bns))]

    def forward(self, x):
        x = channels_last(x.to(self.dtype))
        i = 0
        for op in self.ops:
            if op[0] == "up":
                x = F.interpolate(x, scale_factor=2, mode="bilinear",
                                  align_corners=False)
                continue
            x = leaky_relu(self.bns[i](self.convs[i](x)), 0.01)
            i += 1
        x = self.convs[i](x)
        return torch.sigmoid(x.to(torch.promote_types(x.dtype,
                                                      torch.float32)))
