"""ResNet backbone + deconvolution head of the integral pose detector,
ported from the JAX package's models/resnet.py for eval-mode serving.

Parameter names follow torchvision's ResNet (conv1, bn1, layer1.0.conv1, ...,
layer1.0.downsample.0) and the reference head (head.features.N), so a
detector's state_dict converts to the JAX package's tree with its
tools/convert_torch_resnet.py:convert_full_detector.

BatchNorm is ``nn.BatchNorm2d`` (eps 1e-5) with fp32 parameters and
statistics whatever the working dtype, as in the JAX package.

The stride-1 bottlenecks with planes >= 256 (5 + 2 of them in ResNet-50)
run their BN -> ReLU -> conv3x3 link through ops/conv_bn.py in eval mode:
bn1 is folded with its running statistics into (scale, shift), the link
computes relu(y * scale + shift) -> conv3x3, and bn2 then applies its running
statistics (the link's own (sum, sumsq) output is what a train-mode bn2
would take; eval does not use it).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv_bn import fused_bn_relu_conv

# {depth: (block kind, blocks per stage)}
RESNET_SPEC = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(cin, cout, 1, stride=stride, bias=False), _bn(cout)
    )


def fold_running_stats(bn: nn.BatchNorm2d):
    """(scale, shift) in fp32 with bn(x) == x * scale + shift in eval."""
    inv = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return inv, bn.bias.float() - bn.running_mean.float() * inv


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here, as torchvision v1.5) -> 1x1 bottleneck."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = (_downsample(inplanes, planes * 4, stride)
                           if downsample else None)
        # the JAX package's Bottleneck.fuse_bn region (models/resnet.py)
        self.fused_link = stride == 1 and planes >= 256

    def forward(self, x):
        y = self.conv1(x)
        if self.fused_link and not self.training:
            y, _ = fused_bn_relu_conv(y, self.conv2.weight,
                                      *fold_running_stats(self.bn1))
        else:
            if self.fused_link and y.is_cuda:
                raise NotImplementedError(
                    "the fused link with batch statistics (train mode) is "
                    "not ported yet; the port serves in eval mode")
            y = self.conv2(F.relu(self.bn1(y)))
        y = F.relu(self.bn2(y))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class ResNetBackbone(nn.Module):
    """7x7 stem -> maxpool -> 4 stages; (B, 3, S, S) -> (B, C, S/32, S/32)."""

    def __init__(self, num_layers: int = 50):
        super().__init__()
        kind, counts = RESNET_SPEC[num_layers]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for stage, blocks in enumerate(counts):
            planes = 64 * 2**stage
            layers = []
            for i in range(blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                out = planes * block.expansion
                layers.append(block(inplanes, planes, stride,
                                    stride != 1 or inplanes != out))
                inplanes = out
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layers))
        self.out_channels = inplanes

    def forward(self, x):
        # cuDNN's tensor-core convs and the link kernel work in channels-last
        # memory; the logical layout stays NCHW
        x = x.to(self.conv1.weight.dtype).contiguous(
            memory_format=torch.channels_last)
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x


class DeconvHead(nn.Module):
    """num_layers x (ConvTranspose k4 s2 + BN + ReLU) + 1x1 projection to
    K*D channels: (B, C, 8, 8) -> (B, K*D, 64, 64)."""

    def __init__(self, in_channels: int, num_joints: int, depth_dim: int,
                 num_deconv_layers: int = 3, num_filters: int = 256,
                 fp32_logits: bool = True):
        super().__init__()
        layers = []
        for i in range(num_deconv_layers):
            cin = in_channels if i == 0 else num_filters
            layers += [
                nn.ConvTranspose2d(cin, num_filters, 4, stride=2, padding=1,
                                   bias=False),
                _bn(num_filters),
                nn.ReLU(inplace=True),
            ]
        layers.append(nn.Conv2d(num_filters, num_joints * depth_dim, 1))
        self.features = nn.Sequential(*layers)
        self.fp32_logits = fp32_logits

    def forward(self, x):
        x = self.features[:-1](x)
        # the decode kernel reads each joint's volume as one contiguous block,
        # so the logits are produced in NCHW memory
        x = self.features[-1](x.contiguous())
        return x.float() if self.fp32_logits else x


class ResPoseNet(nn.Module):
    """Backbone + head: (B, 3, S, S) images -> (B, K*D, S/4, S/4) logits."""

    def __init__(self, num_joints: int, depth_dim: int, num_layers: int = 50,
                 fp32_logits: bool = True):
        super().__init__()
        self.backbone = ResNetBackbone(num_layers)
        self.head = DeconvHead(self.backbone.out_channels, num_joints,
                               depth_dim, fp32_logits=fp32_logits)

    def forward(self, x):
        return self.head(self.backbone(x))
