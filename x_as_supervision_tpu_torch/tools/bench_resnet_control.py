"""Control experiment: a plain ResNet classifier's train step and its MFU
on the card, the port of the JAX package's tools/bench_resnet_control.py.

The model is the detector's backbone (models/resnet.py:ResNetBackbone) with
a global average pool and Linear(1000) (models/resnet.py:AvgPoolHead), one
softmax cross-entropy Adam(1e-3) step, bf16 compute with fp32 parameters
and BatchNorm statistics: no GAN, no deconv head, no renderer. In train
mode ResNet-50's stride-1 3x3s with 256 or more planes (5 + 2) run the
link kernel (ops/conv_bn.py:fused_link; its backward is PyTorch ops), so
a step launches it 7 times. The step's share of the card's bf16 dense peak
says what a ResNet-class step reaches on this card.

FLOPs are counted from the layer shapes (``analytic_flops``): every conv
and the matmul, forward and backward (the input gradient and the weight
gradient; the stem's input needs no gradient). XLA's cost analysis, the
JAX tool's count, has no counterpart here, and
torch.utils.flop_counter.FlopCounterMode cannot see a kernel launched
through ctypes; on the CPU path, where every conv is a PyTorch op, the
analytic count equals FlopCounterMode's.

Usage: python -m x_as_supervision_tpu_torch.tools.bench_resnet_control
       [--batch 128] [--size 256] [--layers 50] [--iters 15] [--warmup 3]
       [--also_224] [--device cpu]
Prints one JSON line per case.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import weights
from ..models.resnet import AvgPoolHead, BasicBlock, ResNetBackbone
from . import measure

NUM_CLASSES = 1000
LR = 1e-3


class ResNetClassifier(nn.Module):
    """ResNetBackbone -> global average pool -> Linear(num_classes), fp32
    logits; the JAX tool's ResNetClassifier (``backbone``, ``Dense_0``)."""

    def __init__(self, layers: int, dtype=torch.bfloat16,
                 num_classes: int = NUM_CLASSES):
        super().__init__()
        self.backbone = ResNetBackbone(layers, dtype)
        self.head = AvgPoolHead(self.backbone.out_channels, num_classes,
                                dtype)

    def forward(self, x):
        return self.head(self.backbone(x))


def loss_fn(model: nn.Module, imgs, labels):
    """Mean softmax cross-entropy of the logits (fp32) against labels."""
    return F.cross_entropy(model(imgs), labels)


def _out(side: int, conv) -> int:
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    return (side + 2 * p - k) // s + 1


def analytic_flops(model: ResNetClassifier, batch: int, size: int) -> float:
    """FLOPs of one train step from the layer shapes: per conv 2 B Ho Wo
    Cout Cin k^2 forward, as much again for its weight gradient and for
    its input gradient (none for the stem, whose input is the images); the
    Linear's 2 B Cin Cout three times over."""
    total = 0.0

    def conv(c, side: int, needs_input_grad: bool = True) -> int:
        nonlocal total
        out = _out(side, c)
        fwd = 2.0 * batch * out * out * c.out_channels * c.in_channels \
            * c.kernel_size[0] * c.kernel_size[1]
        total += fwd * (3 if needs_input_grad else 2)
        return out

    bb = model.backbone
    side = conv(bb.conv1, size, needs_input_grad=False)
    side = (side + 2 * 1 - 3) // 2 + 1  # the 3x3 s2 max pool
    for stage in range(1, 5):
        for block in getattr(bb, f"layer{stage}"):
            convs = ((block.conv1, block.conv2) if isinstance(block, BasicBlock)
                     else (block.conv1, block.conv2, block.conv3))
            out = side
            for c in convs:
                out = conv(c, out)
            if block.downsample is not None:
                conv(block.downsample[0], side)
            side = out
    fc = model.head.fc
    total += 3 * 2.0 * batch * fc.in_features * fc.out_features
    return total


def make_step(model: nn.Module, opt: torch.optim.Optimizer):
    def step(imgs, labels):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, imgs, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def run_case(batch: int, size: int, layers: int, iters: int, warmup: int,
             device, label: str, seed: int = 0) -> dict:
    model = ResNetClassifier(layers).train()
    weights.init_weights(model, seed)
    model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.normal(size=(batch, 3, size, size)).astype(
        np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, NUM_CLASSES, batch)).to(device)
    step = make_step(model, opt)
    flops = analytic_flops(model, batch, size)
    before = measure.launches()
    step_ms, loss = measure.time_ms(lambda: step(imgs, labels), device,
                                    iters, warmup)
    per_step = measure.launches_since(before, iters + warmup)
    peaks = measure.card_peaks(device)
    return {
        "batch": batch, "size": size, "layers": layers,
        "step_ms": step_ms, "img_s": batch / step_ms * 1e3,
        "flops_per_step": flops, "flops_source": "analytic",
        "mfu_vs_bf16_peak": (flops / (step_ms / 1e3) / peaks["bf16"]
                             if peaks is not None else None),
        "bf16_peak_flops": peaks["bf16"] if peaks is not None else None,
        "loss": loss, "launches_per_step": per_step, "device": label,
    }


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m x_as_supervision_tpu_torch.tools.bench_resnet_control")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--layers", type=int, default=50)
    p.add_argument("--iters", type=int, default=15)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--also_224", action="store_true",
                   help="also run the standard 224^2 shape")
    measure.add_device_arg(p)
    args = p.parse_args(argv)

    device = measure.resolve_device(args.device)
    label = measure.device_label(device)
    rows = []
    for size in (args.size, 224) if args.also_224 else (args.size,):
        rows.append(run_case(args.batch, size, args.layers, args.iters,
                             args.warmup, device, label))
        measure.emit(rows[-1])
    return rows


if __name__ == "__main__":
    main()
