#!/usr/bin/env python3
"""Why the mono generator gradients of tests/test_torch_mono.py cannot be
held in float32: the port's gradients at that test's state and batch (the
tiny flagship with one mono camera at 64^2, flax-initialized, residual
branches conditioned to 0.1) in float32 and in float64, and in float64
again with the images 1e-6 larger (relative). Prints, per tensor, float32's
distance from float64 and the float64 move under that change, both as
shares of the tensor's largest float64 entry; then, per physique
BatchNorm, the leaky-ReLU input nearest the kink, how far float32 and the
changed images move the inputs, and how many change sign. An input that
either moves across the kink changes the gradient by a step: a
discontinuity, which float64 on both sides does not cross. CPU only,
about a minute:

    python3 scripts/mono_gradient_rounding.py
"""

import os
import sys

import jax
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]

import test_torch_mono as T  # noqa: E402
from torch_parity import carry_train_state  # noqa: E402
from x_as_supervision_tpu.data.synthetic import (  # noqa: E402
    SyntheticMonoDataset)
from x_as_supervision_tpu.train.factory import build_gan_spec  # noqa: E402
from x_as_supervision_tpu.train.state import (  # noqa: E402
    init_train_state, make_optimizers)
from x_as_supervision_tpu_torch.models.composed import (  # noqa: E402
    generator_forward)
from x_as_supervision_tpu_torch.train.state import TrainState  # noqa: E402
from x_as_supervision_tpu_torch.train.trainer import to_device  # noqa: E402

RELATIVE_CHANGE = 1e-6
TOP = 8


def port(cfg, js, dtype):
    pspec = T._port_spec(dtype)
    state = TrainState(pspec, cfg["train_params"], T.STEPS_PER_EPOCH)
    carry_train_state(pspec, state, js)
    for module in (pspec.detector, pspec.physique, pspec.discriminator):
        module.to(dtype)
    return pspec, state


def grads(pspec, state, batch, dtype, scale=1.0):
    tb = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in to_device(batch, "cpu").items()}
    tb["cam_mono_img"] = tb["cam_mono_img"] * scale
    pre = []
    hooks = [bn.register_forward_hook(
        lambda m, i, o: pre.append(o.detach().double()))
        for bn in pspec.physique.bns]
    losses, _ = generator_forward(pspec, tb)
    for h in hooks:
        h.remove()
    g = torch.autograd.grad(sum(v.mean() for v in losses.values()),
                            state.gen_params, allow_unused=True)
    return {n: x.double() for n, x in zip(state.gen_names, g)
            if x is not None}, pre


def main() -> None:
    cfg = T._mono(T._flagship_config(tiny=True))
    batch = SyntheticMonoDataset(num_samples=T.BATCH, patch_size=64,
                                 seed=0).device_batch(0, T.BATCH)
    opt_det, opt_disc = make_optimizers(cfg["train_params"],
                                        T.STEPS_PER_EPOCH)
    js = T._conditioned(init_train_state(build_gan_spec(cfg),
                                         jax.random.PRNGKey(0), batch,
                                         opt_det, opt_disc))
    p64, s64 = port(cfg, js, torch.float64)
    p32, s32 = port(cfg, js, torch.float32)
    g64, pre64 = grads(p64, s64, batch, torch.float64)
    moved, pre_moved = grads(p64, s64, batch, torch.float64,
                             1 + RELATIVE_CHANGE)
    g32, pre32 = grads(p32, s32, batch, torch.float32)
    cancelled = {"physique." + n for n in p64.physique.bn_cancelled_biases()}
    rows = []
    for name, w in g64.items():
        if name in cancelled:
            continue  # zero up to rounding: no scale to share against
        top = max(w.abs().max().item(), 1e-300)
        rows.append(((g32[name] - w).abs().max().item() / top,
                     (moved[name] - w).abs().max().item() / top, name))
    rows.sort(reverse=True)
    print(f"share of the largest float64 entry ({TOP} tensors farthest in "
          f"float32):")
    print(f"{'float32 - float64':>18} {'float64 move':>13}  tensor")
    for off, move, name in rows[:TOP]:
        print(f"{off:18.2e} {move:13.2e}  {name}")
    print("physique BatchNorm outputs (the leaky-ReLU inputs):")
    for i, (a, b, c) in enumerate(zip(pre64, pre32, pre_moved)):
        print(f"  bns.{i} {tuple(a.shape)}: nearest the kink "
              f"{a.abs().min().item():.2e}; float32 off by up to "
              f"{(a - b).abs().max().item():.2e}, sign changes "
              f"{int((torch.sign(a) != torch.sign(b)).sum())}; the changed "
              f"images in float64 move it by up to "
              f"{(a - c).abs().max().item():.2e}, sign changes "
              f"{int((torch.sign(a) != torch.sign(c)).sum())}")


if __name__ == "__main__":
    main()
