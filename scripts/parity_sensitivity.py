#!/usr/bin/env python3
"""How far the CPU's own generator gradients move when the images change by
1e-6 relative, for the reduced card-vs-CPU step of chip_smoke.py (ResNet-50
at 64^2, 2 cameras, D = 16, residual branches conditioned to 0.1): pooled
statistics at 2 images a camera (phase 7), and per-camera statistics with
use_aug and res_gcn (use_bn) at 2 and 4 images a camera (phase 11). A
gradient that moves by a share s of its tensor's largest entry here cannot
be held card against CPU to a bound below s. Prints, per setting, the five
detector tensors that move most. CPU only:

    python3 scripts/parity_sensitivity.py
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from x_as_supervision_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticPoseDataset)
from x_as_supervision_tpu_torch.models.composed import (  # noqa: E402
    generator_forward)
from x_as_supervision_tpu_torch.models.resnet import Bottleneck  # noqa: E402
from x_as_supervision_tpu_torch.train.trainer import to_device  # noqa: E402

RELATIVE_CHANGE = 1e-6


def movement(per_camera: bool, batch: int) -> list:
    cfg = cs._parity_config()
    mp = cfg["model_params"]
    if per_camera:
        mp["per_camera_bn"] = True
        mp["smpl_disc_params"].update(name="res_gcn", use_bn=True,
                                      use_aug=True)
    host = SyntheticPoseDataset(num_samples=batch, cam_id_list=(0, 1),
                                patch_size=64, seed=cs.SEED).batch(0, batch)
    spec, _ = cs._gan(cfg, torch.float32, "cpu", cs.SEED)
    with torch.no_grad():
        for m in spec.detector.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.fill_(0.1)
    cs._dropout_off(spec.discriminator)
    nh = mp["detector_params"]["num_hypo"]
    rot_u = torch.rand(2 * batch * nh,
                       generator=torch.Generator().manual_seed(cs.SEED))
    start = {k: v.clone() for k, v in spec.detector.state_dict().items()}
    names = [n for n, _ in spec.detector.named_parameters()]
    grads = []
    for change in (0.0, RELATIVE_CHANGE):
        spec.detector.load_state_dict(start)  # the same running statistics
        b = to_device(host, "cpu")
        for cam in (0, 1):
            noise = torch.from_numpy(np.random.default_rng(cam).normal(
                size=b[f"cam_{cam}_img"].shape).astype(np.float32))
            b[f"cam_{cam}_img"] = b[f"cam_{cam}_img"] * (1 + change * noise)
        losses, _ = generator_forward(spec, b, rot_u=rot_u if per_camera
                                      else None)
        total = sum(v.mean() for v in losses.values())
        grads.append(dict(zip(names, torch.autograd.grad(
            total, list(spec.detector.parameters())))))
    moved = {n: ((grads[1][n] - grads[0][n]).abs().max()
                 / grads[0][n].abs().max()).item()
             for n in names if grads[0][n].abs().max() > 0}
    return sorted(moved.items(), key=lambda kv: -kv[1])[:5]


def main() -> None:
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    for per_camera, batch in ((False, 2), (True, 2), (True, 4)):
        worst = movement(per_camera, batch)
        print(f"{'per-camera' if per_camera else 'pooled'} statistics, "
              f"{batch} images a camera: " + ", ".join(
                  f"{n} {v:.4g}" for n, v in worst), flush=True)


if __name__ == "__main__":
    main()
