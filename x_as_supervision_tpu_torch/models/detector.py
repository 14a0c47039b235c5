"""Integral keypoint detectors (single- and multi-hypothesis), ported from
the JAX package's models/detector.py.

Input images are (B, 3, S, S); output keypoints are (B, num_hypo, K, 3) in
[-1, 1] (num_hypo == 1 for the single-hypothesis detector), plus the
z-marginal of batch element 0.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import integral
from .resnet import ResPoseNet, set_bn_groups


class KPDetector3D(nn.Module):
    def __init__(self, num_kp: int = 18, depth_dim: int = 64,
                 num_layers: int = 50, fp32_logits: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_kp = num_kp
        self.net = ResPoseNet(num_kp, depth_dim, num_layers, fp32_logits,
                              dtype)

    def forward(self, img) -> integral.IntegralDecode:
        return integral.decode_single(self.net(img), self.num_kp)


class KPDetector3DMulti(nn.Module):
    """Shared x/y soft-argmax, depth hypotheses from 1-D peak finding plus a
    windowed expectation."""

    def __init__(self, num_kp: int = 18, depth_dim: int = 64,
                 num_hypo: int = 3, neighbor_size: int = 15,
                 num_layers: int = 50, fp32_logits: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_kp = num_kp
        self.num_hypo = num_hypo
        self.neighbor_size = neighbor_size
        self.net = ResPoseNet(num_kp, depth_dim, num_layers, fp32_logits,
                              dtype)

    def forward(self, img) -> integral.IntegralDecode:
        return integral.decode_multi(self.net(img), self.num_kp,
                                     self.num_hypo, self.neighbor_size)


def build_detector(detector_params: dict, dtype=torch.float32,
                   train: bool = False) -> nn.Module:
    """Detector from a config's ``detector_params``, in eval mode, or in
    train mode with ``train=True``.

    Parameters and BatchNorm statistics are fp32; the forward computes in
    `dtype` (models/resnet.py says where it is cast in), as the JAX
    package's ``param_dtype=float32, dtype=dtype``. ``bn_groups`` gives
    every BatchNorm per-camera train statistics (models/resnet.py). The JAX
    opt-ins ``use_pallas`` and ``fuse_bn`` select nothing here: on the card
    the port always runs its kernels. ``phase_head`` (the JAX package's
    phase-layout deconv head, the same function with the same parameters),
    ``subpixel`` and ``s2d_stem`` (which its build_detector does not read)
    run the standard head and stem."""
    common = dict(
        num_kp=detector_params["num_kp"],
        depth_dim=detector_params["depth_dim"],
        num_layers=detector_params.get("num_layers", 50),
        fp32_logits=detector_params.get("fp32_logits", True),
        dtype=dtype,
    )
    if detector_params["name"] == "resnet_multi":
        det = KPDetector3DMulti(num_hypo=detector_params["num_hypo"],
                                neighbor_size=detector_params["neighbor_size"],
                                **common)
    else:
        det = KPDetector3D(**common)
    set_bn_groups(det, detector_params.get("bn_groups", 1))
    return det.train(train)
