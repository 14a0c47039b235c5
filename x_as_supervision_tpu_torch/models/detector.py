"""Integral keypoint detectors (single- and multi-hypothesis), ported from
the JAX package's models/detector.py.

Input images are (B, 3, S, S); output keypoints are (B, num_hypo, K, 3) in
[-1, 1] (num_hypo == 1 for the single-hypothesis detector), plus the
z-marginal of batch element 0.

``stage``: "all" (images -> decode); "features" (images -> the head's
deconv feature map); "tail" (that map -> the 1x1 projection -> decode), the
split of the ``head_decode`` remat mode (models/composed.py).
``remat_decode`` (the ``decode`` mode) recomputes the decode in the
backward: a checkpoint region (models/remat.py) around it where a gradient
is being recorded.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import integral
from .remat import checkpoint
from .resnet import ResPoseNet, set_bn_groups


class _Detector(nn.Module):
    """The pose net and its decode, `decode(logits)`."""

    def __init__(self, num_kp: int, depth_dim: int, num_layers: int,
                 fp32_logits: bool, dtype: torch.dtype, remat_decode: bool):
        super().__init__()
        self.num_kp = num_kp
        self.remat_decode = remat_decode
        self.net = ResPoseNet(num_kp, depth_dim, num_layers, fp32_logits,
                              dtype)

    def decode(self, logits) -> integral.IntegralDecode:
        raise NotImplementedError

    def forward(self, img, stage: str = "all"):
        if stage == "features":
            return self.net(img, "features")
        logits = self.net(img, "final" if stage == "tail" else "all")
        if self.remat_decode and torch.is_grad_enabled():
            return checkpoint(self.decode, logits)
        return self.decode(logits)


class KPDetector3D(_Detector):
    def __init__(self, num_kp: int = 18, depth_dim: int = 64,
                 num_layers: int = 50, fp32_logits: bool = True,
                 dtype: torch.dtype = torch.float32,
                 remat_decode: bool = False):
        super().__init__(num_kp, depth_dim, num_layers, fp32_logits, dtype,
                         remat_decode)

    def decode(self, logits) -> integral.IntegralDecode:
        return integral.decode_single(logits, self.num_kp)


class KPDetector3DMulti(_Detector):
    """Shared x/y soft-argmax, depth hypotheses from 1-D peak finding plus a
    windowed expectation."""

    def __init__(self, num_kp: int = 18, depth_dim: int = 64,
                 num_hypo: int = 3, neighbor_size: int = 15,
                 num_layers: int = 50, fp32_logits: bool = True,
                 dtype: torch.dtype = torch.float32,
                 remat_decode: bool = False):
        super().__init__(num_kp, depth_dim, num_layers, fp32_logits, dtype,
                         remat_decode)
        self.num_hypo = num_hypo
        self.neighbor_size = neighbor_size

    def decode(self, logits) -> integral.IntegralDecode:
        return integral.decode_multi(logits, self.num_kp, self.num_hypo,
                                     self.neighbor_size)


def build_detector(detector_params: dict, dtype=torch.float32,
                   train: bool = False,
                   remat_decode: bool = False) -> nn.Module:
    """Detector from a config's ``detector_params``, in eval mode, or in
    train mode with ``train=True``; ``remat_decode`` recomputes its decode
    in the backward (the ``decode`` remat mode).

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
        remat_decode=remat_decode,
    )
    if detector_params["name"] == "resnet_multi":
        det = KPDetector3DMulti(num_hypo=detector_params["num_hypo"],
                                neighbor_size=detector_params["neighbor_size"],
                                **common)
    else:
        det = KPDetector3D(**common)
    set_bn_groups(det, detector_params.get("bn_groups", 1))
    return det.train(train)
