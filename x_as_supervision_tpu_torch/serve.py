"""Inference / serving path: the port of the JAX package's serve.py.

``PoseEstimator`` loads detector weights (a checkpoint of the port's
trainer, a state_dict, or a ``.npz`` of JAX variables), runs the detector in
eval mode over pre-cropped patches in chunks of ``batch_size``, and returns
multi-hypothesis keypoints in normalized patch coordinates and in patch
pixels; ``lift_to_world`` takes them to world mm given calibration.

It runs on the CUDA device unless the caller passes ``device="cpu"``; asking
for the card where there is none raises. On the card the detector's decode
and its fused BN->ReLU->conv3x3 links run the port's CUDA kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import weights
from .models.detector import build_detector
from .ops import geometry as G


@dataclass
class PoseResult:
    kps_patch: np.ndarray  # (N, num_hypo, K, 3), normalized [-1, 1]
    kps_pixels: np.ndarray  # (N, num_hypo, K, 3), patch pixels + depth px


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another; a CUDA device where there is none raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return device


class PoseEstimator:
    def __init__(
        self,
        config: dict,
        det_state: dict | None = None,
        weights_path: str | None = None,
        batch_size: int = 8,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
        checkpoint_path: str | None = None,
    ):
        """det_state: a detector state_dict (``net.backbone.*``,
        ``net.head.*``); weights_path: a ``.npz`` of JAX detector variables
        (see weights.py); checkpoint_path: a ``<run>/{epoch:05d}_ckpt`` of
        the port's trainer (its detector, as the JAX package's PoseEstimator
        restores one). One of the three is needed."""
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.patch = int(config["train_params"].get("patch_width", 256))
        dataiter = config.get("dataset_params", {}).get("dataiter", {})
        self.mean, self.std = dataiter.get("mean"), dataiter.get("std")
        if det_state is None and checkpoint_path is not None:
            from .train import checkpoint as ckpt

            det_state = ckpt.restore_detector(checkpoint_path)
        if det_state is None:
            if weights_path is None:
                raise ValueError("need det_state, weights_path or "
                                 "checkpoint_path")
            det_state = weights.load_npz(weights_path)
        det = build_detector(config["model_params"]["detector_params"], dtype)
        det.load_state_dict(det_state)
        self.detector = det.to(self.device)

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """(N, S, S, 3) RGB uint8/float -> normalized fp32 (N, 3, S, S)."""
        x = images.float()
        if self.mean is not None and self.std is not None:
            mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)
            std = torch.tensor(self.std, dtype=torch.float32, device=x.device)
            x = (x - mean) / std
        return x.permute(0, 3, 1, 2)

    @torch.inference_mode()
    def __call__(self, images: np.ndarray) -> PoseResult:
        """Run the detector over N pre-cropped (N, S, S, 3) patches."""
        images = torch.as_tensor(np.asarray(images))
        outs = []
        for start in range(0, images.shape[0], self.batch_size):
            chunk = images[start:start + self.batch_size].to(self.device)
            outs.append(self.detector(self.preprocess(chunk)).kps.float())
        kps = torch.cat(outs).cpu().numpy()

        pixels = kps.copy()
        pixels[..., 0] = (pixels[..., 0] + 1) / 2 * (self.patch - 1)
        pixels[..., 1] = (pixels[..., 1] + 1) / 2 * (self.patch - 1)
        pixels[..., 2] = pixels[..., 2] * (self.patch - 1)
        return PoseResult(kps_patch=kps, kps_pixels=pixels)

    @torch.inference_mode()
    def lift_to_world(self, kps_patch: np.ndarray, cam: dict) -> np.ndarray:
        """Lift normalized patch keypoints (N, num_hypo, K, 3) to world mm
        given calibration {trans_image (N,2,3), pelvis (N,3), k_mat (N,3,3),
        rot_world (N,3,3), trans_world (N,3)}."""
        n, h = kps_patch.shape[:2]

        def rep(v):
            return torch.as_tensor(np.repeat(np.asarray(v, np.float32), h,
                                             axis=0), device=self.device)

        flat = torch.as_tensor(
            np.asarray(kps_patch, np.float32).reshape(n * h,
                                                      *kps_patch.shape[2:]),
            device=self.device,
        )
        world = G.convert_patch_to_world(
            flat, rep(cam["trans_image"]), rep(cam["pelvis"]),
            rep(cam["k_mat"]), rep(cam["trans_world"]), rep(cam["rot_world"]),
            image_width=self.patch, image_height=self.patch, is_norm=True,
        )
        return world.cpu().numpy().reshape(n, h, *kps_patch.shape[2:])
