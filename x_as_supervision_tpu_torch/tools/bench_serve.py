"""Serving benchmark: PoseEstimator's latency and throughput per batch size,
the port of the JAX package's tools/bench_serve.py.

Two numbers per batch size:
  * device fwd: the detector's forward on a device-resident, preprocessed
    input (what ``PoseEstimator.__call__`` runs per chunk), timed by
    tools/measure.py:time_ms (CUDA events on the card);
  * end-to-end: ``PoseEstimator.__call__`` (host numpy in, host numpy
    out), host-to-device and device-to-host copies included.
Each row also gives the kernels' launches per forward (on the card one
decode forward and, in ResNet-50, 7 links) and ``device``.

Usage:
  python -m x_as_supervision_tpu_torch.tools.bench_serve --config cfg.json \
      [--checkpoint <run>/<epoch>_ckpt] [--batches 1,8,32] [--iters 20] \
      [--device cpu]
Without --checkpoint the detector of the config's detector_params has
seeded random weights (weights.init_weights, then weights.condition_for_eval
on a few seeded images so the eval forward stays finite; timing does not
depend on the weights). --checkpoint takes a checkpoint of the port's
trainer. The detector runs in bf16, as PoseEstimator's default.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import weights
from ..config import load_config
from ..models.detector import build_detector
from ..serve import PoseEstimator, preprocess
from . import measure

# seeded images the random weights are conditioned on (on the CPU)
CONDITION_IMAGES = 4
# untimed device forwards before the timed ones
WARMUP = 3
SEED = 0


def random_detector_state(config: dict, seed: int) -> dict:
    """Seeded random detector weights, conditioned for a finite eval
    forward: weights.condition_for_eval on CONDITION_IMAGES seeded images
    drawn and normalized as the benchmark's own."""
    det = build_detector(config["model_params"]["detector_params"])
    weights.init_weights(det, seed)
    patch = int(config["train_params"].get("patch_width", 256))
    imgs = np.random.default_rng(seed + 1).uniform(
        0, 255, size=(CONDITION_IMAGES, patch, patch, 3)).astype(np.float32)
    dataiter = config["dataset_params"].get("dataiter", {})
    weights.condition_for_eval(det, preprocess(
        torch.from_numpy(imgs), dataiter.get("mean"),
        dataiter.get("std")).contiguous())
    return det.state_dict()


def bench_batch(est: PoseEstimator, batch: int, rng: np.random.Generator,
                iters: int, label: str) -> dict:
    imgs = rng.uniform(0, 255, size=(batch, est.patch, est.patch, 3)).astype(
        np.float32)
    est(imgs)  # warm-up: cuDNN plans, the allocator
    x = est.preprocess(torch.from_numpy(imgs).to(est.device))

    def forward():
        with torch.inference_mode():
            return est.detector(x).kps

    before = measure.launches()
    device_ms, check = measure.time_ms(forward, est.device, iters, WARMUP)
    per_forward = measure.launches_since(before, iters + WARMUP)
    e2e_ms, _ = measure.time_ms(lambda: est(imgs).kps_patch, est.device,
                                iters, warmup=0)
    return {
        "batch": batch,
        "device_ms": device_ms, "img_s_device": batch / device_ms * 1e3,
        "end_to_end_ms": e2e_ms, "img_s_e2e": batch / e2e_ms * 1e3,
        "launches_per_forward": per_forward, "checksum": check,
        "device": label,
    }


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m x_as_supervision_tpu_torch.tools.bench_serve")
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batches", default="1,8,32")
    p.add_argument("--iters", type=int, default=20)
    measure.add_device_arg(p)
    args = p.parse_args(argv)

    device = measure.resolve_device(args.device)
    label = measure.device_label(device)
    config = load_config(args.config)
    state = (None if args.checkpoint is not None
             else random_detector_state(config, SEED))
    rng = np.random.default_rng(SEED)
    rows = []
    for bs in (int(b) for b in args.batches.split(",")):
        est = PoseEstimator(config, det_state=state,
                            checkpoint_path=args.checkpoint, batch_size=bs,
                            device=device)
        rows.append(bench_batch(est, bs, rng, args.iters, label))
        measure.emit(rows[-1])
        del est
    return rows


if __name__ == "__main__":
    main()
