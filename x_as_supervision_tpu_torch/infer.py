"""Inference CLI of the port: run a detector over a directory of pre-cropped
patch images (+ optional masks for background removal) and write the
multi-hypothesis keypoints to JSON.

  python -m x_as_supervision_tpu_torch.infer --config <yaml> \
      (--checkpoint <ckpt_dir> | --weights <det.npz>) \
      --images <dir-of-pngs> [--masks <dir>] [--out poses.json] \
      [--device cpu]

<ckpt_dir> is a checkpoint the port's trainer wrote (its detector is
served, as infer.py serves a checkpoint); <det.npz> holds JAX detector
variables as params/... and batch_stats/... keys (see weights.py). The CLI
runs on the CUDA card unless --device names another device.
"""

from __future__ import annotations

import glob
import json
import os
from argparse import ArgumentParser

import numpy as np


def main(argv: list[str] | None = None) -> None:
    parser = ArgumentParser()
    parser.add_argument("--config", required=True)
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--checkpoint", default=None,
                        help="checkpoint directory of the port's trainer")
    source.add_argument("--weights", default=None,
                        help=".npz of JAX detector variables")
    parser.add_argument("--images", required=True,
                        help="directory of pre-cropped patch images")
    parser.add_argument("--masks", default=None,
                        help="optional mask directory (rm_bg behavior)")
    parser.add_argument("--out", default="poses.json")
    parser.add_argument("--batch_size", default=8, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device; the CUDA card when not given")
    opt = parser.parse_args(argv)

    import cv2

    from .config import load_config
    from .serve import PoseEstimator

    config = load_config(opt.config)
    est = PoseEstimator(config, weights_path=opt.weights,
                        checkpoint_path=opt.checkpoint,
                        batch_size=opt.batch_size, device=opt.device)

    paths = sorted(
        p for ext in ("png", "jpg", "jpeg")
        for p in glob.glob(os.path.join(opt.images, f"*.{ext}"))
    )
    if not paths:
        raise SystemExit(f"no images found under {opt.images}")

    size = est.patch
    imgs = []
    for p in paths:
        img = cv2.imread(p, cv2.IMREAD_COLOR)[..., ::-1]
        if img.shape[:2] != (size, size):
            img = cv2.resize(img, (size, size))
        if opt.masks:
            mpath = os.path.join(opt.masks, os.path.basename(p))
            mask = cv2.imread(mpath, cv2.IMREAD_GRAYSCALE)
            if mask is not None:
                if mask.shape != img.shape[:2]:
                    mask = cv2.resize(mask, (size, size),
                                      interpolation=cv2.INTER_NEAREST)
                img = img * (mask[..., None] / 255.0)
        imgs.append(img.astype(np.float32))

    result = est(np.stack(imgs))
    out = {
        os.path.basename(p): {
            "kps_patch_norm": result.kps_patch[i].tolist(),
            "kps_pixels": result.kps_pixels[i].tolist(),
        }
        for i, p in enumerate(paths)
    }
    with open(opt.out, "w") as f:
        json.dump(out, f)
    print(f"wrote {len(paths)} poses "
          f"({result.kps_patch.shape[1]} hypotheses each) to {opt.out}")


if __name__ == "__main__":
    main()
