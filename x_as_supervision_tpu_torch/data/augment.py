"""Augmentation parameter draws (scale, rotation, flip, per-channel color)
from an injected generator: the port's own copy of the JAX package's
data/augment.py, with the same draws in the same order.
Reference: human_utils/common/utility/augment.py:6-26.
"""

from __future__ import annotations

import numpy as np

DEFAULT_AUG = dict(
    scale_factor=0.25,
    rot_factor=30,
    color_factor=0.2,
    do_flip_aug=True,
    rot_aug_rate=0.6,
    flip_aug_rate=0.5,
)


def do_augmentation(aug_config: dict, rng: np.random.Generator | None = None):
    rng = rng or np.random.default_rng()
    cfg = {**DEFAULT_AUG, **dict(aug_config)}
    scale = np.clip(rng.standard_normal(), -1.0, 1.0) * cfg["scale_factor"] + 1.0
    rot = (
        np.clip(rng.standard_normal(), -2.0, 2.0) * cfg["rot_factor"]
        if rng.random() <= cfg["rot_aug_rate"]
        else 0.0
    )
    do_flip = bool(cfg["do_flip_aug"]) and rng.random() <= cfg["flip_aug_rate"]
    lo, hi = 1.0 - cfg["color_factor"], 1.0 + cfg["color_factor"]
    color_scale = [rng.uniform(lo, hi) for _ in range(3)]
    return scale, rot, do_flip, color_scale
