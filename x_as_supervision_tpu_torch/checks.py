"""Helpers of the port's checks, shared by tests/test_torch_*.py and
chip_smoke.py. Nothing here imports JAX.

  AnchoredDataset, AnchoredDetector
      an eval fixture whose detections lie near the ground truth, so that
      the multi-view DLT is well posed and the triangulated outputs can be
      held to fixed bounds. (A detector with random weights gives some
      joints views that no finite point fits; the DLT's answer for them is
      tens of meters away and keeps few digits.) The dataset writes each
      camera's target keypoints (the normalized GT with seeded noise, some
      L/R pairs swapped) into the first row of its image; the detector
      returns them plus a small multiple of a real detector's hypotheses,
      so the real forward still runs, the hypotheses still share x, y and
      still differ in z, and the L/R switch still has swaps to undo.
  result_lines
      eval_result.txt as (key, number or None) per line.
  flat, bitwise_diffs
      leaf-by-leaf comparison of nested state dicts (checkpoints).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from .train.eval_utils import DEFAULT_SWITCH_LIST

# the real detector's share of an anchored detection (normalized units)
ANCHOR_SCALE = 0.01
# the targets' noise, about 30 mm in the 2000 mm box: a good multi-view
# detector's error, and about 300 times the fp32 DLT's own error per joint,
# so the triangulated lines of eval_result.txt keep their digits
NOISE = 0.03
# the chance that a target's L/R pair is swapped
SWAP_SHARE = 0.25


class AnchoredDataset:
    """Wraps a dataset with ``batch(start, n)``: each camera's image carries
    its target keypoints (B, K, 3) in row 0, pixels 0..K-1, channels x, y,
    z; the targets are the GT normalized as the evaluator normalizes it,
    plus N(0, NOISE), with each L/R pair swapped with probability
    SWAP_SHARE. Seeded by `start`, so two evaluators reading the same batch
    get the same targets."""

    def __init__(self, dataset, cam_id_list, img_size: float):
        self.dataset = dataset
        self.cam_id_list = tuple(cam_id_list)
        self.img_size = img_size

    def __len__(self):
        return len(self.dataset)

    def batch(self, start: int, batch_size: int) -> dict:
        out = self.dataset.batch(start, batch_size)
        rng = np.random.default_rng(start)
        s = self.img_size - 1
        for c in self.cam_id_list:
            ck = f"cam_{c}"
            j = out[f"{ck}_joints"].astype(np.float64)
            target = np.concatenate([j[..., :2] / s * 2 - 1, j[..., 2:] / s],
                                    axis=-1)
            target += rng.normal(0.0, NOISE, target.shape)
            swap = rng.random((target.shape[0], len(DEFAULT_SWITCH_LIST)))
            for p, (a, b) in enumerate(DEFAULT_SWITCH_LIST):
                rows = swap[:, p] < SWAP_SHARE
                target[rows, a], target[rows, b] = (target[rows, b].copy(),
                                                    target[rows, a].copy())
            img = out[f"{ck}_img"].copy()
            img[:, 0, :target.shape[1], :] = target
            out[f"{ck}_img"] = img
        return out


class AnchoredDetector(torch.nn.Module):
    """kps = the image's target keypoints + ANCHOR_SCALE * the wrapped
    detector's hypotheses (B, H, K, 3), from an NCHW image batch."""

    def __init__(self, detector: torch.nn.Module):
        super().__init__()
        self.detector = detector

    def forward(self, img):
        kps = self.detector(img).kps
        target = img[:, :, 0, :kps.shape[2]].permute(0, 2, 1).to(kps.dtype)
        return types.SimpleNamespace(kps=target[:, None] + ANCHOR_SCALE * kps)


def result_lines(path: str) -> list:
    """eval_result.txt as (key, number or None) per line."""
    out = []
    with open(path) as f:
        for line in f.read().splitlines():
            key, sep, value = line.partition(":")
            out.append((key, float(value.replace("%", "")) if sep else None))
    return out


def flat(tree, prefix: str = "") -> dict:
    """Every leaf of a nested dict / list of tensors and numbers, by path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}"))
    return out


def bitwise_diffs(got: dict, want: dict) -> list:
    """The paths of two flat() dicts whose leaves differ: a missing or extra
    path, another dtype or shape, one bit of a tensor (on any device), or
    another number."""
    bad = sorted(set(got) ^ set(want))
    for k, w in want.items():
        if k not in got:
            continue
        g = got[k]
        if torch.is_tensor(w):
            if not (torch.is_tensor(g) and g.dtype == w.dtype
                    and g.shape == w.shape
                    and torch.equal(g.to(w.device), w)):
                bad.append(k)
        elif g != w:
            bad.append(k)
    return bad
