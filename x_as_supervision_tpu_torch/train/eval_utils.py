"""Eval-side utilities, ported from the JAX package's train/eval_utils.py:
L/R ambiguity disambiguation (``switch_points``, in torch, on the device),
and the host-side numpy 2D error and per-action tables.
Reference: eval_utils.py:7-65 and eval.py:26-59.
"""

from __future__ import annotations

import numpy as np
import torch

# H36M action tables (per-action eval buckets; reference eval.py:26-35).
ACTIONS = (
    "Directions", "Discussion", "Eating", "Greeting", "Phoning", "Posing",
    "Purchases", "Sitting", "SittingDown", "Smoking", "TakingPhoto",
    "Waiting", "Walking", "WalkDog", "WalkTogether",
)
ACT_IDX_TO_NAME = {i + 2: name for i, name in enumerate(ACTIONS)}
SELECT_ACTIONS = (
    "Waiting", "Posing", "Greeting", "Directions", "Discussion", "Walking"
)

DEFAULT_SWITCH_LIST = ((1, 4), (2, 5), (3, 6), (14, 11), (15, 12), (16, 13))


def switch_points(points: torch.Tensor, gt: torch.Tensor,
                  switch_all: bool = False,
                  switch_list=DEFAULT_SWITCH_LIST):
    """Test the globally L/R-swapped joint permutation against GT and keep
    whichever is closer (per sample if switch_all, else per joint); the swap
    mask feeds the ambiguity-ratio statistic. The swap wins only when it is
    strictly closer (``err_swapped < err``), so a tie keeps the points.
    Reference: eval_utils.py:7-29.

    points (B, K, C); gt (B, K, >= 2); the error is the L1 distance over
    x, y. Returns (points or swapped, is_swapped (B, 1, 1) or (B, K, 1)).
    """
    perm = list(range(points.shape[1]))
    for a, b in switch_list:
        perm[a], perm[b] = b, a
    swapped = points[:, perm, :]

    err_swapped = (swapped - gt).abs()[..., :2]
    err = (points - gt).abs()[..., :2]
    dims = (1, 2) if switch_all else (2,)
    is_swapped = err_swapped.sum(dim=dims, keepdim=True) < err.sum(
        dim=dims, keepdim=True)
    return torch.where(is_swapped, swapped, points), is_swapped


def per_act_mse(pred, gt) -> np.ndarray:
    """Normalized 2D error: mean over joints of the per-joint L2 distance in
    [0, 1] coords. Reference: eval_utils.py:31-40."""
    pred = (np.asarray(pred) + 1) / 2
    gt = (np.asarray(gt) + 1) / 2
    err = np.sqrt(((pred - gt) ** 2).sum(axis=2))
    return err.mean(axis=1)


def new_act_table() -> dict:
    return {name: 0.0 for name in ACTIONS}


def update_dict(record_table, count_table, error, act_tags) -> None:
    """Accumulate per-sample errors into action buckets keyed by the act tag
    parsed from the file path ('act_NN...'). Reference: eval.py:37-41."""
    for i, tag in enumerate(act_tags):
        act_num = int(tag[4:6])
        name = ACT_IDX_TO_NAME[act_num]
        record_table[name] += float(np.asarray(error[i]))
        count_table[name] += 1


def cal_per_class_error_(record_table, count_table):
    """Normalize buckets in place, return (full-table mean, 6-action mean).
    Reference: eval_utils.py:42-55."""
    full_err, select_err = 0.0, 0.0
    for k in record_table:
        record_table[k] /= count_table[k] + 1e-8
        full_err += record_table[k]
        if k in SELECT_ACTIONS:
            select_err += record_table[k]
    return full_err / len(record_table), select_err / len(SELECT_ACTIONS)


def cal_per_class_error(record_table, count_table, multi=False):
    if not multi:
        return cal_per_class_error_(record_table, count_table)
    full, select = {}, {}
    for metric in record_table:
        full[metric], select[metric] = cal_per_class_error_(
            record_table[metric], count_table[metric]
        )
    return full, select
