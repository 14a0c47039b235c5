"""3D pose metrics: MPJPE family, 3DPCK, 3DAUC, PCKh.

The port's own copy of the JAX package's train/metrics.py (numpy only,
float64 on the host, as there): the batched Procrustes alignment, MPJPE /
N-MPJPE / P-MPJPE, 3DPCK, 3DAUC and PCKh.
"""

from __future__ import annotations

import numpy as np


def compute_similarity_transform_batch(
    source: np.ndarray, target: np.ndarray
) -> np.ndarray:
    """Batched orthogonal Procrustes: find (s, R, t) minimizing
    ||s R src + t - tgt|| per batch element and return the transformed
    sources. source/target: (N, K, 3). Reference: metrics.py:5-62."""
    mu1 = source.mean(axis=1, keepdims=True)
    mu2 = target.mean(axis=1, keepdims=True)
    x1 = source - mu1  # (N, K, 3)
    x2 = target - mu2

    var1 = np.sum(x1**2, axis=(1, 2))  # (N,)
    k = np.einsum("nkc,nkd->ncd", x1, x2)  # (N, 3, 3) = X1^T X2

    u, _, vh = np.linalg.svd(k)
    v = np.swapaxes(vh, -1, -2)
    det = np.linalg.det(np.einsum("nij,nkj->nik", u, v))  # det(U V^T)
    z = np.tile(np.eye(3), (source.shape[0], 1, 1)).copy()
    z[:, -1, -1] = np.sign(det)
    r = np.einsum("nij,njk,nlk->nil", v, z, u)  # V Z U^T

    scale = np.einsum("nii->n", np.einsum("nij,njk->nik", r, k)) / var1
    t = mu2 - scale[:, None, None] * np.einsum(
        "nij,nkj->nki", r, mu1
    )
    return scale[:, None, None] * np.einsum("nij,nkj->nki", r, source) + t


def _align(pred: np.ndarray, gt: np.ndarray, alignment: str) -> np.ndarray:
    if alignment == "none":
        return pred
    if alignment == "procrustes":
        return compute_similarity_transform_batch(pred, gt)
    if alignment == "scale":
        pred_dot_pred = np.einsum("nkc,nkc->n", pred, pred)
        pred_dot_gt = np.einsum("nkc,nkc->n", pred, gt)
        return pred * (pred_dot_gt / pred_dot_pred)[:, None, None]
    raise ValueError(f"Invalid value for alignment: {alignment}")


def _to_np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def keypoint_mpjpe(pred, gt, mask, alignment: str = "none") -> np.ndarray:
    """Per-joint position error (N, K), optionally scale/Procrustes aligned.
    Reference: metrics.py:65-118."""
    pred, gt = _to_np(pred), _to_np(gt)
    assert np.asarray(mask).any()
    pred = _align(pred, gt, alignment)
    return np.linalg.norm(pred - gt, ord=2, axis=-1) * np.asarray(mask)


def keypoint_3d_pck(
    pred, gt, mask, alignment: str = "none", threshold: float = 0.15
) -> np.ndarray:
    """3DPCK @ threshold (meters). Reference: metrics.py:121-179."""
    pred, gt = _to_np(pred), _to_np(gt)
    assert np.asarray(mask).any()
    pred = _align(pred, gt, alignment)
    error = np.linalg.norm(pred - gt, ord=2, axis=-1)
    return (error < threshold).astype(np.float32) * np.asarray(mask) * 100


def keypoint_3d_auc(pred, gt, mask, alignment: str = "none") -> float:
    """AUC over 31 thresholds in [0, 0.15] m. Reference: metrics.py:182-244."""
    pred, gt = _to_np(pred), _to_np(gt)
    assert np.asarray(mask).any()
    pred = _align(pred, gt, alignment)
    error = np.linalg.norm(pred - gt, ord=2, axis=-1)
    thresholds = np.linspace(0.0, 0.15, 31)
    pcks = [
        ((error < t).astype(np.float32) * np.asarray(mask)).mean()
        for t in thresholds
    ]
    return float(np.mean(pcks) * 100)


def keypoint_pckh(pred, gt, head_size, thr: float = 0.5) -> np.ndarray:
    """PCKh: per-sample fraction of joints within thr * head size.
    Reference: metrics.py:247-253."""
    pred, gt = _to_np(pred), _to_np(gt)
    error = np.linalg.norm(pred - gt, ord=2, axis=-1)
    error = error / np.asarray(head_size)[..., None]
    return (error < thr).astype(np.float32).mean(axis=-1) * 100
