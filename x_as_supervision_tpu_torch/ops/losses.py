"""Loss primitives of the unsupervised pose pipeline, ported from the JAX
package's ops/losses.py. All broadcast over leading batch axes.

Reductions over hypotheses use ``torch.amin``, which splits the gradient
evenly among tied minima as JAX's ``min`` does (``torch.min(dim)`` would
send it to one index); ties are real here, since hypotheses whose depth
peaks coincide give equal values.

In a process group (parallel/) the losses that are not linear in the batch
take their batch-wide parts over the global batch: the active-pixel
fraction of ``use_clip`` and the minimum over hypotheses of batch means
(``share_of_min``).
"""

from __future__ import annotations

import torch

from ..parallel import collectives as C


def global_mean(x):
    """Mean of x over the global batch (the data ranks' shards are equal):
    x.mean() without a process group."""
    if not C.is_distributed():
        return x.mean()
    return C.psum_data(x.sum()) / (x.numel() * C.data_size())


def share_of_min(shares):
    """This rank's share of min_h G[h], where G = the sum over the data
    ranks of `shares` (H,), each rank's shares of H batch means: the
    minimum is chosen from G (the same on every rank), and its gradient
    split evenly among tied minima as torch.amin splits it. Summed over
    the ranks it is min_h G[h]."""
    total = C.psum_data(shares.detach())
    tied = (total == total.min()).to(shares.dtype)
    return (shares * tied).sum() / tied.sum()


def compute_mask_reconstruction_loss(mask, gt, weight=None,
                                     use_clip: bool = False):
    """MSE between rendered and ground-truth masks, with the reference's
    asymmetric ``use_clip``:

      * weight None: the MSE is reduced to a scalar first, and use_clip
        multiplies it by the active-pixel fraction mean(mask > 0.1) (over
        the global batch in a process group), which carries no gradient:
        every pixel gets the plain MSE gradient, scaled by that fraction.
      * weight given: elementwise MSE, masked by (mask > 0.1) under
        use_clip, weighted, then meaned: only active pixels get a gradient.
    """
    if weight is None:
        loss = ((mask - gt) ** 2).mean()
        if use_clip:
            loss = loss * global_mean((mask > 0.1).to(loss.dtype))
        return loss
    loss = (mask - gt) ** 2
    if use_clip:
        loss = loss * (mask > 0.1).to(loss.dtype)
    return (loss * weight).mean()


# Distal/proximal joints of the 8 symmetric limb bones.
_BONE_CHILD = (16, 15, 13, 12, 3, 2, 6, 5)
_BONE_PARENT = (15, 14, 12, 11, 2, 1, 5, 4)


def compute_bone_sym_loss(keypoints):
    """Left/right limb-length symmetry: MSE between paired bone lengths in
    meters (mm input, hence 1e-3). keypoints (B, K, 3)."""
    bone = (keypoints[:, list(_BONE_CHILD), :]
            - keypoints[:, list(_BONE_PARENT), :])
    length = torch.linalg.vector_norm(bone, dim=2) * 1e-3
    return ((length[:, 0::2] - length[:, 1::2]) ** 2).mean()


def compute_kp_sym_loss(keypoints, is_3d: bool = True):
    """The shoulder and hip midpoints should coincide with the thorax
    (last joint) and the pelvis (joint 0); 3D poses in mm, scored in m."""
    center = (keypoints[:, [11, 1], :] + keypoints[:, [14, 4], :]) / 2.0
    target = keypoints[:, [keypoints.shape[1] - 1, 0], :]
    if is_3d:
        return (((center - target) * 1e-3) ** 2).mean()
    return ((center - target) ** 2).mean()


def compute_supervision(keypoint, keypoint_gt):
    """MSE supervision on normalized keypoints (the JAX package's default
    mode: no feature-map unnormalization, mean reduction)."""
    return ((keypoint - keypoint_gt) ** 2).mean()


def compute_disc_loss(pred_logits, gt_logits=None):
    """LSGAN loss with a min over hypotheses for (B, H, 1) logits.

    gt_logits None: the generator's loss (pred - 1)^2; otherwise the
    discriminator's 0.5 (gt - 1)^2 + 0.5 pred^2."""

    def _reduce(term):
        if term.dim() == 2:
            return term.mean()
        if term.dim() == 3:
            return torch.amin(term, dim=1).mean()
        raise ValueError("logits must be (B, 1) or (B, H, 1)")

    if gt_logits is None:
        return _reduce((pred_logits - 1.0) ** 2)
    return (0.5 * _reduce((gt_logits - 1.0) ** 2)
            + 0.5 * _reduce(pred_logits ** 2))
