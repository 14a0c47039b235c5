"""Patch -> image -> world keypoint conversions (the chain the serving path's
``lift_to_world`` uses), ported from the JAX package's ops/geometry.py.

Conventions: keypoints are (..., K, 3) with channels (x, y, z), x the image
column and y the row. "patch" coords are pixels of the square crop,
optionally normalized so x, y, z lie in [-1, 1] (divided by side - 1);
"image" coords are pixels of the full camera image plus metric depth in mm;
"world" coords are mm under the camera extrinsics x_cam = R x_world + t.
``trans`` is the 2x3 affine mapping image to patch pixels.
"""

from __future__ import annotations

import torch


def _invert_affine_2x3(trans: torch.Tensor):
    """Invert a (..., 2, 3) affine by its explicit 2x2 inverse; returns the
    inverse linear part and the translation."""
    a, b = trans[..., 0, 0], trans[..., 0, 1]
    c, d = trans[..., 1, 0], trans[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack(
        [torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2
    ) / det[..., None, None]
    return inv, trans[..., :, 2]


def convert_patch_to_image(kps, trans, image_depth: int, image_height: int,
                           image_width: int, depth_scale, pelvis,
                           is_norm: bool = True):
    """Crop-patch -> full-image pixel coords + metric depth.

    kps (B, K, 3); trans (B, 2, 3) image->patch affine; pelvis (B, 3) with
    pelvis[..., 2] the camera-frame pelvis depth in mm."""
    x, y, z = kps[..., 0], kps[..., 1], kps[..., 2]
    if is_norm:
        x = (x + 1.0) / 2.0 * (image_width - 1)
        y = (y + 1.0) / 2.0 * (image_height - 1)
        z = z * (image_depth - 1)
    inv, t = _invert_affine_2x3(trans)
    xy = torch.stack([x, y], dim=-1) - t[..., None, :]
    xy = torch.einsum("...ij,...kj->...ki", inv, xy)
    z = z * depth_scale + pelvis[..., 2][..., None]
    return torch.cat([xy, z[..., None]], dim=-1)


def convert_image_to_world(kps, fx, fy, u, v, trans, rot):
    """Pinhole back-projection, then camera -> world: R^-1 (x_cam - t).

    fx/fy/u/v (B, 1); trans (B, 3); rot (B, 3, 3)."""
    z = kps[..., 2]
    x = (kps[..., 0] - u) / fx * z
    y = (kps[..., 1] - v) / fy * z
    cam = torch.stack([x, y, z], dim=-1) - trans[..., None, :]
    return torch.einsum("...ij,...kj->...ki", torch.linalg.inv(rot), cam)


def convert_patch_to_world(keypoints, trans_image, pelvis, k_mat,
                           trans_world, rot_world, image_width: int,
                           image_height: int, is_norm: bool = True,
                           rect_width: float = 2000.0):
    """Full patch -> world chain for one camera batch.

    The image side is passed explicitly (the JAX package reads it from the
    shape of an image batch); depth uses the width, as there."""
    kp_img = convert_patch_to_image(
        keypoints, trans_image, image_width, image_height, image_width,
        rect_width / image_width, pelvis, is_norm=is_norm,
    )
    return convert_image_to_world(
        kp_img, k_mat[..., 0, [0]], k_mat[..., 1, [1]], k_mat[..., 0, [2]],
        k_mat[..., 1, [2]], trans_world, rot_world,
    )
