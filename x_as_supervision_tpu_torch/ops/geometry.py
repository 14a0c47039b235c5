"""The skeleton line renderer, the patch -> image -> world keypoint
conversions and the multi-view DLT triangulation, ported from the JAX
package's ops/geometry.py.

Conventions: keypoints are (..., K, 3) with channels (x, y, z), x the image
column and y the row. "patch" coords are pixels of the square crop,
optionally normalized so x, y, z lie in [-1, 1] (divided by side - 1);
"image" coords are pixels of the full camera image plus metric depth in mm;
"world" coords are mm under the camera extrinsics x_cam = R x_world + t.
``trans`` is the 2x3 affine mapping image to patch pixels.
"""

from __future__ import annotations

import torch

# Line ids rendered with a 2x sharper falloff when the extended (>= 21 line)
# skeleton is used: the four arm bones.
ARM_LINE_IDS = (11, 12, 14, 15)


def draw_lines(keypoints, image_size: int, parent_ids, child_ids,
               body_width: float):
    """Differentiable point-to-segment Gaussian line rendering, fp32.

    keypoints (B, K, 2) in [-1, 1]; parent_ids / child_ids the L lines'
    endpoints; body_width the falloff (already scaled by 1e-3). For every
    pixel of an S^2 grid over [-1, 1]^2, the squared distance to each
    segment (to its start before it, its end after it, the foot of the
    perpendicular between) gives exp(-d^2 / body_width); with >= 21 lines
    the arm bones fall off 2x faster. Returns (B, L, S, S)."""
    child = torch.as_tensor(child_ids, device=keypoints.device)
    parent = torch.as_tensor(parent_ids, device=keypoints.device)
    num_lines = len(parent_ids)
    sx = keypoints[:, child, 0, None]  # start, (B, L, 1)
    sy = keypoints[:, child, 1, None]
    ex = keypoints[:, parent, 0, None]  # end
    ey = keypoints[:, parent, 1, None]
    vx, vy = ex - sx, ey - sy

    coord = torch.linspace(-1.0, 1.0, image_size, dtype=keypoints.dtype,
                           device=keypoints.device)
    gx = coord.repeat(image_size).view(1, 1, -1)  # (1, 1, S*S), x fastest
    gy = coord.repeat_interleave(image_size).view(1, 1, -1)

    dsx, dsy = gx - sx, gy - sy
    t = (dsx * vx + dsy * vy) / (1e-8 + vx * vx + vy * vy)
    dex, dey = gx - ex, gy - ey
    sq_start = dsx * dsx + dsy * dsy
    sq_end = dex * dex + dey * dey
    fx, fy = dsx - t * vx, dsy - t * vy
    sq_foot = fx * fx + fy * fy
    sq = torch.where(t <= 0.0, sq_start,
                     torch.where(t >= 1.0, sq_end, sq_foot))
    sq = sq.view(keypoints.shape[0], num_lines, image_size, image_size)

    neg = -sq / body_width
    if num_lines >= 21:
        sharp = torch.ones(num_lines, dtype=keypoints.dtype,
                           device=keypoints.device)
        sharp[list(ARM_LINE_IDS)] = 2.0
        neg = neg * sharp.view(1, -1, 1, 1)
    return torch.exp(neg)


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


def _batch_matmul(a, b):
    """(..., I, J) @ (..., J, L) as fp32 products and sums: exact fp32
    whatever the card's TF32 setting (the JAX package's HIGHEST)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def batch_triangulate(keypoints, p_all):
    """DLT SVD triangulation of multi-view 2D detections.

    keypoints (B, V, K, 3): image pixels, confidence in channel 2 (the
    metric depth, used only as a positive per-view weight); p_all
    (B, V, 3, 4) projection matrices. Returns (B, K, 4): world xyz and the
    mean confidence over the views that see the joint. The (B, K, 2V, 4)
    system is solved by one batched SVD on the keypoints' device; the null
    vector's free sign goes away in the division by its 4th entry."""
    conf_all = keypoints[..., -1]
    vis = (conf_all > 0).to(keypoints.dtype).sum(dim=1)  # (B, K)
    conf3d = conf_all.sum(dim=1) / vis

    p0 = p_all[:, None, :, 0, :]  # (B, 1, V, 4)
    p1 = p_all[:, None, :, 1, :]
    p2 = p_all[:, None, :, 2, :]
    u = keypoints[..., 0].transpose(1, 2)[..., None]  # (B, K, V, 1)
    v = keypoints[..., 1].transpose(1, 2)[..., None]
    conf = keypoints[..., 2].transpose(1, 2)[..., None]
    a = torch.cat([conf * (u * p2 - p0), conf * (v * p2 - p1)], dim=2)

    _, _, vh = torch.linalg.svd(a, full_matrices=True)
    x = vh[:, :, -1, :]  # (B, K, 4)
    x = x / x[..., 3:]
    return torch.cat([x[..., :3], conf3d[..., None]], dim=-1)


def triangulation(keypoints: dict, batch: dict, cam_id_list, side: int):
    """Per-camera patch -> image lift, then the DLT over all cameras.

    keypoints {"cam_<id>": (B, K, 3)} normalized patch coordinates, a
    2000 mm box (the JAX package's defaults); batch holds each camera's
    ``cam_<id>_{trans_image,pelvis,k_mat,trans_world,rot_world}``; side the
    square patch side (the JAX package reads it from the image batch).
    Returns world mm (B, K, 3)."""
    points, pmats = [], []
    for cam_id in cam_id_list:
        ck = f"cam_{cam_id}"
        points.append(convert_patch_to_image(
            keypoints[ck], batch[f"{ck}_trans_image"], side, side, side,
            2000.0 / side, batch[f"{ck}_pelvis"]))
        extrinsic = torch.cat([batch[f"{ck}_rot_world"],
                               batch[f"{ck}_trans_world"][..., None]], dim=-1)
        pmats.append(_batch_matmul(batch[f"{ck}_k_mat"], extrinsic))
    return batch_triangulate(torch.stack(points, dim=1),
                             torch.stack(pmats, dim=1))[..., :3]
