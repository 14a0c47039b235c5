"""Geometry, ported from the JAX package's ops/geometry.py: the coordinate
grid, the skeleton line renderer, the patch <-> image <-> world keypoint
conversions, the multi-view DLT triangulation, the SMPL -> H36M joint
regression and projection, and the pose augmentations.

Conventions: keypoints are (..., K, 3) with channels (x, y, z), x the image
column and y the row. "patch" coords are pixels of the square crop,
optionally normalized so x, y, z lie in [-1, 1] (divided by side - 1);
"image" coords are pixels of the full camera image plus metric depth in mm;
"world" coords are mm under the camera extrinsics x_cam = R x_world + t.
``trans`` is the 2x3 affine mapping image to patch pixels.

The products that the JAX package runs at ``Precision.HIGHEST`` are fp32
product sums here (``_batch_matmul``), or, where a broadcast product would
not fit (the SMPL vertices), matmuls with TF32 off (``matmul_fp32``).

Each random op has a pure core that takes its draws as tensors
(``rotate_z``, ``flip_3d_from``, ``truncated_normal_from``,
``rule_transformation_from``) and a wrapper that draws them from an explicit
``torch.Generator`` on the tensors' device. The JAX package's draws can be
fed to a core, so a core is held to JAX exactly.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


def make_coordinate_grid(height: int, width: int, dtype=torch.float32,
                         device=None):
    """[-1, 1]^2 grid of shape (H, W, 2), channels (x, y)."""
    x = torch.linspace(-1.0, 1.0, width, dtype=dtype, device=device)
    y = torch.linspace(-1.0, 1.0, height, dtype=dtype, device=device)
    return torch.stack([x[None, :].expand(height, width),
                        y[:, None].expand(height, width)], dim=-1)

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
    xy = _rows(inv, xy)
    z = z * depth_scale + pelvis[..., 2][..., None]
    return torch.cat([xy, z[..., None]], dim=-1)


def convert_image_to_world(kps, fx, fy, u, v, trans, rot):
    """Pinhole back-projection, then camera -> world: R^-1 (x_cam - t).

    fx/fy/u/v (B, 1); trans (B, 3); rot (B, 3, 3)."""
    z = kps[..., 2]
    x = (kps[..., 0] - u) / fx * z
    y = (kps[..., 1] - v) / fy * z
    cam = torch.stack([x, y, z], dim=-1) - trans[..., None, :]
    return _rows(torch.linalg.inv(rot), cam)


def convert_image_to_patch(kps, trans, image_depth: int, image_height: int,
                           image_width: int, depth_scale, pelvis,
                           is_norm: bool = True):
    """Inverse of convert_patch_to_image."""
    z = (kps[..., 2] - pelvis[..., 2][..., None]) / depth_scale
    xy = _rows(trans[..., :, :2], kps[..., :2]) + trans[..., None, :, 2]
    x, y = xy[..., 0], xy[..., 1]
    if is_norm:
        x = x / (image_width - 1) * 2.0 - 1.0
        y = y / (image_height - 1) * 2.0 - 1.0
        z = z / (image_depth - 1)
    return torch.stack([x, y, z], dim=-1)


def convert_world_to_image(kps, fx, fy, u, v, trans, rot):
    """World -> camera (R x + t), then the pinhole projection."""
    cam = _rows(rot, kps) + trans[..., None, :]
    z = cam[..., 2]
    x = cam[..., 0] / z * fx + u
    y = cam[..., 1] / z * fy + v
    return torch.stack([x, y, z], dim=-1)


def convert_patch_to_world(keypoints, trans_image, pelvis, k_mat,
                           trans_world, rot_world, image_width: int,
                           image_height: int, is_norm: bool = True,
                           rect_width: float = 2000.0, mono: bool = False,
                           patch: bool = True):
    """Full patch -> world chain for one camera batch.

    The image side is passed explicitly (the JAX package reads it from the
    shape of an image batch); depth uses the width, as there. ``patch``
    False takes `keypoints` as image coordinates already; ``mono`` True
    returns the reference's visualization-only fake world instead of the
    camera back-projection: z + 128, the axes as (x, z, y), negated
    (reference: modules/util.py:128-152)."""
    if patch:
        kp_img = convert_patch_to_image(
            keypoints, trans_image, image_width, image_height, image_width,
            rect_width / image_width, pelvis, is_norm=is_norm,
        )
    else:
        kp_img = keypoints
    if mono:
        kp_world = torch.cat([kp_img[..., :2], kp_img[..., 2:] + 128.0], -1)
        return -kp_world[..., [0, 2, 1]]
    return convert_image_to_world(
        kp_img, k_mat[..., 0, [0]], k_mat[..., 1, [1]], k_mat[..., 0, [2]],
        k_mat[..., 1, [2]], trans_world, rot_world,
    )


def image_side(shape) -> int:
    """Width of an image batch of `shape`, NHWC (a trailing channel count of
    1 or 3) or NCHW, as the JAX package's _img_side reads it."""
    if len(shape) == 4 and shape[-1] in (1, 3):
        return int(shape[-2])
    return int(shape[-1])


def image_height(shape) -> int:
    """Height of an image batch of `shape` (the JAX package's _img_height)."""
    if len(shape) == 4 and shape[-1] in (1, 3):
        return int(shape[-3])
    return int(shape[-2])


def convert_world_to_patch(keypoints, trans_image, pelvis, k_mat,
                           trans_world, rot_world, image_width: int,
                           image_height: int, is_norm: bool = True,
                           rect_width: float = 2000.0):
    """Full world -> patch chain for one camera batch (the inverse of
    convert_patch_to_world); depth uses the width, as there."""
    kp_img = convert_world_to_image(
        keypoints, k_mat[..., 0, [0]], k_mat[..., 1, [1]], k_mat[..., 0, [2]],
        k_mat[..., 1, [2]], trans_world, rot_world)
    return convert_image_to_patch(kp_img, trans_image, image_width,
                                  image_height, image_width,
                                  rect_width / image_width, pelvis,
                                  is_norm=is_norm)


def _batch_matmul(a, b):
    """(..., I, J) @ (..., J, L) as fp32 products and sums: exact fp32
    whatever the card's TF32 setting (the JAX package's HIGHEST)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _rows(m, kps):
    """m (..., I, J) applied to each row of kps (..., K, J): (..., K, I),
    fp32 products and sums (einsum '...ij,...kj->...ki' at HIGHEST)."""
    return (m[..., None, :, :] * kps[..., :, None, :]).sum(dim=-1)


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul_fp32(a, b):
    """torch.matmul with TF32 off: fp32 products and sums where a broadcast
    product would be too large to hold (the JAX package's HIGHEST)."""
    with _no_tf32():
        return torch.matmul(a, b)


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


# ---------------------------------------------------------------- SMPL side

# after the SMPL -> H36M regressor: the L/R limb blocks 11-13 and 14-16
# swap places
_H36M_ORDER = list(range(11)) + [14, 15, 16, 11, 12, 13]


def smpl_to_h36m(verts, h36m_regressor):
    """17 H36M joints regressed from SMPL vertices (B, V, 3) by the (17, V)
    regressor, L/R swapped, the thorax (mean of the shoulders) appended, and
    centred on the pelvis: (B, 18, 3)."""
    joints = matmul_fp32(h36m_regressor, verts)[:, _H36M_ORDER]
    thorax = joints[:, [11, 14]].mean(dim=1, keepdim=True)
    joints = torch.cat([joints, thorax], dim=1)
    return joints - joints[:, :1]


def convert_pelvis_to_world(x: dict, mode: str):
    """Camera-frame pelvis of camera `mode` in `x` -> world, (B, 1, 3)."""
    pelvis = x[f"{mode}_pelvis"][:, None, :]
    trans_world = x[f"{mode}_trans_world"]
    return _rows(torch.linalg.inv(x[f"{mode}_rot_world"]),
                 pelvis - trans_world[:, None, :])


def project_smpl_to_patch_kps(global_rot_params, pose_params, shape_params,
                              smpl_forward, h36m_regressor, x: dict,
                              mode: str, convert_verts: bool = False):
    """SMPL forward with a zero root rotation (the global rotation
    (B, 3, 3) applied after the regressor), m -> mm, placed at the sample's
    world pelvis, projected to patch pixels of camera `mode` (its batch
    tensors ``<mode>_{img,trans_image,pelvis,k_mat,trans_world,rot_world}``
    in `x`). ``smpl_forward(pose72, betas10) -> (verts, joints)``. With
    ``convert_verts`` returns the world vertices in mm instead."""
    batch = pose_params.shape[0]
    full_pose = torch.cat([pose_params.new_zeros((batch, 3)), pose_params],
                          dim=1)
    verts, _ = smpl_forward(full_pose, shape_params)
    pelvis = convert_pelvis_to_world(x, mode)
    if convert_verts:
        return matmul_fp32(verts, global_rot_params) * 1000.0 + pelvis
    joints = _batch_matmul(smpl_to_h36m(verts, h36m_regressor),
                           global_rot_params) * 1000.0 + pelvis
    shape = x[f"{mode}_img"].shape
    return convert_world_to_patch(
        joints, x[f"{mode}_trans_image"], x[f"{mode}_pelvis"],
        x[f"{mode}_k_mat"], x[f"{mode}_trans_world"], x[f"{mode}_rot_world"],
        image_width=image_side(shape), image_height=image_height(shape),
        is_norm=False)


# ------------------------------------------------------ pose augmentations


def rotate_z(keypoints, u):
    """Each pose (B, K, 3) rotated about the z axis by (u - 0.5) * pi / 2,
    u (B,) uniform in [0, 1): row vectors, kps @ R."""
    angle = (u - 0.5) * 0.5 * math.pi
    c, s = torch.cos(angle), torch.sin(angle)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, -s, zeros], dim=-1),
                       torch.stack([s, c, zeros], dim=-1),
                       torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)
    return _batch_matmul(keypoints, rot)


def random_rotation_3d(keypoints, generator: torch.Generator | None = None):
    """rotate_z by an angle uniform in [-pi/4, pi/4] per pose, drawn from
    `generator` on the keypoints' device."""
    u = torch.rand(keypoints.shape[0], generator=generator,
                   device=keypoints.device)
    return rotate_z(keypoints, u)


_FLIP_LEGS = [0, 4, 5, 6, 1, 2, 3] + list(range(7, 18))
_FLIP_ARMS = list(range(11)) + [14, 15, 16, 11, 12, 13, 17]


def flip_3d_from(keypoints, u):
    """The L/R leg joint blocks swapped when the uniform u < 0.5, else the
    arm blocks (the poses' K is 17 or 18)."""
    k = keypoints.shape[1]
    legs = keypoints[:, _FLIP_LEGS[:k]]
    arms = keypoints[:, _FLIP_ARMS[:k]]
    return torch.where(u < 0.5, legs, arms)


def flip_3d(keypoints, generator: torch.Generator | None = None):
    """flip_3d_from with one uniform drawn from `generator`."""
    return flip_3d_from(keypoints, torch.rand((), generator=generator,
                                              device=keypoints.device))


def truncated_normal_from(pos, neg, mean, ignore, u_ignore, u_sign, normal):
    """The rule-based half-truncated normal from its draws: the positive
    branch (width `pos`) when the uniform u_sign < 0.5, else the negative
    one (`neg`); |N(0, (width / 1.96)^2)| clipped to the width, signed by
    the branch, plus `mean`; 0 where the branch's width equals the mean;
    all 0 when the uniform u_ignore < `ignore`. pos, neg, mean, ignore and
    the uniforms broadcast against the normals."""
    use_pos = u_sign < 0.5
    pos, neg, mean, ignore = (torch.as_tensor(v, dtype=normal.dtype,
                                              device=normal.device)
                              for v in (pos, neg, mean, ignore))
    width = torch.where(use_pos, pos, neg)
    flag = torch.where(use_pos, 1.0, -1.0)
    sample = torch.clamp(normal * (width / 1.96), -width, width)
    out = sample.abs() * flag + mean
    zero = torch.zeros((), dtype=normal.dtype, device=normal.device)
    degenerate = torch.where(use_pos, pos == mean, neg == mean)
    out = torch.where(degenerate, zero, out)
    return torch.where(u_ignore < ignore, zero, out)


def my_truncated_normal(pos: float, neg: float, size=(1, 1),
                        ignore: float = 0.4, mean: float = 0.0,
                        generator: torch.Generator | None = None,
                        device=None):
    """truncated_normal_from with its draws (the ignore and sign uniforms,
    normals of `size`) from `generator` on `device`."""
    u_ignore = torch.rand((), generator=generator, device=device)
    u_sign = torch.rand((), generator=generator, device=device)
    normal = torch.randn(size, generator=generator, device=device)
    return truncated_normal_from(pos, neg, mean, ignore, u_ignore, u_sign,
                                 normal)


# Per-channel (72 = 24 joints x 3 axes) angle ranges in degrees of the
# rule-based SMPL pose prior: (pos, neg), (pos, neg, mean) or a single
# root bound.
RULE_RANGES = (
    (5,), (180,), (5,),
    (45, 60), (10, 10), (30, 0),
    (45, 60), (10, 10), (0, 30),
    (60, 20), (30, 30), (30, 30),
    (70, 0), (20, 20), (10, 10),
    (70, 0), (20, 20), (10, 10),
    (20, 10), (0, 0), (15, 15),
) + ((0, 0),) * 24 + (
    (15, 15), (50, 50), (15, 15),
    (90, 90), (50, 120), (150, 30, -60),
    (90, 90), (120, 50), (30, 150, 60),
    (60, 60), (0, 120), (15, 15),
    (60, 60), (120, 0), (15, 15),
) + ((0, 0),) * 12

RULE_RANGES_NEGATIVE = (
    (5,), (180,), (5,),
    (70, 90), (10, 10), (30, 0),
    (70, 90), (10, 10), (0, 30),
    (30, 40), (30, 30), (30, 30),
    (10, 50), (20, 20), (10, 10),
    (10, 50), (20, 20), (10, 10),
    (20, 10), (0, 0), (15, 15),
) + ((0, 0),) * 24 + (
    (15, 15), (50, 50), (15, 15),
    (90, 90), (50, 120), (150, 30, -60),
    (90, 90), (120, 50), (30, 150, 60),
    (60, 60), (0, 120), (15, 15),
    (60, 60), (120, 0), (15, 15),
) + ((0, 0),) * 12

# SMPL's shape parameters: 10 betas, |N| within 1.5, never ignored
NUM_BETAS = 10
_BETA = (1.5, 1.5, 0.0, 0.0)


def _rule_constants(ranges) -> np.ndarray:
    """(4, R) rows pos, neg, mean (radians) and the ignore share of each
    range: a single bound is symmetric and never ignored."""
    deg = math.pi / 180.0
    rows = []
    for r in ranges:
        if len(r) == 1:
            rows.append((r[0] * deg, r[0] * deg, 0.0, 0.0))
        else:
            rows.append((r[0] * deg, r[1] * deg,
                         r[2] * deg if len(r) == 3 else 0.0, 0.4))
    return np.asarray(rows, np.float64).T


def rule_draws(batch_size: int, generator: torch.Generator | None = None,
               device=None) -> dict:
    """The draws of rule_transformation: per range and for the betas (the
    last entry) an ignore and a sign uniform, the normals of each range
    (R, B) and the betas' (B, 10)."""
    n = len(RULE_RANGES) + 1
    return dict(
        u_ignore=torch.rand(n, generator=generator, device=device),
        u_sign=torch.rand(n, generator=generator, device=device),
        normal=torch.randn((n - 1, batch_size), generator=generator,
                           device=device),
        beta_normal=torch.randn((batch_size, NUM_BETAS), generator=generator,
                                device=device))


def rule_transformation_from(draws: dict, gen_negative: bool = False):
    """SMPL (pose (B, 72), betas (B, 10)) from the hand-tuned per-joint
    prior, from rule_draws' draws."""
    normal = draws["normal"]
    pos, neg, mean, ignore = (
        torch.as_tensor(c, dtype=normal.dtype, device=normal.device)[:, None]
        for c in _rule_constants(RULE_RANGES_NEGATIVE if gen_negative
                                 else RULE_RANGES))
    pose = truncated_normal_from(pos, neg, mean, ignore,
                                 draws["u_ignore"][:-1, None],
                                 draws["u_sign"][:-1, None], normal)
    beta = truncated_normal_from(*_BETA, draws["u_ignore"][-1],
                                 draws["u_sign"][-1], draws["beta_normal"])
    return pose.T, beta


def rule_transformation(batch_size: int,
                        generator: torch.Generator | None = None,
                        gen_negative: bool = False, device=None):
    """rule_transformation_from on draws from `generator` on `device`."""
    return rule_transformation_from(rule_draws(batch_size, generator, device),
                                    gen_negative)
