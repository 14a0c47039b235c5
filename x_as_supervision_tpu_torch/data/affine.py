"""Crop-affine construction and joint transforms of the host pipeline: the
port's own copy of the JAX package's data/affine.py.

Same geometry as the reference's imglib (reference:
human_utils/common/imglib/affine.py): a rotation-augmented 3-point affine
from a source box to the destination patch, with the 2x2 solved linearly in
numpy instead of cv2.getAffineTransform on synthesized points (the three
correspondences define the same map).
"""

from __future__ import annotations

import numpy as np


def cv2_module():
    """OpenCV, which the real datasets' image reads and crops need; raises
    naming the package where it is missing."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the real datasets need OpenCV: the cv2 package "
                          "(opencv-python) is not installed") from e
    return cv2


def norm_rot_angle(rot: float) -> float:
    while rot > 180:
        rot -= 360
    while rot <= -180:
        rot += 360
    return rot


def rotate_2d(pt, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array(
        [pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs], dtype=np.float32
    )


def gen_affine_trans_from_box(
    c_x, c_y, src_width, src_height, dst_width, dst_height,
    scale: float = 1.0, rot: float = 0.0, inv: bool = False,
) -> np.ndarray:
    """2x3 affine mapping the (scaled, rotated) source box onto the patch.
    Reference: affine.py:56-94."""
    rot_rad = np.pi * rot / 180.0
    src_down = rotate_2d(np.array([0, src_height * scale * 0.5]), rot_rad)
    src_right = rotate_2d(np.array([src_width * scale * 0.5, 0]), rot_rad)
    src_center = np.array([c_x, c_y], dtype=np.float64)

    dst_center = np.array([dst_width * 0.5, dst_height * 0.5])
    dst_down = np.array([0.0, dst_height * 0.5])
    dst_right = np.array([dst_width * 0.5, 0.0])

    # A maps the box frame onto the patch frame: A @ [right, down] = [r', d']
    src_basis = np.stack([src_right, src_down], axis=1)  # (2, 2)
    dst_basis = np.stack([dst_right, dst_down], axis=1)
    if inv:
        a = src_basis @ np.linalg.inv(dst_basis)
        t = src_center - a @ dst_center
    else:
        a = dst_basis @ np.linalg.inv(src_basis)
        t = dst_center - a @ src_center
    return np.concatenate([a, t[:, None]], axis=1).astype(np.float64)


def warp_patch(img: np.ndarray, trans: np.ndarray, patch_width: int,
               patch_height: int, nearest: bool = False) -> np.ndarray:
    """cv2.warpAffine crop (the host pipeline's hot path)."""
    cv2 = cv2_module()
    flags = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    return cv2.warpAffine(
        img, trans.astype(np.float32), (int(patch_width), int(patch_height)),
        flags=flags,
    )


def gen_patch_image_from_box(
    img: np.ndarray, c_x, c_y, bb_width, bb_height, patch_width, patch_height,
    do_flip: bool, scale: float, rot: float,
):
    """Optionally h-flip then affine-crop. Reference: affine.py:97-114."""
    if do_flip:
        img = img[:, ::-1, :]
        c_x = img.shape[1] - c_x - 1
    trans = gen_affine_trans_from_box(
        c_x, c_y, bb_width, bb_height, patch_width, patch_height, scale, rot
    )
    patch = warp_patch(np.ascontiguousarray(img), trans, patch_width,
                       patch_height)
    return patch, trans


def trans_points_3d(joints: np.ndarray, trans: np.ndarray,
                    depth_scale: float) -> np.ndarray:
    """Vectorized xy-affine + z scale. Reference: affine.py:30-35."""
    out = joints.copy().astype(np.float64)
    out[:, :2] = out[:, :2] @ trans[:, :2].T + trans[:, 2]
    out[:, 2] = out[:, 2] * depth_scale
    return out


def fliplr_joints(joints, joints_vis, width, matched_parts):
    """Horizontal flip + L/R pair swap. Reference: affine.py:38-53."""
    joints = joints.copy()
    joints_vis = joints_vis.copy()
    joints[:, 0] = width - joints[:, 0] - 1
    for a, b in matched_parts:
        joints[[a, b]] = joints[[b, a]]
        joints_vis[[a, b]] = joints_vis[[b, a]]
    return joints, joints_vis
