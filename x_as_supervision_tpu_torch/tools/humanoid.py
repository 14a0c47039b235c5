"""Procedural articulated humanoid in SMPL format, and its splat renders:
the port's copy of the JAX package's tools/humanoid.py.

The real SMPL model files are license-gated, but the self-rendered accuracy
campaign (S1 pseudo-supervision -> S2 unsupervised finetune -> eval) needs
a body model whose silhouette tracks its pose: the recons and physique
losses supervise the detector through the rendered body mask. This module
builds a deterministic "capsule human": a valid SmplModel (LBS weights,
joint regressor, SMPL's 24-joint kinematic tree) whose vertices flesh out
every bone as a capsule point cloud, plus an H36M 17-joint regressor in the
layout the SURREAL constructor expects (the arms in pre-swap order: the
constructor swaps rows 11-13 with 14-16).

Rendering splats the posed vertices as depth-scaled filled circles, so
every pixel of the silhouette is driven by the SMPL forward and the mask
deforms with the pose.
"""

from __future__ import annotations

import numpy as np

from ..models.smpl import SmplModel, smpl_from_arrays

# Standard SMPL 24-joint kinematic tree (parents[0] unused/root).
SMPL_PARENTS = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19, 20, 21)

# Rest-pose joint locations, meters, SMPL convention (y up, +x = left).
REST_JOINTS = np.array([
    [0.00, 0.00, 0.00],    # 0  pelvis
    [0.07, -0.09, 0.00],   # 1  L hip
    [-0.07, -0.09, 0.00],  # 2  R hip
    [0.00, 0.11, 0.00],    # 3  spine1
    [0.10, -0.48, 0.00],   # 4  L knee
    [-0.10, -0.48, 0.00],  # 5  R knee
    [0.00, 0.23, 0.00],    # 6  spine2
    [0.11, -0.88, 0.00],   # 7  L ankle
    [-0.11, -0.88, 0.00],  # 8  R ankle
    [0.00, 0.29, 0.00],    # 9  spine3
    [0.13, -0.94, 0.11],   # 10 L foot
    [-0.13, -0.94, 0.11],  # 11 R foot
    [0.00, 0.46, 0.00],    # 12 neck
    [0.05, 0.40, 0.00],    # 13 L collar
    [-0.05, 0.40, 0.00],   # 14 R collar
    [0.00, 0.60, 0.03],    # 15 head
    [0.17, 0.44, 0.00],    # 16 L shoulder
    [-0.17, 0.44, 0.00],   # 17 R shoulder
    [0.43, 0.42, 0.00],    # 18 L elbow
    [-0.43, 0.42, 0.00],   # 19 R elbow
    [0.68, 0.42, 0.00],    # 20 L wrist
    [-0.68, 0.42, 0.00],   # 21 R wrist
    [0.76, 0.42, 0.00],    # 22 L hand
    [-0.76, 0.42, 0.00],   # 23 R hand
], np.float64)

# Per-bone flesh radius (meters) at the CHILD end; parent-end radius is
# taken from the parent's bone so limbs taper smoothly.
BONE_RADIUS = {
    1: 0.085, 2: 0.085, 3: 0.105,           # hips, lower spine
    4: 0.060, 5: 0.060, 6: 0.115,           # thighs->knee, mid spine
    7: 0.042, 8: 0.042, 9: 0.110,           # shins->ankle, chest
    10: 0.035, 11: 0.035,                   # feet
    12: 0.045, 13: 0.075, 14: 0.075,        # neck, collars
    15: 0.095,                              # head
    16: 0.055, 17: 0.055,                   # shoulders
    18: 0.042, 19: 0.042,                   # upper arm -> elbow
    20: 0.034, 21: 0.034,                   # forearm -> wrist
    22: 0.030, 23: 0.030,                   # hands
}

# H36M-17 rows -> SMPL joints, PRE-swap arm order (see module docstring):
# rows 11-13 carry the RIGHT arm and 14-16 the LEFT so that the
# constructor's swap lands LShoulder/LElbow/LWrist at 11-13.
H36M17_FROM_SMPL = [
    0,   # 0  root/pelvis
    2,   # 1  RHip
    5,   # 2  RKnee
    8,   # 3  RAnkle
    1,   # 4  LHip
    4,   # 5  LKnee
    7,   # 6  LAnkle
    6,   # 7  torso (spine2)
    12,  # 8  neck
    -1,  # 9  nose = mid(neck, head), special-cased below
    15,  # 10 head
    17,  # 11 (pre-swap) RShoulder
    19,  # 12 (pre-swap) RElbow
    21,  # 13 (pre-swap) RWrist
    16,  # 14 (pre-swap) LShoulder
    18,  # 15 (pre-swap) LElbow
    20,  # 16 (pre-swap) LWrist
]


def _orthobasis(axis: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Two unit vectors perpendicular to `axis`."""
    a = axis / (np.linalg.norm(axis) + 1e-9)
    helper = np.array([0.0, 0.0, 1.0])
    if abs(a @ helper) > 0.9:
        helper = np.array([1.0, 0.0, 0.0])
    u = np.cross(a, helper)
    u /= np.linalg.norm(u) + 1e-9
    return u, np.cross(a, u)


def make_humanoid_smpl(stations: int = 7, ring: int = 6,
                       device=None) -> tuple[SmplModel, np.ndarray,
                                             np.ndarray]:
    """Build the capsule-human SmplModel, its fp32 tensors on `device` (the
    CPU when None).

    Returns (SmplModel, h36m_regressor (17, V), vert_radii (V,)).
    Vertex order: 2 dedicated verts per joint (48), then bone capsules.
    """
    verts, weights_rows, radii = [], [], []
    eps = 1e-4

    # dedicated joint verts (pin the joint regressor exactly)
    for j in range(24):
        for sgn in (-1.0, 1.0):
            v = REST_JOINTS[j].copy()
            v[0] += sgn * eps
            verts.append(v)
            w = np.zeros(24)
            w[j] = 1.0
            weights_rows.append(w)
            radii.append(0.0)  # never rendered

    # capsule flesh along every bone
    for j in range(1, 24):
        p = SMPL_PARENTS[j]
        r_child = BONE_RADIUS[j]
        r_parent = BONE_RADIUS.get(p, r_child)
        a, b = REST_JOINTS[p], REST_JOINTS[j]
        axis = b - a
        if np.linalg.norm(axis) < 1e-6:
            axis = np.array([0.0, 1.0, 0.0])
        u, w_perp = _orthobasis(axis)
        for f in np.linspace(0.12, 0.97, stations):
            center = a * (1 - f) + b * f
            r_here = r_parent * (1 - f) + r_child * f
            for k in range(ring):
                ang = 2 * np.pi * (k + (0.5 if int(f * 100) % 2 else 0)) / ring
                v = center + r_here * 0.6 * (
                    np.cos(ang) * u + np.sin(ang) * w_perp
                )
                verts.append(v)
                wt = np.zeros(24)
                wt[j] = f
                wt[p] = 1 - f
                weights_rows.append(wt)
                radii.append(r_here)

    # extra head dome above the head joint
    head = REST_JOINTS[15]
    for dy in (0.04, 0.09, 0.13):
        for k in range(ring):
            ang = 2 * np.pi * k / ring
            v = head + np.array(
                [0.05 * np.cos(ang), dy, 0.05 * np.sin(ang)]
            )
            verts.append(v)
            wt = np.zeros(24)
            wt[15] = 1.0
            weights_rows.append(wt)
            radii.append(0.085)

    v_template = np.asarray(verts)
    n_verts = len(verts)
    weights = np.asarray(weights_rows)

    j_regressor = np.zeros((24, n_verts))
    for j in range(24):
        j_regressor[j, 2 * j] = 0.5
        j_regressor[j, 2 * j + 1] = 0.5

    # shape modes: 0 = uniform scale, 1 = height stretch, rest tiny noise
    shapedirs = np.zeros((n_verts, 3, 10))
    shapedirs[:, :, 0] = v_template * 0.05
    shapedirs[:, 1, 1] = v_template[:, 1] * 0.06
    rng = np.random.default_rng(7)
    shapedirs[:, :, 2:] = rng.normal(size=(n_verts, 3, 8)) * 0.002

    h36m = np.zeros((17, n_verts))
    for row, j in enumerate(H36M17_FROM_SMPL):
        if row == 9:  # nose = mid(neck, head)
            for jj in (12, 15):
                h36m[row, 2 * jj] = 0.25
                h36m[row, 2 * jj + 1] = 0.25
        else:
            h36m[row, 2 * j] = 0.5
            h36m[row, 2 * j + 1] = 0.5

    model = smpl_from_arrays(dict(
        v_template=v_template, shapedirs=shapedirs,
        posedirs=np.zeros((n_verts, 3, 207)), j_regressor=j_regressor,
        weights=weights, kintree_parents=np.asarray(SMPL_PARENTS),
        faces=np.zeros((1, 3), np.int32), betas_mean=np.zeros(10)), device)
    return model, h36m, np.asarray(radii, np.float32)


# ---------------- rendering ----------------

def project_points(pts_cam: np.ndarray, fx, fy, cx, cy):
    """Camera-frame points -> pixel (u, v) + depth z."""
    z = np.maximum(pts_cam[:, 2], 1e-3)
    return (pts_cam[:, 0] / z * fx + cx, pts_cam[:, 1] / z * fy + cy, z)


def _discs(u, v, z, radii, fx):
    """Each drawn vertex's disc: a vertex with flesh and at least 5 cm in
    front of the camera, its pixel centre and its radius (at least 1),
    each rounded half to even as Python's round() rounds them."""
    drawn = ~((radii <= 0) | (z <= 0.05))
    r_px = np.maximum(np.rint(radii * fx / z), 1).astype(np.int64)
    return drawn, np.rint(u).astype(np.int64), np.rint(v).astype(np.int64), \
        r_px


def splat_mask(verts_cam, radii, fx, fy, cx, cy, height, width):
    """Binary silhouette: every vertex becomes a filled circle whose pixel
    radius is its flesh radius divided by depth (pinhole)."""
    import cv2

    u, v, z = project_points(verts_cam, fx, fy, cx, cy)
    drawn, px, py, r_px = _discs(u, v, z, radii, fx)
    mask = np.zeros((height, width), np.uint8)
    for i in np.flatnonzero(drawn):
        cv2.circle(mask, (int(px[i]), int(py[i])), int(r_px[i]), 1, -1)
    return mask


def splat_shaded(verts_cam, radii, limb_ids, fx, fy, cx, cy, height, width,
                 palette, shade: bool = True):
    """'Real'-domain appearance: painter's-algorithm splats colored per
    limb and shaded by depth. Returns uint8 HxWx3 (BGR)."""
    import cv2

    u, v, z = project_points(verts_cam, fx, fy, cx, cy)
    drawn, px, py, r_px = _discs(u, v, z, radii, fx)
    colors = np.asarray(palette)[np.asarray(limb_ids) % len(palette)]
    if shade:
        zmin, zmax = z.min(), z.max() + 1e-6
        b = 1.25 - 0.5 * (z - zmin) / (zmax - zmin)
        colors = np.minimum(255, colors * b[:, None])
    colors = colors.astype(np.int64)  # truncated, as int() truncates
    img = np.zeros((height, width, 3), np.uint8)
    for i in np.argsort(-z):  # far first
        if drawn[i]:
            cv2.circle(img, (int(px[i]), int(py[i])), int(r_px[i]),
                       tuple(int(c) for c in colors[i]), -1)
    return img
