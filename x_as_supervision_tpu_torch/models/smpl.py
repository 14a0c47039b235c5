"""SMPL body model as a batched tensor function, the port's copy of the JAX
package's models/smpl.py: the model arrays from the ``.npz`` that the JAX
package's tools/smpl_pkl_to_npz.py writes, Rodrigues over all 24 joints at
once, the 24-joint kinematic chain unrolled, blend shapes and linear blend
skinning as fp32 products (TF32 off, the JAX package's HIGHEST).

Outputs: (verts (B, V, 3), joints (B, 24, 3)) in metres, optionally centred
on ``center_idx``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.geometry import _batch_matmul, matmul_fp32

# the kinematic tree of random_smpl_model (SMPL's own, 24 joints)
SMPL_PARENTS = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
                17, 18, 19, 20, 21)


class SmplModel(NamedTuple):
    """Static SMPL arrays (fp32 tensors on one device)."""

    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, 10)
    posedirs: torch.Tensor  # (V, 3, 207)
    j_regressor: torch.Tensor  # (24, V)
    weights: torch.Tensor  # (V, 24)
    kintree_parents: tuple  # 24 entries; parents[0] is unused (root)
    faces: np.ndarray  # (F, 3) int, host only
    betas_mean: torch.Tensor  # (10,) default betas

    def to(self, device) -> "SmplModel":
        return self._replace(**{
            k: v.to(device) for k, v in self._asdict().items()
            if torch.is_tensor(v)})


def smpl_from_arrays(arrays: dict, device=None) -> SmplModel:
    """A SmplModel from numpy arrays under the npz's names."""
    def t(name):
        return torch.as_tensor(np.array(arrays[name], np.float32),
                               device=device)

    return SmplModel(
        v_template=t("v_template"), shapedirs=t("shapedirs"),
        posedirs=t("posedirs"), j_regressor=t("j_regressor"),
        weights=t("weights"),
        kintree_parents=tuple(int(p) for p in arrays["kintree_parents"]),
        faces=np.asarray(arrays["faces"]),
        betas_mean=(t("betas_mean") if "betas_mean" in arrays
                    else torch.zeros(10, device=device)))


def load_smpl_npz(path: str, device=None) -> SmplModel:
    with np.load(path, allow_pickle=False) as data:
        return smpl_from_arrays({k: data[k] for k in data.files}, device)


def random_smpl_model(seed: int = 0, num_verts: int = 128,
                      device=None) -> SmplModel:
    """A random model with SMPL's topology, seeded from numpy: a test and
    smoke fixture."""
    rng = np.random.default_rng(seed)

    def softmax(a):
        e = np.exp(a - a.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    return smpl_from_arrays(dict(
        v_template=rng.normal(size=(num_verts, 3)) * 0.3,
        shapedirs=rng.normal(size=(num_verts, 3, 10)) * 0.01,
        posedirs=rng.normal(size=(num_verts, 3, 207)) * 0.001,
        j_regressor=softmax(rng.normal(size=(24, num_verts))),
        weights=softmax(rng.normal(size=(num_verts, 24))),
        kintree_parents=np.asarray(SMPL_PARENTS),
        faces=np.zeros((1, 3), np.int32)), device)


def batch_rodrigues(axisang):
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3) through the
    quaternion, with the reference's ||v + 1e-8|| regularization."""
    angle = torch.linalg.norm(axisang + 1e-8, dim=-1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    w = torch.cos(half)[..., 0]
    xyz = torch.sin(half) * axis
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return rot.reshape(*axisang.shape[:-1], 3, 3)


def _with_row(rot, t):
    """(B, 3, 3) rotation and (B, 3) translation -> (B, 4, 4)."""
    top = torch.cat([rot, t[..., None]], dim=-1)
    bottom = top.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(top.shape[0], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def smpl_forward(model: SmplModel, pose_axisang, betas=None, trans=None,
                 center_idx: int | None = 0):
    """pose (B, 72) axis-angle, betas (B, 10) (the model's mean when None),
    trans (B, 3) -> (verts (B, V, 3), joints (B, 24, 3)) in metres; without
    `trans`, centred on joint `center_idx` (None: not centred)."""
    b = pose_axisang.shape[0]
    nv = model.v_template.shape[0]
    rots = batch_rodrigues(pose_axisang.reshape(b, 24, 3))
    if betas is None:
        betas = model.betas_mean[None].expand(b, -1)

    v_shaped = model.v_template[None] + matmul_fp32(
        betas, model.shapedirs.reshape(nv * 3, -1).T).view(b, nv, 3)
    joints_rest = matmul_fp32(model.j_regressor, v_shaped)  # (B, 24, 3)
    # pose-corrective blend shapes from the 23 non-root rotations minus I
    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    pose_map = (rots[:, 1:] - eye).reshape(b, 207)
    v_posed = v_shaped + matmul_fp32(
        pose_map, model.posedirs.reshape(nv * 3, -1).T).view(b, nv, 3)

    results = [_with_row(rots[:, 0], joints_rest[:, 0])]
    for i in range(1, 24):
        parent = model.kintree_parents[i]
        rel = _with_row(rots[:, i], joints_rest[:, i] - joints_rest[:, parent])
        results.append(_batch_matmul(results[parent], rel))
    g_global = torch.stack(results, dim=1)  # (B, 24, 4, 4)

    # the rest-pose joint taken out of each transform's translation
    j_h = torch.cat([joints_rest, joints_rest.new_zeros((b, 24, 1))], dim=-1)
    correction = (g_global * j_h[:, :, None, :]).sum(dim=-1)  # (B, 24, 4)
    g_adj = torch.cat([g_global[..., :3], g_global[..., 3:]
                       - correction[..., None]], dim=-1)

    # linear blend skinning: per-vertex transform sum_j w_vj G_j
    t_per_vert = matmul_fp32(model.weights, g_adj.reshape(b, 24, 16))
    v_h = torch.cat([v_posed, v_posed.new_ones((b, nv, 1))], dim=-1)
    verts = (t_per_vert.view(b, nv, 4, 4)[:, :, :3]
             * v_h[:, :, None, :]).sum(dim=-1)
    joints = g_global[..., :3, 3]

    if trans is not None:
        verts = verts + trans[:, None]
        joints = joints + trans[:, None]
    elif center_idx is not None:
        center = joints[:, center_idx:center_idx + 1]
        verts = verts - center
        joints = joints - center
    return verts, joints
