"""Offline SURREAL -> pseudo-dataset constructor: the port's copy of the JAX
package's tools/surreal_constructor.py (after the reference's
surreal_data_construct/surreal_reader.py, surreal_utils.py and
reader_utils.py).

Sweeps SURREAL `.mp4` / `_info.mat` / `_segm.mat` segments, rebuilds the
SMPL mesh per sampled frame (gendered; the port's batched SMPL forward on
the constructor's device), regresses the 18 H36M joints, projects them with
the hard-coded Blender camera, crops a square around the pelvis box,
resizes to 256^2, drops frames where more than 4 joints fall off the body
mask, and writes `image/ mask/ joints/ info.npy`: the layout of the pseudo
stream (data/pipeline.py, 'ori_surreal').

Joints are saved with xy normalized to [-1, 1] and z in metres
(pelvis-relative); the loader converts z to pixel units at read time.

Frames are drawn from numpy's process-global generator (`np.random.seed`
before the sweep), as in the JAX package, so that both draw the same frames
from the same seed. With more than one `--workers` thread the segments race
for that generator, so which frames a segment yields depends on thread
scheduling: the sweep is reproducible only with one worker (the JAX tool
has the same property).

Usage:
  python -m x_as_supervision_tpu_torch.tools.surreal_constructor \
      --surreal_root data/surreal --smpl_root data/smpl_models \
      --out data/surreal_h36m_pose [--pseudo] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models import smpl as smpl_mod
from ..serve import resolve_device


# ---- Blender camera (hard-coded for all SURREAL renders;
#      reference: surreal_utils.py:61-111) ----

def get_intrinsic(res_x_px: int, res_y_px: int) -> np.ndarray:
    f_mm, sensor_w_mm = 60.0, 32.0
    sensor_h_mm = sensor_w_mm * res_y_px / res_x_px
    fx = f_mm * res_x_px / sensor_w_mm
    fy = f_mm * res_y_px / sensor_h_mm
    return np.array(
        [[fx, 0, res_x_px / 2], [0, fy, res_y_px / 2], [0, 0, 1]]
    )


def get_extrinsic(cam_loc: np.ndarray):
    r_world2bcam = np.array([[0, 0, 1], [0, -1, 0], [-1, 0, 0]]).T
    t_world2bcam = -r_world2bcam @ cam_loc.reshape(3, 1)
    r_bcam2cv = np.diag([1.0, -1.0, -1.0])
    r = r_bcam2cv @ r_world2bcam
    t = r_bcam2cv @ t_world2bcam
    return np.concatenate([r, t], axis=1), r, t


def _axangle_to_mat(v: np.ndarray) -> np.ndarray:
    angle = np.linalg.norm(v)
    if angle < 1e-12:
        return np.eye(3)
    k = v / angle
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * (kx @ kx)


def _mat_to_axangle(r: np.ndarray) -> np.ndarray:
    angle = math.acos(np.clip((np.trace(r) - 1) / 2, -1.0, 1.0))
    if angle < 1e-12:
        return np.zeros(3)
    axis = np.array(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]
    ) / (2 * math.sin(angle))
    return axis * angle


def rotate_body(rz_body: np.ndarray, pelvis_rotvec: np.ndarray) -> np.ndarray:
    """Compose the scene z rotation and Blender's axis fix into the global
    SMPL rotation. Reference: surreal_utils.py:48-57."""
    r_pelvis = _axangle_to_mat(pelvis_rotvec)
    r90 = _axangle_to_mat(np.array([np.pi / 2, 0, 0]))
    return _mat_to_axangle(r90 @ rz_body @ r_pelvis)


def project_vertices(points, intrinsic, extrinsic, centralize_joints=False):
    homo = np.concatenate([points, np.ones((points.shape[0], 1))], axis=1).T
    proj = (intrinsic @ (extrinsic @ homo)).T
    proj[:, :2] = proj[:, :2] / proj[:, [2]]
    if centralize_joints:
        proj[:, 2] = proj[:, 2] - proj[0, 2]
    return proj


def sample_time_idx(info, margin, sample_times, max_iter=100,
                    ignore_center=False):
    """Draw frames whose pelvis sits near the frame center with all joints
    on-screen. Reference: reader_utils.py:93-105."""
    time_list = []
    j2d = info["joints2D"]
    for _ in range(max_iter):
        t = np.random.randint(0, info["joints3D"].shape[2])
        ok = ignore_center or (
            150 <= j2d[0, 0, t] <= 170 and 110 <= j2d[1, 0, t] <= 130
            and np.all(j2d[0, :, t] >= margin) and np.all(j2d[0, :, t] <= 320)
            and np.all(j2d[1, :, t] >= 0) and np.all(j2d[1, :, t] <= 240)
        )
        if ok:
            time_list.append(t)
            if len(time_list) >= sample_times:
                break
    return time_list


def filter_incorrect_cases(mask, keypoints) -> bool:
    """> 4 joints off the body mask -> reject.
    Reference: surreal_utils.py:138-146."""
    count = 0
    for i in range(keypoints.shape[0]):
        if mask[int(keypoints[i, 1]), int(keypoints[i, 0]), 0] == 0:
            count += 1
    return count > 4


def crop_and_resize(rgb, mask, joints3d, box_lt, box_rb, target):
    """Square crop around the pelvis box + center-pad + resize, keeping
    joint pixel coords consistent. Reference: reader_utils.py:107-165."""
    import cv2

    x_start = max(0, min(box_lt[0, 0], box_rb[0, 0]))
    y_start = max(0, min(box_lt[0, 1], box_rb[0, 1]))
    x_end = min(rgb.shape[1] - 1, max(box_rb[0, 0], box_lt[0, 0]) + 1)
    y_end = min(rgb.shape[0] - 1, max(box_rb[0, 1], box_lt[0, 1]) + 1)
    width = max(x_end - x_start, y_end - y_start)
    xc, yc = (x_start + x_end) // 2, (y_start + y_end) // 2

    y0, y1 = max(0, yc - width // 2), min(rgb.shape[0] - 1, yc + width // 2)
    x0, x1 = max(0, xc - width // 2), min(rgb.shape[1] - 1, xc + width // 2)
    rgb, mask = rgb[y0:y1, x0:x1], mask[y0:y1, x0:x1]

    def center_pad(img):
        length = max(img.shape[0], img.shape[1])
        pad = np.zeros((length, length, img.shape[2]), img.dtype)
        if img.shape[0] > img.shape[1]:
            s = (length - img.shape[1]) // 2
            pad[:, s : s + img.shape[1]] = img
        else:
            s = (length - img.shape[0]) // 2
            pad[s : s + img.shape[0], :] = img
        return pad

    x_pad = (rgb.shape[0] - rgb.shape[1]) // 2 if rgb.shape[0] > rgb.shape[1] else 0
    y_pad = (rgb.shape[1] - rgb.shape[0]) // 2 if rgb.shape[1] > rgb.shape[0] else 0
    if rgb.shape[0] != rgb.shape[1]:
        rgb, mask = center_pad(rgb), center_pad(mask)

    ori = rgb.shape[0]
    rgb = cv2.resize(rgb, (target, target))
    mask = cv2.resize(mask, (target, target))
    if mask.ndim == 2:
        mask = mask[..., None]

    joints3d = joints3d.copy()
    joints3d[:, 0] = (joints3d[:, 0] - x0 + x_pad) * target / ori
    joints3d[:, 1] = (joints3d[:, 1] - y0 + y_pad) * target / ori
    return rgb, mask, joints3d


class SurrealConstructor:
    def __init__(self, smpl_root, out_path, res=(320, 240), target=256,
                 ignore_center=False, h36m_regressor=None, device=None):
        """`device`: where the SMPL forward runs (the CPU when None)."""
        self.device = torch.device("cpu" if device is None else device)
        self.models = {}
        for gender, fname in (
            (0, "smpl_female.npz"), (1, "smpl_male.npz"),
        ):
            path = os.path.join(smpl_root, fname)
            if os.path.exists(path):
                self.models[gender] = smpl_mod.load_smpl_npz(
                    path, self.device)
        self.h36m_regressor = h36m_regressor
        self.res_x, self.res_y = res
        self.margin = (self.res_x - self.res_y) // 2
        self.target = target
        self.ignore_center = ignore_center
        self.out = out_path
        self.intrinsic = get_intrinsic(self.res_x, self.res_y)
        for sub in ("image", "mask", "joints", "check_image"):
            os.makedirs(os.path.join(out_path, sub), exist_ok=True)

    def build_frame(self, info, t):
        """(image-space 18x3 H36M joints, crop box) for frame t."""
        zrot = float(np.asarray(info["zrot"]).flatten()[0])
        rz = np.array(
            [[math.cos(zrot), -math.sin(zrot), 0],
             [math.sin(zrot), math.cos(zrot), 0], [0, 0, 1]]
        )
        extrinsic, _, _ = get_extrinsic(np.asarray(info["camLoc"]).reshape(3))

        pose = np.asarray(info["pose"][:, t], np.float32).copy()
        pose[:3] = rotate_body(rz, pose[:3])
        betas = np.asarray(info["shape"][:, 0], np.float32)
        gender = int(np.asarray(info["gender"]).flatten()[0])
        model = self.models[gender]

        joints3d_world = np.asarray(info["joints3D"][:, :, t]).T

        verts, joints = smpl_mod.smpl_forward(
            model, torch.as_tensor(pose[None], device=self.device),
            torch.as_tensor(betas[None], device=self.device),
            center_idx=None,
        )
        verts = verts[0].cpu().numpy()
        joints = joints.cpu().numpy()
        root = np.asarray(joints[0, 0])
        trans = joints3d_world[0] - root
        verts = verts + trans

        h36m = np.asarray(self.h36m_regressor) @ verts
        h36m[[11, 12, 13, 14, 15, 16]] = h36m[[14, 15, 16, 11, 12, 13]]
        h36m = np.concatenate(
            [h36m, h36m[[11, 14]].mean(axis=0, keepdims=True)], axis=0
        )

        proj = project_vertices(
            h36m, self.intrinsic, extrinsic, centralize_joints=True
        )
        lt3d, rb3d = h36m[0].copy(), h36m[0].copy()
        lt3d[1:] -= 1.0
        rb3d[1:] += 1.0
        box_lt = project_vertices(lt3d[None], self.intrinsic, extrinsic)
        box_rb = project_vertices(rb3d[None], self.intrinsic, extrinsic)
        return proj, box_lt.astype(np.int16), box_rb.astype(np.int16)

    def process_segment(self, idx, info_path, sample_times=5):
        import cv2
        import scipy.io as sio

        try:
            info = sio.loadmat(info_path)
            cap = cv2.VideoCapture(info_path.replace("_info.mat", ".mp4"))
            mask_mat = sio.loadmat(info_path.replace("_info.mat", "_segm.mat"))
        except Exception:
            return []

        written = []
        times = sample_time_idx(
            info, self.margin, sample_times, ignore_center=self.ignore_center
        )
        for ii, t in enumerate(times):
            if f"segm_{t + 1}" not in mask_mat:
                continue
            joints3d, box_lt, box_rb = self.build_frame(info, t)
            cap.set(propId=1, value=t)
            ok, rgb = cap.read()
            if not ok:
                continue
            mask = mask_mat[f"segm_{t + 1}"]
            mask = (mask != 0).astype(np.uint8)[..., None]

            rgb, mask, joints3d = crop_and_resize(
                rgb, mask, joints3d, box_lt, box_rb, self.target
            )
            joints3d[:, 0] = np.clip(joints3d[:, 0], 0, mask.shape[1] - 1)
            joints3d[:, 1] = np.clip(joints3d[:, 1], 0, mask.shape[0] - 1)
            if filter_incorrect_cases(mask, joints3d[:, :2]):
                continue

            out_idx = idx * sample_times + ii
            cv2.imwrite(
                os.path.join(self.out, "image", f"image_{out_idx:06d}.png"),
                rgb,
            )
            # 0/1-valued mask PNG, matching the reference constructor's
            # convention (reference surreal_utils.py:131-136 writes 0/1;
            # the dataloader multiplies the raw uint8 values into the
            # image, reference dataloader.py:213-215, so 0/255 here would
            # wrap the uint8 product and invert the foreground).
            cv2.imwrite(
                os.path.join(self.out, "mask", f"mask_{out_idx:06d}.png"),
                mask,
            )
            joints3d[:, 0] = joints3d[:, 0] / self.target * 2 - 1
            joints3d[:, 1] = joints3d[:, 1] / self.target * 2 - 1
            np.save(
                os.path.join(self.out, "joints", f"joint_{out_idx:06d}.npy"),
                joints3d.astype(np.float32),
            )
            written.append(out_idx)
        return written


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--surreal_root", required=True)
    p.add_argument("--smpl_root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--mode", default="train")
    p.add_argument("--pseudo", action="store_true",
                   help="pre-rendered pseudo input (512^2, no center filter)")
    p.add_argument("--sample_num", type=int, default=20000)
    p.add_argument("--sample_times", type=int, default=5)
    p.add_argument("--workers", type=int, default=12)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="where the SMPL forward runs (default: the CUDA "
                        "card)")
    args = p.parse_args()
    device = resolve_device(args.device)

    np.random.seed(args.seed)
    res = (512, 512) if args.pseudo else (320, 240)

    reg = np.load(os.path.join(args.smpl_root, "J_regressor_h36m.npy"))
    ctor = SurrealConstructor(
        args.smpl_root, args.out, res=res, ignore_center=args.pseudo,
        h36m_regressor=reg, device=device,
    )

    infos = sorted(
        f for f in glob.glob(
            os.path.join(args.surreal_root, args.mode, "*", "*", "*_info.mat")
        ) + glob.glob(os.path.join(args.surreal_root, "*", "*_info.mat"))
        if "ung_" not in f
    )
    n = min(args.sample_num, len(infos))
    sampled = np.random.choice(infos, n, replace=False)

    all_written = []
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        for written in pool.map(
            lambda iv: ctor.process_segment(iv[0], iv[1], args.sample_times),
            enumerate(sampled),
        ):
            all_written.extend(written)
    np.save(os.path.join(args.out, "info.npy"), sorted(all_written))
    print(f"Total {len(all_written)} items constructed under "
          f"{n * args.sample_times} samples")


if __name__ == "__main__":
    main()
