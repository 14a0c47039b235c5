"""MPI-INF-3DHP dataset index builder: the port's own copy of the JAX
package's data/mpi_inf_3dhp.py.

Parses per-(subject, sequence) annot.mat + camera.calibration, projects the
28-joint poses into the five chest-height cameras, applies the data-hygiene
filters (visibility, chair occlusion, over-exposure), and pickle-caches the
multi-camera db (the JAX package's cache path and bytes; either package
reads the other's: imdb.save_cache, imdb.load_cache). Also provides the 28->18 H36M joint mapping used by the
eval/mixed datasets.

Reference: human_utils/dataset/mpi_inf_3dhp.py (constants :15-54, mapping
:57-71, projection :73-112, subset policies :115-140, calibration parser
:157-189, filters :218-242, db build :244-322).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .affine import cv2_module
from .imdb import IMDB, load_cache, save_cache
from .samples import PatchSample

MPI_SEQ_IDX = [1, 2]
TOTAL_MPI_VIDEO_NUM = 14
USE_MPI_VIDEO_IDX = [0, 2, 4, 7, 8]  # chest-height cameras
MPI_TRAIN_SUBJECT = [1, 2, 3, 4, 5, 6]
MPI_VALID_SUBJECT = [7, 8]

MPI_TRAIN_ROOT_JT_IDX = 4
MPI_JT_NUM = 28

MPI_FLIP_PAIRS = np.array(
    [[8, 13], [9, 14], [10, 15], [11, 16], [12, 17], [18, 23], [19, 24],
     [20, 25], [21, 26], [22, 27]], dtype=np.int32,
)
MPI_PARENT_IDS = np.array(
    [0, 0, 0, 2, 3, 1, 5, 6, 5, 8, 9, 10, 11, 5, 13, 14, 15, 16, 4, 18, 19,
     20, 21, 4, 23, 24, 25, 26], dtype=np.int32,
)

INDOOR_IMAGE_RESOLUTION = [2048, 2048]

# 28-joint train order -> 18-joint H36M(+thorax) order.
MPI_TO_HM36_SELECT = [4, 23, 24, 25, 18, 19, 20, 2, 5, 6, 7, 9, 10, 11, 14,
                      15, 16, 1]


def from_mpi_inf_3dhp_to_hm36(gt_db, use_hm_video_list: bool = False):
    """In-place 28->18 joint remap per camera record; optionally renumber
    the five MPI cameras to the H36M cam_0..3 layout for the mixed dataset.
    Reference: mpi_inf_3dhp.py:57-71."""
    sel = MPI_TO_HM36_SELECT
    for sample in gt_db:
        for vid in USE_MPI_VIDEO_IDX:
            smp = sample[f"cam_{vid}"]
            smp.joints_3d = smp.joints_3d[sel]
            smp.joints_3d_vis = smp.joints_3d_vis[sel]
            smp.joints_3d_cam = smp.joints_3d_cam[sel]
    if use_hm_video_list:
        for sample in gt_db:
            sample["cam_1"] = sample["cam_2"]
            sample["cam_2"] = sample["cam_4"]
            sample["cam_3"] = sample["cam_7"]
            del sample["cam_4"], sample["cam_7"], sample["cam_8"]


def project2image(pose_3d, rect_3d_width, rect_3d_height, cam_in, im_shape):
    """Project camera-frame joints, build the pelvis box, flag off-image
    joints invisible. Reference: mpi_inf_3dhp.py:73-112."""
    im_w, im_h = im_shape
    fx, fy, cx, cy = cam_in
    pt_3d = pose_3d.copy()
    u = pt_3d[:, 0] / pt_3d[:, 2] * fx + cx
    v = pt_3d[:, 1] / pt_3d[:, 2] * fy + cy
    pt_2d = np.stack([u, v, pt_3d[:, 2]], axis=1).astype(np.float32)

    pelvis3d = pt_3d[MPI_TRAIN_ROOT_JT_IDX]
    lt = pelvis3d - [rect_3d_width / 2, rect_3d_height / 2, 0]
    rb = pelvis3d + [rect_3d_width / 2, rect_3d_height / 2, 0]
    l = lt[0] / lt[2] * fx + cx
    t = lt[1] / lt[2] * fy + cy
    r = rb[0] / rb[2] * fx + cx
    b = rb[1] / rb[2] * fy + cy

    pt_2d[:, 2] -= pelvis3d[2]
    vis = np.ones((pose_3d.shape[0], 1), dtype=np.float32)
    off = (
        (pt_2d[:, 0] < 0) | (pt_2d[:, 1] < 0)
        | (pt_2d[:, 0] >= im_w) | (pt_2d[:, 1] >= im_h)
    )
    vis[off] = 0
    return l, r, t, b, pt_2d, pt_3d.astype(np.float32), vis, pelvis3d


SUBSET_POLICIES = {
    "train": (-1, -1, MPI_TRAIN_SUBJECT),
    "train_s5": (-1, 5, MPI_TRAIN_SUBJECT),
    "train_s10": (-1, 10, MPI_TRAIN_SUBJECT),
    "valid": (-1, -1, MPI_VALID_SUBJECT),
    "valid_s10": (-1, 10, MPI_VALID_SUBJECT),
}


def parse_camera_calibration(filepath: str):
    """camera.calibration -> per-camera ([fx, fy, cx, cy], 4x4 extrinsic).
    Reference: mpi_inf_3dhp.py:157-189."""
    intr = [0 for _ in range(TOTAL_MPI_VIDEO_NUM)]
    extr = [0 for _ in range(TOTAL_MPI_VIDEO_NUM)]
    with open(filepath) as fid:
        lines = iter(fid.readlines())
    for line in lines:
        if line[:4] == "name":
            cam_id = int(line.split()[-1])
            next(lines)  # sensor
            next(lines)  # size
            next(lines)  # animated
            in_params = next(lines).strip()
            ex_params = next(lines).strip()
            assert in_params[:9] == "intrinsic"
            vals = in_params.split()[1:]
            fx, cx = float(vals[0]), float(vals[2])
            fy, cy = float(vals[5]), float(vals[6])
            assert ex_params[:9] == "extrinsic"
            ex = np.array([float(x) for x in ex_params.split()[1:]]).reshape(4, 4)
            intr[cam_id] = [fx, fy, cx, cy]
            extr[cam_id] = ex
    return intr, extr


class mpi_inf_3dhp(IMDB):
    def __init__(self, image_set_name, dataset_path, patch_width,
                 patch_height, rect_3d_width, rect_3d_height, extra_param,
                 init_mode=False, *args):
        super().__init__("MPI_INF_3DHP", image_set_name, dataset_path,
                         patch_width, patch_height, dataset_path, extra_param)
        self.joint_num = MPI_JT_NUM
        self.flip_pairs = MPI_FLIP_PAIRS
        self.parent_ids = MPI_PARENT_IDS
        self.rect_3d_width = rect_3d_width
        self.rect_3d_height = rect_3d_height

    def remove_foreground(self, image_path, points_2d) -> bool:
        """Chair-occlusion check: > 4 joints under the chair mask.
        Reference: mpi_inf_3dhp.py:218-233."""
        cv2 = cv2_module()
        chair_mask_path = image_path.replace("images", "chair_masks")
        chair_mask = cv2.imread(chair_mask_path)[..., [2]]
        chair_mask = cv2.threshold(chair_mask, 127, 255, cv2.THRESH_BINARY)[1]
        pts = points_2d.astype(np.int32)
        count = sum(1 for p in pts if chair_mask[p[1], p[0]] == 0)
        return count > 4

    def remove_over_exposure(self, image_path, ratio: float = 0.85) -> bool:
        """SAM-mask area sanity check. Reference: mpi_inf_3dhp.py:235-242."""
        cv2 = cv2_module()
        mask_path = image_path.replace("images", "masks")
        mask = cv2.imread(mask_path)[..., [2]]
        mask = cv2.threshold(mask, 127, 255, cv2.THRESH_BINARY)[1] / 255
        return np.sum(mask) > ratio * mask.shape[0] * mask.shape[1]

    def gt_db(self):
        try:
            from scipy.io import loadmat
        except ImportError as e:
            raise ImportError("MPI-INF-3DHP's annot.mat needs the scipy "
                              "package, which is not installed") from e

        if self.image_set_name not in SUBSET_POLICIES:
            raise ValueError(f"unknown mpi subset {self.image_set_name}")
        sample_num, d_step, subjects = SUBSET_POLICIES[self.image_set_name]

        cache_file = os.path.join(
            self.cache_path, self.name + "_smp_world" + str(sample_num) + ".pkl"
        )
        if os.path.exists(cache_file):
            db = load_cache(cache_file)
            print(f"{self.name} gt db loaded from {cache_file}, "
                  f"{len(db)} samples are loaded")
            return db

        gt_db = []
        for subject_id in subjects:
            for seq_id in MPI_SEQ_IDX:
                root = os.path.join(
                    self.dataset_path, f"S{subject_id}", f"Seq{seq_id}"
                )
                annotation = loadmat(os.path.join(root, "annot.mat"))
                intr, extr = parse_camera_calibration(
                    os.path.join(root, "camera.calibration")
                )

                per_cam = {}
                for vid in USE_MPI_VIDEO_IDX:
                    folder = os.path.join(root, "images", f"video_{vid}")
                    n = len(glob.glob(folder + "/*.jpg"))
                    per_cam[vid] = (folder, annotation["annot3"][vid, 0], n)

                n_frames = per_cam[USE_MPI_VIDEO_IDX[0]][2]
                idx = np.arange(n_frames)
                if sample_num > 0:
                    idx = np.random.choice(idx, sample_num, replace=False)
                elif d_step > 0:
                    idx = np.arange(n_frames, step=d_step)

                for n_img in idx:
                    smp_dict = {}
                    ok = True
                    for vid in USE_MPI_VIDEO_IDX:
                        folder, annot3, _ = per_cam[vid]
                        image_name = os.path.join(
                            folder, "frame_%06d.jpg" % (n_img + 1)
                        )
                        pose_3d = annot3[n_img].reshape(-1, 3)
                        l, r, t, b, pt_2d, pt_3d, vis, pelvis = project2image(
                            pose_3d, self.rect_3d_width, self.rect_3d_height,
                            intr[vid], INDOOR_IMAGE_RESOLUTION,
                        )
                        if (
                            np.sum(vis) < len(vis)
                            or self.remove_foreground(image_name, pt_2d)
                            or self.remove_over_exposure(image_name)
                        ):
                            ok = False
                            break
                        fx, fy, cx, cy = intr[vid]
                        smp = PatchSample.full(
                            image_name, (l + r) * 0.5, (t + b) * 0.5, r - l,
                            b - t, 0, pt_2d, vis, self.flip_pairs,
                            self.parent_ids,
                        )
                        smp.joints_3d_cam = pt_3d
                        smp.pelvis = pelvis
                        smp.fl = np.array([fx, fy])
                        smp.c_p = np.array([cx, cy])
                        smp.rot_world = extr[vid][:3, :3]
                        smp.trans_world = extr[vid][:3, 3]
                        smp_dict[f"cam_{vid}"] = smp
                    if ok:
                        gt_db.append(smp_dict)

        save_cache(cache_file, gt_db)
        print(f"{len(gt_db)} samples are wrote {cache_file}")
        return gt_db
