"""Human3.6M dataset index builder: the port's own copy of the JAX
package's data/hm36.py.

Parses the per-(sequence, camera) `annot/<seq>_ca_<cam>/matlab_meta.txt`
files (world keypoints + extrinsics + intrinsics), projects into each
camera, builds the pelvis-centered 2000mm crop box, applies the subset
sampling policy, and pickle-caches the resulting per-frame multi-camera db.

Reference: human_utils/dataset/hm36.py (constants :11-57, parser :60-98,
projection/box :163-186, subset policies :211-258, db build :306-360).
The db record schema (PatchSample keys incl. pelvis / fl / c_p / rot_world /
trans_world = -R t) is identical, and so is the cache, path and bytes, so
either package reads the other's cache (imdb.save_cache, imdb.load_cache).
"""

from __future__ import annotations

import os

import numpy as np

from .imdb import IMDB, load_cache, save_cache
from .samples import PatchSample

S_HM36_SUBJECT_NUM = 7
HM_SUBJECT_IDX = [1, 5, 6, 7, 8, 9, 11]
S_HM36_ACT_NUM = 15
HM_ACT_IDX = list(range(2, 17))
S_HM36_SUBACT_NUM = 2
HM_SUBACT_IDX = [1, 2]
S_HM36_CAMERA_NUM = 4
HM_CAMERA_IDX = [1, 2, 3, 4]

S_ORG_36_JT_NUM = 32
S_36_ROOT_JT_IDX = 0
S_36_LSH_JT_IDX = 11
S_36_RSH_JT_IDX = 14
S_36_JT_NUM = 18
S_36_FLIP_PAIRS = np.array(
    [[1, 4], [2, 5], [3, 6], [14, 11], [15, 12], [16, 13]], dtype=np.int32
)
S_36_PARENT_IDS = np.array(
    [0, 0, 1, 2, 0, 4, 5, 0, 17, 17, 8, 17, 11, 12, 17, 14, 15, 0],
    dtype=np.int32,
)

# H36M's 18 joints -> MPII's 16, the 2D path's scoring order (reference:
# hm36.py:52-57)
S_HM36_2_MPII_JT = [3, 2, 1, 4, 5, 6, 0, 17, 8, 10, 16, 15, 14, 11, 12, 13]

def cam_project(xyz, fx, fy, cx, cy):
    return xyz[..., 0] / xyz[..., 2] * fx + cx, xyz[..., 1] / xyz[..., 2] * fy + cy


def parse_hm36_meta(gt_file: str, ignore_jt_list: bool = False):
    """Parse one matlab_meta.txt: per-frame 32x3 world keypoints, camera
    extrinsics (R transposed in the file), intrinsics, image size, and the
    17-joint selection list (+thorax appended).
    Reference: hm36.py:60-98."""
    with open(gt_file) as f:
        lines = f.read().split("\n")
    image_num = int(float(lines[0]))
    img_width = float(lines[1].split(" ")[1])
    img_height = float(lines[1].split(" ")[2])
    rot = np.array([float(v) for v in lines[2].split(" ")[1:10]]).reshape(3, 3).T
    trans = np.array([float(v) for v in lines[3].split(" ")[1:4]])
    fl = np.array([float(v) for v in lines[4].split(" ")[1:3]])
    c_p = np.array([float(v) for v in lines[5].split(" ")[1:3]])
    jt_list = np.array([int(v) for v in lines[8].split(" ")[1:18]])

    kps = np.array(
        [[float(v) for v in lines[9 + i].split(" ")[1:97]]
         for i in range(image_num)]
    )
    kps = kps.reshape(kps.shape[0], kps.shape[1] // 3, 3)

    if not ignore_jt_list:
        kps = kps[:, jt_list - 1, :]
        thorax = (
            kps[:, S_36_LSH_JT_IDX, :] + kps[:, S_36_RSH_JT_IDX, :]
        ) * 0.5
        kps = np.concatenate([kps, thorax[:, None, :]], axis=1)

    return kps, trans, jt_list, rot, fl, c_p, img_width, img_height


def world_to_patch_record(
    n_img, joint_num, rot, keypoints, trans, fl, c_p, rect_3d_width,
    rect_3d_height,
):
    """Project world joints into the camera, build the pelvis-centered
    2000mm box in 2D, return (box, 2D joints w/ pelvis-relative depth,
    camera-frame 3D, vis, pelvis).
    Reference: hm36.py:163-186 (vectorized)."""
    pt_3d = (keypoints[n_img] - trans) @ rot.T
    u, v = cam_project(pt_3d, fl[0], fl[1], c_p[0], c_p[1])
    pt_2d = np.stack([u, v, pt_3d[:, 2]], axis=1).astype(np.float32)

    pelvis3d = pt_3d[S_36_ROOT_JT_IDX]
    lt = pelvis3d - [rect_3d_width / 2, rect_3d_height / 2, 0]
    rb = pelvis3d + [rect_3d_width / 2, rect_3d_height / 2, 0]
    l, t = cam_project(lt, fl[0], fl[1], c_p[0], c_p[1])
    r, b = cam_project(rb, fl[0], fl[1], c_p[0], c_p[1])

    pt_2d[:, 2] -= pelvis3d[2]
    vis = np.ones((joint_num, 1), dtype=np.float32)
    return l, r, t, b, pt_2d, pt_3d.astype(np.float32), vis, pelvis3d


def _folder_name(subject_id, act_id, subact_id):
    return "s_%02d_act_%02d_subact_%02d" % (
        HM_SUBJECT_IDX[subject_id], HM_ACT_IDX[act_id], HM_SUBACT_IDX[subact_id]
    )


def all_folders(subject_list):
    subjects = list(subject_list) or list(range(S_HM36_SUBJECT_NUM))
    return [
        _folder_name(s, a, sa)
        for s in subjects
        for a in range(S_HM36_ACT_NUM)
        for sa in range(S_HM36_SUBACT_NUM)
    ]


# image_set -> (sample_num, step, folder_start, folder_end, subjects)
SUBSET_POLICIES = {
    "train": (200, -1, 0, 150, [0, 1, 2, 3, 4]),
    "trainfull": (-1, 1, 0, 150, [0, 1, 2, 3, 4]),
    "trainselect": (0, 10, 0, 150, [0, 1, 2, 3, 4]),
    "train_selected": (200, -1, 0, 150, [0, 1, 2, 3, 4]),
    "valid": (40, -1, 0, 60, [5, 6]),
    "validlarge": (150, 1, 0, 60, [5, 6]),
    "validfull": (-1, 1, 0, 60, [5, 6]),
    # single-folder debug subset (s_09_act_02_subact_01, every frame) for
    # miniature on-disk datasets; no reference analogue (it hardcodes the
    # production splits only).
    "mini": (-1, 1, 0, 1, [5]),
    # self-rendered accuracy-campaign splits (tools/render_campaign.py):
    # train = first 12 folders of s_01, valid = first 6 of s_09, every
    # frame; no reference analogue (the reference hardcodes the
    # production Human3.6M splits only).
    "campaign_train": (-1, 1, 0, 12, [0]),
    "campaign_valid": (-1, 1, 0, 6, [5]),
    # scaled round-4 campaign splits: all 30 folders of one subject
    # (15 actions x 2 subacts), so every per-action eval bucket is
    # populated (eval_utils per-action tables).
    "campaign_train_xl": (-1, 1, 0, 30, [0]),
    "campaign_valid_xl": (-1, 1, 0, 30, [5]),
}

# Actions dropped by the train_selected policy (reference: hm36.py:343-346).
TRAIN_SELECTED_DROP = ("act_04", "act_06", "act_09", "act_11")


class hm36(IMDB):
    def __init__(self, image_set_name, dataset_path, patch_width,
                 patch_height, rect_3d_width, rect_3d_height, extra_param,
                 init_mode=False, *args):
        super().__init__("HM36", image_set_name, dataset_path, patch_width,
                         patch_height, dataset_path, extra_param)
        self.joint_num = S_36_JT_NUM if not init_mode else S_ORG_36_JT_NUM
        self.flip_pairs = S_36_FLIP_PAIRS
        self.parent_ids = S_36_PARENT_IDS
        assert rect_3d_width * patch_height == rect_3d_height * patch_width
        self.rect_3d_width = rect_3d_width
        self.rect_3d_height = rect_3d_height
        self.num_samples_single = 0

    def _load_frame(self, n_img, folder_cam, rot, keypoints, trans, fl, c_p):
        image_name = os.path.join(
            folder_cam, "%s_%06d.jpg" % (folder_cam, n_img + 1)
        )
        i_name = os.path.join(self.dataset_path, "images", image_name)
        l, r, t, b, pt_2d, pt_3d, vis, pelvis = world_to_patch_record(
            n_img, self.joint_num, rot, keypoints, trans, fl, c_p,
            self.rect_3d_width, self.rect_3d_height,
        )
        smp = PatchSample.full(
            i_name, (l + r) * 0.5, (t + b) * 0.5, r - l, b - t, 0, pt_2d,
            vis, self.flip_pairs, self.parent_ids,
        )
        smp.joints_3d_cam = pt_3d
        smp.pelvis = pelvis
        smp.fl = fl
        smp.c_p = c_p
        smp.rot_world = rot
        smp.trans_world = -rot @ trans
        return smp

    def gt_db(self):
        if self.image_set_name not in SUBSET_POLICIES:
            raise ValueError(f"Unknown hm36 sub set {self.image_set_name}")
        sample_num, step, f_start, f_end, subjects = SUBSET_POLICIES[
            self.image_set_name
        ]
        folders = all_folders(subjects)

        cache_file = os.path.join(
            self.cache_path,
            self.name + "_kpt_smp_world" + str(sample_num) + ".pkl",
        )
        if os.path.exists(cache_file):
            db = load_cache(cache_file)
            print(f"{self.name} gt db loaded from {cache_file}, "
                  f"{len(db)} samples are loaded")
            self.num_samples_single = len(db)
            return db

        gt_db = []
        for n_folder in range(f_start, min(f_end, len(folders))):
            folder = folders[n_folder]
            per_cam = {}
            for cam in range(S_HM36_CAMERA_NUM):
                meta = os.path.join(
                    self.dataset_path, "annot",
                    "{}_ca_{:02d}".format(folder, HM_CAMERA_IDX[cam]),
                    "matlab_meta.txt",
                )
                per_cam[cam] = parse_hm36_meta(meta)
                assert per_cam[cam][0].shape[1] == self.joint_num

            n_frames = per_cam[0][0].shape[0]
            if sample_num > 0:
                img_index = np.random.choice(n_frames, min(sample_num, n_frames),
                                             replace=False)
            else:
                img_index = np.arange(n_frames)[::max(step, 1)]

            if self.image_set_name == "train_selected" and any(
                tag in folder for tag in TRAIN_SELECTED_DROP
            ):
                continue

            for n_img in img_index:
                smp_dict = {}
                for cam in range(S_HM36_CAMERA_NUM):
                    kps, trans, _, rot, fl, c_p, _, _ = per_cam[cam]
                    smp_dict[f"cam_{cam}"] = self._load_frame(
                        n_img,
                        "{}_ca_{:02d}".format(folder, HM_CAMERA_IDX[cam]),
                        rot, kps, trans, fl, c_p,
                    )
                gt_db.append(smp_dict)

        save_cache(cache_file, gt_db)
        print(f"{len(gt_db)} samples are wrote {cache_file}")
        self.num_samples_single = len(gt_db)
        return gt_db
