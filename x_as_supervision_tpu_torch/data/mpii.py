"""MPII dataset index builder (the 2D eval path): the port's own copy of the
JAX package's data/mpii.py.

Parses the annot json and the gt .mat headboxes (PCKh head sizes), builds
center / scale crop boxes with the standard MPII adjustments (y-shift,
1.25x expansion, aspect fit), drops frames whose mask is over- or
under-exposed, and pickle-caches the mono-camera db. The cache is the JAX
package's, path and bytes (imdb.save_cache, imdb.load_cache), so either
package reads the other's.

Reference: human_utils/dataset/mpii.py:12-124.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .affine import cv2_module
from .imdb import IMDB, load_cache, save_cache
from .samples import PatchSample

MPII_JOINT_NUM = 16
MPII_FLIP_PAIRS = np.array(
    [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]], dtype=np.int32
)
MPII_PARENT_IDS = np.array(
    [1, 2, 6, 6, 3, 4, 6, 6, 7, 8, 11, 12, 7, 7, 13, 14], dtype=np.int32
)
PIXEL_STD = 200
SC_BIAS = 0.6


class mpii(IMDB):
    def __init__(self, image_set_name, dataset_path, dataset_mask_path,
                 patch_width, patch_height, extra_param, *args):
        super().__init__("MPII", image_set_name, dataset_path, patch_width,
                         patch_height, dataset_path, extra_param)
        self.joint_num = MPII_JOINT_NUM
        self.flip_pairs = MPII_FLIP_PAIRS
        self.parent_ids = MPII_PARENT_IDS
        self.aspect_ratio = patch_width * 1.0 / patch_height
        self.y_move = 15
        self.scale_expand = 1.25
        self.dataset_mask_path = dataset_mask_path

    def center_and_size(self, a, jts_3d_vis):
        c = np.array(a["center"], dtype=np.float32)
        c_x, c_y = c[0] - 1, c[1] - 1
        width = height = a["scale"] * PIXEL_STD
        # standard MPII practice: shift down and expand to keep the limbs
        c_y = c_y + self.y_move * a["scale"]
        width *= self.scale_expand
        height *= self.scale_expand
        if width >= self.aspect_ratio * height:
            width = height * self.aspect_ratio
        else:
            raise AssertionError("Invalid patch width and height")
        return c_x, c_y, width, height

    def remove_over_exposure(self, mask_path, ratio: float = 0.7) -> bool:
        cv2 = cv2_module()
        mask = cv2.imread(mask_path)
        mask = cv2.threshold(mask, 127, 255, cv2.THRESH_BINARY)[1] / 255
        area = mask.shape[0] * mask.shape[1]
        return np.sum(mask) > ratio * area or np.sum(mask) < 0.1 * area

    def gt_db(self):
        from scipy.io import loadmat

        cache_file = os.path.join(self.cache_path, self.name + "_new.pkl")
        if os.path.exists(cache_file):
            db = load_cache(cache_file)
            print(f"{self.name} gt db loaded from {cache_file}, "
                  f"{len(db)} samples are loaded")
            return db

        with open(os.path.join(
            self.dataset_path, "annot", f"mpii_{self.image_set_name}.json"
        )) as f:
            anno = json.load(f)

        gt_mat = loadmat(os.path.join(
            self.dataset_path, "annot", f"mpii_gt_{self.image_set_name}.mat"
        ))
        headboxes = gt_mat["headboxes_src"]
        headsizes = np.linalg.norm(
            headboxes[1, :, :] - headboxes[0, :, :], axis=0
        ) * SC_BIAS

        gt_db = []
        for i, a in enumerate(anno):
            jts_3d = np.zeros((self.joint_num, 3), dtype=np.float32)
            jts_3d_vis = np.zeros((self.joint_num, 1), dtype=np.float32)
            if self.image_set_name != "test":
                jts = np.array(a["joints"])
                jts[:, :2] = jts[:, :2] - 1
                jts_3d[:, :2] = jts[:, :2]
                jts_3d_vis[:, 0] = np.array(a["joints_vis"])

            c_x, c_y, width, height = self.center_and_size(a, jts_3d_vis)
            img_path = os.path.join(self.dataset_path, "images", a["image"])
            mask_path = os.path.join(self.dataset_mask_path, a["image"])

            if (
                len(jts_3d_vis) < np.sum(jts_3d_vis)
                or self.remove_over_exposure(mask_path)
                or jts_3d.min() < 0
            ):
                continue

            smp = PatchSample.full(
                img_path, c_x, c_y, width, height, 0, jts_3d, jts_3d_vis,
                self.flip_pairs, self.parent_ids,
            )
            smp.head_size = headsizes[i]
            smp.mask = mask_path
            gt_db.append({"cam_mono": smp})

        save_cache(cache_file, gt_db)
        print(f"{len(gt_db)} samples are wrote {cache_file}")
        return gt_db
