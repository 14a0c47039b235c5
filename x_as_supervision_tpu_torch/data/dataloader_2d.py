"""Mono-camera 2D datasets, TikTok video frames and MPII validation: the
port's own copy of the JAX package's data/dataloader_2d.py (the same
samples from the same files and seed).

Reference: human_utils/dataloader/dataloader_2d.py:17-276. These feed the
2D path (``python -m x_as_supervision_tpu_torch.train2d3d`` and ``.eval2d``):
the batch dict carries a single ``cam_mono_*`` view with identity camera
parameters, which routes the composed model through its mono branch
(models/composed.py; reference modules/model.py:51-55,73-75).

Color augmentation is cv2 / numpy: the reference's torchvision menu of
jitter / equalize / blur / invert at the same 0.6 application rate, drawn
from the sample's rng in the JAX package's order. OpenCV is imported where
an image is read (affine.cv2_module).

One difference from the JAX package, on purpose: TikTok's pseudo-image
holder sets ``uint8_feed = False``. The JAX package builds that holder with
``PatchDataset.__new__`` and never sets the attribute, so with the pseudo
stream on (config/TikTok_Multi_S1.yaml) its first sample raises
AttributeError in ``generate_pseudo_smpl_data``. False is the fp32 feed the
JAX holder would take had it the attribute, so the port trains the shipped
TikTok config with its pseudo stream.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from . import affine as AF
from .geodesic import compute_geodesic_dis
from .loader import BatchAssembly

TIKTOK_TRAIN_VIDEOS = [
    34, 35, 36, 37, 40, 42, 43, 44, 45, 58, 59, 61, 62, 63, 76, 77, 104, 107,
    112, 140, 142, 144, 146, 152, 158, 165, 195, 208, 221, 234, 238, 249,
    251, 257, 275, 277, 280, 283, 303, 313, 323,
]
TIKTOK_VALID_VIDEOS = [326]


def center_padding(img: np.ndarray) -> np.ndarray:
    """Zero-pad the (portrait) frame to a square. Reference:
    dataloader_2d.py:18-27."""
    assert img.shape[0] > img.shape[1]
    length = img.shape[0]
    pad = np.zeros((length, length, img.shape[2]), dtype=img.dtype)
    start = (length - img.shape[1]) // 2
    pad[:, start : start + img.shape[1], :] = img
    return pad


def generate_mono_item(smp: dict, ct_padding: bool = True,
                       use_mask_center: bool = True,
                       patch_size: int = 256):
    """Load frame + mask, optionally square-pad and crop around the mask
    bbox, normalize. Returns (HWC img, HW1 mask, 2x3 affine).
    Reference: dataloader_2d.py:29-87."""
    cv2 = AF.cv2_module()
    cvimg = cv2.imread(
        smp["image"], cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
    )
    if not isinstance(cvimg, np.ndarray):
        raise IOError(f"Fail to read {smp['image']}")
    cvmask = cv2.imread(
        smp["mask"], cv2.IMREAD_GRAYSCALE | cv2.IMREAD_IGNORE_ORIENTATION
    )[..., None]
    if cvmask.shape[:2] != cvimg.shape[:2]:
        cvmask = cv2.resize(
            cvmask, (cvimg.shape[1], cvimg.shape[0]),
            interpolation=cv2.INTER_NEAREST,
        )[..., None]

    if ct_padding:
        cvimg = center_padding(cvimg)
        cvmask = center_padding(cvmask)

    if use_mask_center:
        ys, xs = np.nonzero(cvmask[..., 0] == 255)
        tl = (max(0, xs.min() - 20), max(0, ys.min() - 20))
        br = (min(cvimg.shape[1], xs.max() + 20),
              min(cvimg.shape[0], ys.max() + 20))
        center_x = (tl[0] + br[0]) / 2
        center_y = (tl[1] + br[1]) / 2
        width = height = max(br[0] - tl[0], br[1] - tl[1])
    else:
        center_x, center_y = smp["center_x"], smp["center_y"]
        width, height = smp["width"], smp["height"]

    img_patch, trans = AF.gen_patch_image_from_box(
        cvimg, center_x, center_y, width, height, patch_size, patch_size,
        False, 1.0, 0.0,
    )
    img_patch = img_patch[..., ::-1].astype(np.float32) / 255.0
    mask_patch = AF.warp_patch(cvmask, trans, patch_size, patch_size)
    return img_patch, mask_patch[..., None].astype(np.float32), trans


def data_color_aug(img_hwc: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """TikTok training color menu at 0.6 rate: jitter / equalize / blur /
    invert. Reference: dataloader_2d.py:170-186 (torchvision menu)."""
    if rng.random() < 0.4:
        return img_hwc
    cv2 = AF.cv2_module()
    choice = rng.integers(0, 4)
    img8 = np.clip(img_hwc * 255.0, 0, 255).astype(np.uint8)
    if choice == 0:  # color jitter
        b = rng.uniform(0.5, 1.5)
        c = rng.uniform(0.8, 1.2)
        out = np.clip((img8.astype(np.float32) - 127.5) * c + 127.5 * b, 0, 255)
        img8 = out.astype(np.uint8)
    elif choice == 1:  # equalize per channel
        img8 = np.stack(
            [cv2.equalizeHist(img8[..., i]) for i in range(3)], axis=-1
        )
    elif choice == 2:  # gaussian blur
        k = int(rng.choice([5, 7, 9]))
        img8 = cv2.GaussianBlur(img8, (k, k), float(rng.uniform(0.1, 5.0)))
    else:  # invert
        img8 = 255 - img8
    return img8.astype(np.float32) / 255.0


def _identity_camera(out: dict) -> None:
    out["cam_mono_k_mat"] = np.eye(3, dtype=np.float32)
    out["cam_mono_pelvis"] = np.zeros(3, np.float32)
    out["cam_mono_rot_world"] = np.eye(3, dtype=np.float32)
    out["cam_mono_trans_world"] = np.zeros(3, np.float32)


class TikTok_dataset(BatchAssembly):
    """Video-frame mono dataset. Reference: dataloader_2d.py:89-230."""

    def __init__(self, data_path, geodesic_param_list, smpl_pseudo_img,
                 norm_param, mode="train", rect_3d_width=256, seed=0):
        self.mode = mode
        videos = TIKTOK_TRAIN_VIDEOS if mode == "train" else TIKTOK_VALID_VIDEOS
        self.data_db = []
        for v in videos:
            frames = sorted(glob.glob(
                os.path.join(data_path, f"{v:05d}", "images", "*.png")
            ))
            self.data_db += frames[20:-20]
        self.geodesic_param_list = geodesic_param_list
        self.rect_3d_width = rect_3d_width
        self.mean = norm_param["mean"]
        self.std = norm_param["std"]
        self.seed = seed
        if smpl_pseudo_img is not None:
            from .pipeline import PatchDataset

            holder = PatchDataset.__new__(PatchDataset)
            holder.rect_3d_width = rect_3d_width
            holder.mean, holder.std = self.mean, self.std
            holder.cam_id_list = ["mono"]
            holder.is_train = mode == "train"
            # the fp32 feed; the JAX package's holder lacks the attribute
            # (see the module docstring)
            holder.uint8_feed = False
            holder._setup_pseudo(smpl_pseudo_img)
            self._pseudo_holder = holder
        else:
            self._pseudo_holder = None

    def sample(self, index: int) -> dict:
        rng = np.random.default_rng((self.seed * 7919 + index) % (2**63))
        img_path = self.data_db[index]
        img, mask, _ = generate_mono_item(
            {"image": img_path, "mask": img_path.replace("images", "masks")}
        )
        if self.mode == "train":
            img = data_color_aug(img, rng)

        out = {
            "cam_mono_img_ori": img.astype(np.float32),
            "cam_mono_mask": mask / 255.0,
            "cam_mono_img_path": img_path,
        }
        out["cam_mono_img"] = out["cam_mono_img_ori"] * out["cam_mono_mask"]
        mask_chw = np.transpose(out["cam_mono_mask"], (2, 0, 1))
        dis, center = compute_geodesic_dis(
            mask_chw, img_path, self.geodesic_param_list
        )
        out["cam_mono_geodesic_dis"] = np.transpose(dis, (1, 2, 0)).astype(
            np.float32
        )
        out["cam_mono_geodesic_center"] = np.asarray(center, np.float32)
        _identity_camera(out)
        trans = np.zeros((2, 3), np.float32)
        trans[0, 0] = trans[1, 1] = 1.0
        out["cam_mono_trans_image"] = trans

        if self._pseudo_holder is not None and \
                self._pseudo_holder.use_smpl_pseudo_img:
            self._pseudo_holder.generate_pseudo_smpl_data(out, rng)
        return out

    __getitem__ = sample

    def __len__(self):
        return len(self.data_db)


class mpii_dataset(BatchAssembly):
    """MPII validation mono dataset. Reference: dataloader_2d.py:234-276."""

    def __init__(self, database, mode="valid", patch_size: int = 256):
        assert mode == "valid", "only used for validation"
        self.data_db = database.gt_db()
        self.patch_size = patch_size

    def sample(self, index: int) -> dict:
        smp = self.data_db[index]["cam_mono"]
        img, mask, trans = generate_mono_item(
            smp, ct_padding=False, use_mask_center=False,
            patch_size=self.patch_size,
        )
        out = {
            "cam_mono_img_ori": img.astype(np.float32),
            "cam_mono_mask": mask / 255.0,
            "cam_mono_img_path": smp["image"],
        }
        out["cam_mono_img"] = out["cam_mono_img_ori"] * out["cam_mono_mask"]

        joints = smp["joints_3d"].copy()
        joints[:, :2] = joints[:, :2] @ trans[:, :2].T + trans[:, 2]
        out["cam_mono_joints"] = joints.astype(np.float32)
        _identity_camera(out)
        out["cam_mono_trans_image"] = trans.astype(np.float32)
        out["cam_mono_head_size"] = np.float32(smp["head_size"])
        return out

    __getitem__ = sample

    def __len__(self):
        return len(self.data_db)
