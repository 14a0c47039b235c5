"""Per-sample patch pipeline and the dataset classes: the port's own copy
of the JAX package's data/pipeline.py (the same samples and batches from
the same files and seed).

The host-side equivalent of the reference's PatchDataset family (reference:
human_utils/dataloader/dataloader.py:17-342):

  * NHWC float32 RGB images instead of CHW (the trainer and the evaluator
    permute on the card);
  * masks / geodesic maps as (H, W, 1);
  * rng is injected per sample (deterministic, worker-count invariant) where
    the reference draws from process-global random state;
  * batches are assembled on the host by data/loader.py.

The cam_<id>_{img, joints, k_mat, pelvis, rot_world, trans_world,
trans_image, mask, geodesic_dis, geodesic_center} key schema and the
pseudo-SMPL sampling semantics match the reference exactly. OpenCV is
imported where an image is read (affine.cv2_module).
"""

from __future__ import annotations

import os

import numpy as np

from . import affine as AF
from .augment import do_augmentation
from .geodesic import compute_geodesic_dis
from .loader import BatchAssembly
from .mpi_inf_3dhp import from_mpi_inf_3dhp_to_hm36


def mask_path_for(image_path: str) -> str | None:
    """SAM-mask path rewrite. Reference: dataloader.py:31-36."""
    if "hm36" in image_path:
        return image_path.replace("hm36/images", "sam_masks/hm36").replace(
            "jpg", "png"
        )
    if "mpi_inf_3dhp" in image_path:
        return image_path.replace("images", "masks").replace(
            "mpi_inf_3dhp", "sam_masks/mpi_inf_3dhp"
        )
    return None


def generate_patch_sample_data(
    smp, patch_width, patch_height, rect_3d_width, rect_3d_height, mean, std,
    do_augment, aug_config, rng: np.random.Generator,
    as_uint8: bool = False,
):
    """Load image + SAM mask, draw augmentation, affine-crop both, normalize,
    and transform joints into patch coords (HWC RGB output).
    Reference: dataloader.py:17-91.

    as_uint8: keep image and mask in uint8 (pre-normalization, pre-/255) so
    the host->device transfer is 4x smaller; normalization happens on device
    (models/composed.py:preprocess_batch). EXACT when color augmentation is
    off: cv2.warpAffine on uint8 inputs returns uint8, so the float cast the
    normal path performs is lossless either way."""
    cv2 = AF.cv2_module()
    if rect_3d_width <= 0 or rect_3d_height <= 0:
        rect_3d_width, rect_3d_height = smp.width, smp.height

    cvimg = cv2.imread(smp.image, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if not isinstance(cvimg, np.ndarray):
        raise IOError(f"Fail to read {smp.image}")

    mpath = mask_path_for(smp.image)
    if "mpi_inf_3dhp" in smp.image:
        cvmask = cv2.imread(mpath)[..., 2]
    else:
        cvmask = cv2.imread(mpath, cv2.IMREAD_GRAYSCALE | cv2.IMREAD_IGNORE_ORIENTATION)
    if not isinstance(cvmask, np.ndarray):
        raise IOError(f"Fail to read {mpath}")

    img_width = cvimg.shape[1]

    if do_augment:
        scale, rot, do_flip, color_scale = do_augmentation(aug_config, rng)
    else:
        scale, rot, do_flip, color_scale = 1.0, 0.0, False, [1.0, 1.0, 1.0]

    # reference dataloader.py:50-54: under flip the SAMPLE rotation flips
    # sign but the freshly drawn augmentation rotation does not
    rot = rot + (-smp.rot if do_flip else smp.rot)
    rot = AF.norm_rot_angle(rot)

    img_patch, trans = AF.gen_patch_image_from_box(
        cvimg, smp.center_x, smp.center_y, smp.width, smp.height,
        patch_width, patch_height, do_flip, scale, rot,
    )
    # BGR -> RGB, HWC (NHWC-native; reference emits CHW).
    img_patch = img_patch[..., ::-1]

    # INTENTIONAL deviation (documented): the reference warps the
    # UNFLIPPED mask with the flipped-frame trans (dataloader.py:63 never
    # mirrors cvmask), leaving mask and image patch horizontally
    # misaligned whenever flip aug fires — latent in the reference because
    # every shipped config sets do_flip_aug false. We mirror the mask
    # source first, exactly like gen_patch_image_from_box_cv mirrors the
    # image, so the pair stays aligned (pinned by
    # tests/test_reference_parity_augment.py).
    mask_src = cvmask if not do_flip else cvmask[:, ::-1]
    mask_patch = AF.warp_patch(
        np.ascontiguousarray(mask_src), trans, patch_width, patch_height
    )
    if "mpi_inf_3dhp" in smp.image:
        mask_patch = cv2.GaussianBlur(mask_patch, (5, 5), 0)
        mask_patch = cv2.threshold(mask_patch, 127, 255, cv2.THRESH_BINARY)[1]
    mask_patch = mask_patch[..., None]  # (H, W, 1)

    if as_uint8:
        assert list(color_scale) == [1.0, 1.0, 1.0], (
            "uint8_feed requires color augmentation off (color_factor 0)"
        )
        img_patch = np.ascontiguousarray(img_patch)
        mask_patch = np.ascontiguousarray(mask_patch)
    else:
        img_patch = img_patch.astype(np.float32)
        mask_patch = mask_patch.astype(np.float32)
        color = np.asarray(color_scale, dtype=np.float32)
        img_patch = np.clip(img_patch * color, 0, 255)
        if mean is not None and std is not None:
            img_patch = (img_patch - np.asarray(mean, np.float32)) / np.asarray(
                std, np.float32
            )

    if do_flip:
        joints, joints_vis = AF.fliplr_joints(
            smp.joints_3d, smp.joints_3d_vis, img_width, smp.flip_pairs
        )
    else:
        joints, joints_vis = smp.joints_3d.copy(), smp.joints_3d_vis.copy()
    # depth pixel scale assumes depth == width (reference dataloader.py:83-84)
    joints = AF.trans_points_3d(
        joints, trans, 1.0 / (rect_3d_width * scale) * patch_width
    )

    return img_patch, mask_patch, joints, trans


class PatchDataset(BatchAssembly):
    """Multi-camera patch dataset over a pickle-cached index db.

    Reference: dataloader.py:94-246 (incl. db padding to a batch multiple
    and the act tag parsed from the file name)."""

    def __init__(self, database, is_train, patch_width, patch_height,
                 rect_3d_width, rect_3d_height, batch_size, mean, std,
                 aug_config, label_func, cam_id_list, geodesic_pt_list,
                 geodesic_param_list, smpl_pseudo_img, rm_bg,
                 convert_to_17kps=False, seed: int = 0,
                 uint8_feed: bool = False, compute_geodesic: bool = True):
        self.db = database[0].gt_db()
        if convert_to_17kps:
            from_mpi_inf_3dhp_to_hm36(self.db)
        self.num_samples = len(self.db)

        self.is_train = is_train
        self.do_augment = is_train
        self.patch_width = patch_width
        self.patch_height = patch_height
        self.rect_3d_width = rect_3d_width
        self.rect_3d_height = rect_3d_height
        self.batch_size = batch_size
        self.mean, self.std = mean, std
        self.aug_config = aug_config or {}
        self.cam_id_list = cam_id_list
        self.geodesic_pt_list = geodesic_pt_list
        self.geodesic_param_list = geodesic_param_list
        self.rm_bg = rm_bg
        self.seed = seed
        # uint8_feed: emit uint8 image/mask/pseudo tensors and defer
        # normalization + rm_bg to the device (4x smaller host->device
        # transfer; exact when color aug is off — see
        # generate_patch_sample_data). compute_geodesic=False skips the
        # FMM geodesic maps entirely (exact whenever no dis-map-weighted
        # loss is active; data/factory.py derives this from loss_config).
        self.uint8_feed = uint8_feed
        self.compute_geodesic = compute_geodesic

        # pad db to a batch multiple (reference dataloader.py:127-131)
        extra = len(self.db) % batch_size
        for i in range(0, batch_size - extra):
            self.db.append(self.db[i])
        self.db_length = len(self.db)

        self._setup_pseudo(smpl_pseudo_img)

    def _setup_pseudo(self, smpl_pseudo_img):
        self.use_smpl_pseudo_img = False
        if smpl_pseudo_img is None:
            return
        self.smpl_pseudo_img_path = smpl_pseudo_img["data_path"]
        self.use_smpl_pseudo_img = smpl_pseudo_img["use_flag"]
        self.use_smpl_pseudo_mask = smpl_pseudo_img["use_mask"]
        p = self.smpl_pseudo_img_path
        if "smpl_pseudo_img" in p or "smpl_part_seg_img" in p:
            self.smpl_pseudo_img_type = "no_texture"
            self.smpl_pseudo_img_info = np.load(
                os.path.join(p, "info.npy"), allow_pickle=True
            ).item()
        elif "surreal_h36m_pose" in p:
            self.smpl_pseudo_img_type = "ori_surreal"
            self.smpl_pseudo_img_info = np.load(os.path.join(p, "info.npy"))
        else:
            raise ValueError("smpl_pseudo_img_path is not supported")

    def generate_item(self, smp, cam_key, out, rng):
        img_patch, mask_patch, joints, trans = generate_patch_sample_data(
            smp, self.patch_width, self.patch_height, self.rect_3d_width,
            self.rect_3d_height, self.mean, self.std, self.do_augment,
            self.aug_config, rng, as_uint8=self.uint8_feed,
        )
        out[f"{cam_key}_img"] = (
            img_patch if self.uint8_feed else img_patch.astype(np.float32)
        )
        out[f"{cam_key}_joints"] = joints.astype(np.float32)
        out[f"{cam_key}_img_path"] = smp["image"]

        k_mat = np.zeros((3, 3), np.float32)
        k_mat[0, 0], k_mat[1, 1] = smp["fl"][0], smp["fl"][1]
        k_mat[0, 2], k_mat[1, 2] = smp["c_p"][0], smp["c_p"][1]
        k_mat[2, 2] = 1
        out[f"{cam_key}_k_mat"] = k_mat
        out[f"{cam_key}_pelvis"] = np.asarray(smp["pelvis"], np.float32)
        out[f"{cam_key}_rot_world"] = np.asarray(smp["rot_world"], np.float32)
        out[f"{cam_key}_trans_world"] = np.asarray(
            smp["trans_world"], np.float32
        )
        out[f"{cam_key}_trans_image"] = trans.astype(np.float32)
        if self.uint8_feed:
            # raw 0..255 mask; /255, normalization and rm_bg happen on
            # device (models/composed.py:preprocess_batch)
            out[f"{cam_key}_mask"] = mask_patch
        else:
            out[f"{cam_key}_mask"] = mask_patch / 255.0
            if self.rm_bg:
                out[f"{cam_key}_img"] = (
                    out[f"{cam_key}_img"] * out[f"{cam_key}_mask"]
                )

        if not self.compute_geodesic:
            return
        # geodesic maps run in (1, H, W) like the reference then move to HWC
        mask01 = mask_patch.astype(np.float32) / 255.0
        mask_chw = np.transpose(mask01, (2, 0, 1))
        centers = (
            out[f"{cam_key}_joints"][self.geodesic_pt_list]
            if len(self.geodesic_pt_list) else None
        )
        dis, center = compute_geodesic_dis(
            mask_chw, smp["image"], self.geodesic_param_list, centers=centers
        )
        out[f"{cam_key}_geodesic_dis"] = np.transpose(
            dis, (1, 2, 0)
        ).astype(np.float32)
        out[f"{cam_key}_geodesic_center"] = np.asarray(center, np.float32)

    def generate_pseudo_smpl_data(self, out, rng):
        """Random pre-rendered SURREAL draw per camera.
        Reference: dataloader.py:193-230."""
        cv2 = AF.cv2_module()
        for cam_id in self.cam_id_list:
            cam_key = f"cam_{cam_id}"
            if self.smpl_pseudo_img_type == "no_texture":
                info = self.smpl_pseudo_img_info
                it = rng.integers(0, info["max_iter_num"])
                bi = rng.integers(0, info["batch_size"])
                pc = info["cam_id_list"][rng.integers(0, len(info["cam_id_list"]))]
                img_path = os.path.join(
                    self.smpl_pseudo_img_path, "image", f"{it}_cam_{pc}_{bi}.png"
                )
                joint_path = os.path.join(
                    self.smpl_pseudo_img_path, "joints", f"{it}_cam_{pc}_{bi}.npy"
                )
                mask_path = None
            else:  # ori_surreal
                idx = int(self.smpl_pseudo_img_info[
                    rng.integers(0, len(self.smpl_pseudo_img_info))
                ])
                img_path = os.path.join(
                    self.smpl_pseudo_img_path, "image", f"image_{idx:06d}.png"
                )
                joint_path = os.path.join(
                    self.smpl_pseudo_img_path, "joints", f"joint_{idx:06d}.npy"
                )
                mask_path = os.path.join(
                    self.smpl_pseudo_img_path, "mask", f"mask_{idx:06d}.png"
                )

            pseudo_img = cv2.imread(
                img_path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
            )
            if self.use_smpl_pseudo_mask and mask_path is not None:
                pseudo_mask = cv2.imread(
                    mask_path, cv2.IMREAD_GRAYSCALE | cv2.IMREAD_IGNORE_ORIENTATION
                )
                # binarize: reference-format masks store 0/1 (reference
                # surreal_utils.py:131-136), where this is the identity; a
                # 0/255 mask would wrap the uint8 product
                # (reference dataloader.py:215 multiplies raw values).
                pseudo_img = pseudo_img * (pseudo_mask[..., None] != 0)
            pseudo_img = pseudo_img[..., ::-1]
            if self.uint8_feed:
                out[f"{cam_key}_pseudo_img"] = np.ascontiguousarray(
                    pseudo_img
                )
            else:
                pseudo_img = pseudo_img.astype(np.float32)
                if self.mean is not None and self.std is not None:
                    pseudo_img = (
                        pseudo_img - np.asarray(self.mean, np.float32)
                    ) / np.asarray(self.std, np.float32)
                out[f"{cam_key}_pseudo_img"] = pseudo_img

            pseudo_joints = np.load(joint_path).astype(np.float32)
            if self.smpl_pseudo_img_type == "ori_surreal":
                # depth meters -> normalized pixel units
                pseudo_joints[..., 2] *= 1000.0 / self.rect_3d_width
            out[f"{cam_key}_pseudo_joints"] = pseudo_joints

    def _select(self, index):
        return self.db[index]

    def sample(self, index: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + index) % (2**63)
        )
        record = self._select(index)
        out = {}
        for cam_id in self.cam_id_list:
            cam_key = f"cam_{cam_id}"
            self.generate_item(record[cam_key], cam_key, out, rng)
        if self.use_smpl_pseudo_img and self.is_train:
            self.generate_pseudo_smpl_data(out, rng)
        out["act"] = record["cam_0"]["image"].split("/")[-1][5:21]
        return out

    __getitem__ = sample

    def __len__(self):
        return self.db_length


class hm36_Dataset(PatchDataset):
    pass


class mpi_inf_3dhp_Dataset(PatchDataset):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("convert_to_17kps", True)
        super().__init__(*args, **kwargs)


class mpi_inf_3dhp_hm36_Dataset(PatchDataset):
    """Mixed MPI + H36M sampling: the first half indexes MPI, the second
    half a per-epoch reshuffled slice of H36M.
    Reference: dataloader.py:265-342 (the reference reshuffles via a
    mutable per-worker counter; we key the shuffle on an epoch integer so
    it is deterministic and worker-invariant)."""

    def __init__(self, database, is_train, *args, **kwargs):
        assert is_train, "testing not supported"
        super().__init__(database[:1], is_train, *args, **kwargs)
        # re-do db setup over both sources
        self.db0 = self.db[: self.num_samples]  # mpi (already 17kps? no)
        from_mpi_inf_3dhp_to_hm36(self.db0, use_hm_video_list=True)
        self.db1 = database[1].gt_db()
        self.num_samples0 = len(self.db0)
        self.num_samples1 = len(self.db1)
        extra = self.num_samples0 % self.batch_size
        for i in range(0, self.batch_size - extra):
            self.db0.append(self.db0[i])
        self.db_length = len(self.db0) * 2
        assert self.db_length <= len(self.db0) + len(self.db1)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _select(self, index):
        if index < len(self.db0):
            return self.db0[index]
        order = np.random.default_rng(self.seed + self.epoch).permutation(
            self.num_samples1
        )
        return self.db1[order[(index - len(self.db0)) % self.num_samples1]]
