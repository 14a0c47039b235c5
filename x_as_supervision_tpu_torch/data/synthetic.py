"""In-memory synthetic dataset fixture: the port's own copy of the JAX
package's data/synthetic.py (numpy only; same samples for the same seed).

Produces batches with the cam_<id>_* key schema of the real pipeline, from
procedurally generated stick-figure images and masks and plausible cameras,
so the training path runs with no downloaded data.
"""

from __future__ import annotations

import numpy as np

H36M_PARENT_IDS = [0, 0, 1, 2, 0, 4, 5, 0, 17, 8, 9, 17, 11, 12, 17, 14, 15, 7]
NUM_JOINTS = 18


def _random_pose(rng: np.random.Generator) -> np.ndarray:
    """A vaguely humanoid 3D pose in mm, pelvis-centered."""
    base = {
        0: (0, 0, 0), 1: (-120, 50, 0), 2: (-130, 480, 0), 3: (-140, 900, 0),
        4: (120, 50, 0), 5: (130, 480, 0), 6: (140, 900, 0),
        7: (0, -250, 0), 17: (0, -480, 0), 8: (0, -560, 0), 9: (0, -660, 0),
        10: (0, -760, 0), 11: (-200, -450, 0), 12: (-420, -420, 0),
        13: (-640, -400, 0), 14: (200, -450, 0), 15: (420, -420, 0),
        16: (640, -400, 0),
    }
    pose = np.zeros((NUM_JOINTS, 3))
    for j, xyz in base.items():
        pose[j] = xyz
    pose += rng.normal(scale=40.0, size=pose.shape)
    return pose


def _camera(rng: np.random.Generator, distance: float = 5000.0):
    angle = rng.uniform(0, 2 * np.pi)
    # Camera looks at the origin from a ring of radius `distance`.
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    trans = np.array([0.0, 0.0, distance])
    k = np.array(
        [[1100.0, 0, 500.0], [0, 1100.0, 500.0], [0, 0, 1]]
    )
    return k, rot, trans


def _project(pose_world, k, rot, trans):
    cam = pose_world @ rot.T + trans
    uv = cam[:, :2] / cam[:, 2:3] * np.array([k[0, 0], k[1, 1]]) + np.array(
        [k[0, 2], k[1, 2]]
    )
    return np.concatenate([uv, cam[:, 2:3]], axis=1)


def _stick_mask(joints_px, size):
    """Binary mask by rasterizing thick bones (uint8 -> float)."""
    mask = np.zeros((size, size), np.float32)
    for j, p in enumerate(H36M_PARENT_IDS):
        a, b = joints_px[j, :2], joints_px[p, :2]
        n = 24
        for t in np.linspace(0, 1, n):
            pt = a * (1 - t) + b * t
            x, y = int(round(pt[0])), int(round(pt[1]))
            r = 3
            y0, y1 = max(0, y - r), min(size, y + r + 1)
            x0, x1 = max(0, x - r), min(size, x + r + 1)
            if y0 < y1 and x0 < x1:
                mask[y0:y1, x0:x1] = 1.0
    return mask


class SyntheticPoseDataset:
    """Deterministic synthetic multi-camera pose samples."""

    def __init__(
        self,
        num_samples: int = 64,
        cam_id_list=(0, 1, 2, 3),
        patch_size: int = 64,
        rect_3d_width: float = 2000.0,
        seed: int = 0,
        with_pseudo: bool = True,
    ):
        self.num_samples = num_samples
        self.cam_id_list = tuple(cam_id_list)
        self.size = patch_size
        self.rect = rect_3d_width
        self.with_pseudo = with_pseudo
        self._rng = np.random.default_rng(seed)
        # Fixed cameras per dataset (like a capture studio).
        self._cams = {
            c: _camera(np.random.default_rng(seed + 100 + i))
            for i, c in enumerate(self.cam_id_list)
        }

    def __len__(self):
        return self.num_samples

    def sample(self, idx: int) -> dict:
        rng = np.random.default_rng(hash((idx, 7)) % (2**32))
        pose_world = _random_pose(rng)
        s = self.size
        out = {"act": f"act_{2 + idx % 15:02d}"}
        for cam in self.cam_id_list:
            k, rot, trans = self._cams[cam]
            img_kps = _project(pose_world, k, rot, trans)
            pelvis = img_kps[0].copy()

            # Crop affine: center the pelvis, scale a 2000mm box to the patch.
            span_px = self.rect / pelvis[2] * k[0, 0]
            scale = s / span_px
            t = np.array(
                [s / 2 - scale * pelvis[0], s / 2 - scale * pelvis[1]]
            )
            affine = np.array(
                [[scale, 0, t[0]], [0, scale, t[1]]], dtype=np.float64
            )

            patch_xy = img_kps[:, :2] * scale + t
            depth = (img_kps[:, 2] - pelvis[2]) / (self.rect / s)
            joints = np.concatenate([patch_xy, depth[:, None]], axis=1)

            mask = _stick_mask(joints, s)
            img = np.stack([mask] * 3, axis=-1)
            img = img + rng.normal(scale=0.05, size=img.shape)

            ck = f"cam_{cam}"
            out[f"{ck}_img"] = img.astype(np.float32)
            out[f"{ck}_joints"] = joints.astype(np.float32)
            out[f"{ck}_k_mat"] = k.astype(np.float32)
            out[f"{ck}_pelvis"] = pelvis.astype(np.float32)
            out[f"{ck}_rot_world"] = rot.astype(np.float32)
            out[f"{ck}_trans_world"] = trans.astype(np.float32)
            out[f"{ck}_trans_image"] = affine.astype(np.float32)
            out[f"{ck}_mask"] = mask[..., None].astype(np.float32)
            out[f"{ck}_geodesic_dis"] = (1.0 + mask)[..., None].astype(
                np.float32
            )
            if self.with_pseudo:
                pj = joints.copy()
                pj[:, 0] = pj[:, 0] / (s - 1) * 2 - 1
                pj[:, 1] = pj[:, 1] / (s - 1) * 2 - 1
                pj[:, 2] = pj[:, 2] / (s - 1)
                out[f"{ck}_pseudo_img"] = img.astype(np.float32)
                out[f"{ck}_pseudo_joints"] = pj.astype(np.float32)
        return out

    def batch(self, start: int, batch_size: int) -> dict:
        samples = [
            self.sample((start + i) % self.num_samples)
            for i in range(batch_size)
        ]
        out = {}
        for key in samples[0]:
            if key == "act":
                out[key] = [s[key] for s in samples]
            else:
                out[key] = np.stack([s[key] for s in samples])
        return out

    def device_batch(self, start: int, batch_size: int) -> dict:
        """Batch with host-only fields stripped (jit-traceable pytree)."""
        b = self.batch(start, batch_size)
        b.pop("act", None)
        return b

    def batch_from_indices(self, indices) -> dict:
        samples = [self.sample(int(i)) for i in indices]
        out = {}
        for key in samples[0]:
            if key == "act":
                continue
            out[key] = np.stack([s[key] for s in samples])
        return out


class SyntheticMonoDataset:
    """Mono-camera (TikTok-shaped) synthetic fixture: cam_mono_* keys with
    identity camera, stick-figure masks, and a pseudo stream."""

    def __init__(self, num_samples: int = 32, patch_size: int = 64,
                 seed: int = 0, with_pseudo: bool = True):
        self._multi = SyntheticPoseDataset(
            num_samples, cam_id_list=(0,), patch_size=patch_size, seed=seed,
            with_pseudo=with_pseudo,
        )
        self.size = patch_size

    def __len__(self):
        return len(self._multi)

    def sample(self, idx: int) -> dict:
        src = self._multi.sample(idx)
        out = {
            "cam_mono_img": src["cam_0_img"],
            "cam_mono_img_ori": src["cam_0_img"],
            "cam_mono_mask": src["cam_0_mask"],
            "cam_mono_geodesic_dis": src["cam_0_geodesic_dis"],
            "cam_mono_k_mat": np.eye(3, dtype=np.float32),
            "cam_mono_pelvis": np.zeros(3, np.float32),
            "cam_mono_rot_world": np.eye(3, dtype=np.float32),
            "cam_mono_trans_world": np.zeros(3, np.float32),
            "cam_mono_trans_image": np.array(
                [[1, 0, 0], [0, 1, 0]], np.float32
            ),
        }
        if "cam_0_pseudo_img" in src:
            out["cam_mono_pseudo_img"] = src["cam_0_pseudo_img"]
            out["cam_mono_pseudo_joints"] = src["cam_0_pseudo_joints"]
        return out

    def batch(self, start: int, batch_size: int) -> dict:
        return self.batch_from_indices(
            (start + i) % len(self) for i in range(batch_size))

    def device_batch(self, start: int, batch_size: int) -> dict:
        return self.batch(start, batch_size)

    def batch_from_indices(self, indices) -> dict:
        samples = [self.sample(int(i)) for i in indices]
        return {
            k: np.stack([s[k] for s in samples]) for k in samples[0]
        }


def synthetic_dataset(config: dict) -> SyntheticPoseDataset:
    """The fixture the train and eval CLIs use with ``--synthetic``, sized as
    the JAX package's train.py:build_dataset sizes it."""
    tp = config["train_params"]
    return SyntheticPoseDataset(
        num_samples=max(tp["batch_size"] * 4, 64),
        cam_id_list=config["dataset_params"]["cam_id_list"],
        patch_size=tp.get("patch_width", 256),
        rect_3d_width=tp.get("rect_3d_width", 2000),
    )
