"""The one traffic generator: synthetic multi-camera pose samples made from
the run's seed, as the parameters of a traffic file ask.

A sample is a random humanoid pose (18 joints, pelvis-centred, mm) seen by
each of the configuration's cameras, which stand on a ring of 5 m radius
around it; its crop centres the pelvis and scales a box of
``rect_3d_width`` mm to the patch. The image is the rasterized stick figure
on three channels plus Gaussian noise, the mask the figure itself, and the
pseudo stream the same image with the keypoints normalized to [-1, 1] (the
scheme of the program's own synthetic data set). Poses, cameras and crops
are drawn on the host with numpy from (seed, sample index); the masks are
rasterized on the host and the noise is drawn on the card, so that a pool
of some hundreds of images takes well under a second.

Train traffic: ``pool_batches`` batches of ``batch_per_camera`` samples on
every camera, each sample once, kept on the device as the trainer's feed
(float images; a configuration with ``dataset_params.rm_bg`` gets its
images multiplied by the mask, as its loader does).

Serve traffic: ``pool_requests`` requests of ``request_images`` uint8 RGB
crops, in pageable host memory, as a caller hands them over.
"""

from __future__ import annotations

import numpy as np
import torch

from .weights import generator

PARENTS = [0, 0, 1, 2, 0, 4, 5, 0, 17, 8, 9, 17, 11, 12, 17, 14, 15, 7]
BASE_POSE = {
    0: (0, 0, 0), 1: (-120, 50, 0), 2: (-130, 480, 0), 3: (-140, 900, 0),
    4: (120, 50, 0), 5: (130, 480, 0), 6: (140, 900, 0),
    7: (0, -250, 0), 17: (0, -480, 0), 8: (0, -560, 0), 9: (0, -660, 0),
    10: (0, -760, 0), 11: (-200, -450, 0), 12: (-420, -420, 0),
    13: (-640, -400, 0), 14: (200, -450, 0), 15: (420, -420, 0),
    16: (640, -400, 0),
}
K_MAT = np.array([[1100.0, 0, 500.0], [0, 1100.0, 500.0], [0, 0, 1]])


def _rng(seed: int, *stream) -> np.random.Generator:
    return np.random.default_rng([int(seed), *stream])


def cameras(seed: int, n: int) -> list:
    """(K, R, t) of n cameras on a ring, fixed for the seed."""
    out = []
    for i in range(n):
        a = _rng(seed, 1, i).uniform(0, 2 * np.pi)
        c, s = np.cos(a), np.sin(a)
        out.append((K_MAT, np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]]),
                    np.array([0.0, 0.0, 5000.0])))
    return out


def _mask(joints_px: np.ndarray, size: int) -> np.ndarray:
    """The stick figure: a square of side 7 px at 24 points of each bone."""
    mask = np.zeros((size, size), np.float32)
    for j, p in enumerate(PARENTS):
        for t in np.linspace(0, 1, 24):
            x, y = np.rint(joints_px[j, :2] * (1 - t) + joints_px[p, :2] * t)
            x0, x1 = max(0, int(x) - 3), min(size, int(x) + 4)
            y0, y1 = max(0, int(y) - 3), min(size, int(y) + 4)
            if x0 < x1 and y0 < y1:
                mask[y0:y1, x0:x1] = 1.0
    return mask


def sample(seed: int, idx: int, cams: list, size: int, rect: float,
           pose_noise_mm: float) -> list[dict]:
    """One pose seen by every camera: per camera its host arrays."""
    rng = _rng(seed, 2, idx)
    pose = np.array([BASE_POSE[j] for j in range(len(PARENTS))], float)
    pose += rng.normal(scale=pose_noise_mm, size=pose.shape)
    views = []
    for k, rot, trans in cams:
        cam = pose @ rot.T + trans
        img_kps = np.concatenate(
            [cam[:, :2] / cam[:, 2:3] * k[[0, 1], [0, 1]] + k[:2, 2],
             cam[:, 2:3]], axis=1)
        pelvis = img_kps[0]
        scale = size / (rect / pelvis[2] * k[0, 0])
        shift = np.array([size / 2 - scale * pelvis[0],
                          size / 2 - scale * pelvis[1]])
        joints = np.concatenate(
            [img_kps[:, :2] * scale + shift,
             ((img_kps[:, 2] - pelvis[2]) / (rect / size))[:, None]], axis=1)
        pseudo = joints.copy()
        pseudo[:, :2] = pseudo[:, :2] / (size - 1) * 2 - 1
        pseudo[:, 2] /= size - 1
        views.append({
            "mask": _mask(joints, size), "joints": joints, "k_mat": k,
            "pelvis": pelvis, "rot_world": rot, "trans_world": trans,
            "trans_image": np.array([[scale, 0, shift[0]],
                                     [0, scale, shift[1]]]),
            "pseudo_joints": pseudo})
    return views


def train_pool(config: dict, traffic: dict, seed: int, device) -> list[dict]:
    """``pool_batches`` device batches of the program's layout: per camera
    c the keys cam_<c>_img (B, S, S, 3), _mask (B, S, S, 1), _pseudo_img,
    _pseudo_joints, _joints and the calibration, all float32."""
    cam_ids = config["dataset_params"]["cam_id_list"]
    tp = config["train_params"]
    size, rect = int(tp["patch_width"]), float(tp.get("rect_3d_width", 2000))
    b = int(traffic["batch_per_camera"])
    cams = cameras(seed, len(cam_ids))
    rm_bg = bool(config["dataset_params"].get("rm_bg", False))
    noise = generator(seed, device, 2)
    pool = []
    for j in range(int(traffic["pool_batches"])):
        views = [sample(seed, j * b + r, cams, size, rect,
                        float(traffic["pose_noise_mm"])) for r in range(b)]
        batch = {}
        for i, c in enumerate(cam_ids):
            host = {k: np.stack([v[i][k] for v in views]).astype(np.float32)
                    for k in views[0][i]}
            t = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
            mask = t.pop("mask")[..., None]
            img = mask.expand(-1, -1, -1, 3) + float(traffic["image_noise"]) \
                * torch.randn((b, size, size, 3), generator=noise,
                              device=device)
            if rm_bg:
                img = img * mask
            batch.update({f"cam_{c}_{k}": v for k, v in t.items()})
            batch[f"cam_{c}_img"] = img
            batch[f"cam_{c}_pseudo_img"] = img
            batch[f"cam_{c}_mask"] = mask
        pool.append(batch)
    return pool


def serve_pool(config: dict, traffic: dict, seed: int, device) -> np.ndarray:
    """(pool_requests, request_images, S, S, 3) uint8 crops in pageable host
    memory: the figure at 200 on a background of 30, plus noise of 20."""
    tp = config["train_params"]
    size, rect = int(tp["patch_width"]), float(tp.get("rect_3d_width", 2000))
    n = int(traffic["pool_requests"]) * int(traffic["request_images"])
    cams = cameras(seed, 1)
    masks = np.stack([sample(seed, i, cams, size, rect,
                             float(traffic["pose_noise_mm"]))[0]["mask"]
                      for i in range(n)])
    m = torch.from_numpy(masks).to(device)[..., None]
    img = 30.0 + 170.0 * m + 20.0 * torch.randn(
        (n, size, size, 3), generator=generator(seed, device, 3),
        device=device)
    crops = img.clamp(0, 255).round().to(torch.uint8).cpu().numpy()
    return crops.reshape(int(traffic["pool_requests"]),
                         int(traffic["request_images"]), size, size, 3)
