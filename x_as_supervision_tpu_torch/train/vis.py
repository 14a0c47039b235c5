"""Host-side visualization helpers for the TensorBoard panels: the port's
own numpy copy of the JAX package's train/vis.py (reference:
train_util.py:108-227, human_utils/common/visualization/pose.py). Every
image is returned CHW uint8 for the event writer.

``cv2`` and ``matplotlib`` are imported inside the functions that use them,
so the module imports on a machine without them. Without ``cv2``,
``pose_vis`` returns its image with no skeleton drawn, as the JAX package
does; without ``matplotlib`` the figure panels (``pose_vis_3d``,
``dis_vis``, ``depth_heatmap_vis``) cannot be drawn, and ``missing()`` says
so before anyone calls them.
"""

from __future__ import annotations

import functools
import importlib

import numpy as np

# cv2 draws the 2D skeletons over pose panels; matplotlib the figure
# panels (3D poses, depth strips, geodesic maps)
OPTIONAL = ("cv2", "matplotlib")


@functools.cache
def _module(name: str):
    """The imported package `name`, or None where it does not import."""
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def missing() -> tuple:
    """The optional packages (of OPTIONAL) that do not import here."""
    return tuple(name for name in OPTIONAL if _module(name) is None)


def _cv2():
    return _module("cv2")


def _plt():
    matplotlib = _module("matplotlib")
    if matplotlib is None:
        raise ImportError("matplotlib is needed for the figure panels")
    matplotlib.use("Agg")
    return importlib.import_module("matplotlib.pyplot")


def _fig_to_chw(plt, fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return buf.transpose(2, 0, 1).copy()


def draw_skeleton_2d(img, pose, parent_ids=None, flip_pairs=None):
    """Draw joints (+bones) on an HWC uint8 image in place."""
    cv2 = _cv2()
    left = set()
    if (flip_pairs is not None and np.size(flip_pairs)
            and np.max(flip_pairs) < pose.shape[0]):
        left = {int(a) for a, _ in flip_pairs}
    for j in range(pose.shape[0]):
        x, y = int(round(pose[j, 0])), int(round(pose[j, 1]))
        color = (0, 0, 255) if j in left else (0, 255, 0)
        if cv2 is not None:
            cv2.circle(img, (x, y), 3, color, -1)
        if parent_ids is not None:
            p = int(parent_ids[j]) if j < len(parent_ids) else j
            px, py = int(round(pose[p, 0])), int(round(pose[p, 1]))
            if cv2 is not None:
                cv2.line(img, (x, y), (px, py), (255, 255, 0), 1)
    return img


def pose_vis(pose, size, flip_pairs, parent_ids=None, is_gt=False, img=None,
             mean=None, std=None):
    """2D pose overlay. pose: (K, 2) normalized [-1,1] unless is_gt.
    Input img is NHWC (one sample, HWC). Reference: train_util.py:108-138."""
    pose = np.array(pose, dtype=np.float64)
    if not is_gt:
        pose = (pose + 1) / 2.0
        pose[:, 0] *= size[0] - 1
        pose[:, 1] *= size[1] - 1

    if img is None:
        img = np.ones([size[0], size[1], 3]) * 255.0
    else:
        img = np.array(img, dtype=np.float64)
        if mean is not None and std is not None:
            img = img * np.asarray(std)[None, None, :] + np.asarray(mean)[
                None, None, :
            ]
        if np.max(img) < 128:
            img = img * 255.0
    img = np.ascontiguousarray(np.clip(img, 0, 255), dtype=np.uint8)
    draw_skeleton_2d(img, pose, parent_ids, flip_pairs)
    return img.transpose(2, 0, 1)


def pose_vis_3d(keypoints_3d, flip_pairs, parent_ids=None, ref_keypoints=None):
    """3D skeleton matplotlib plot. Reference: train_util.py:140-154."""
    plt = _plt()
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    _plot_skeleton_3d(ax, np.asarray(keypoints_3d), parent_ids)
    if ref_keypoints is not None:
        _plot_skeleton_3d(ax, np.asarray(ref_keypoints), parent_ids, color="k")
    return _fig_to_chw(plt, fig)


def _plot_skeleton_3d(ax, kps, parent_ids, color="b"):
    ax.scatter(kps[:, 0], kps[:, 1], kps[:, 2], c=color, s=8)
    if parent_ids is not None:
        for j in range(min(len(parent_ids), kps.shape[0])):
            p = int(parent_ids[j])
            ax.plot(
                [kps[j, 0], kps[p, 0]],
                [kps[j, 1], kps[p, 1]],
                [kps[j, 2], kps[p, 2]],
                c=color,
                linewidth=1,
            )


def img_vis(img, mean=None, std=None):
    """HWC float image -> CHW uint8. Reference: train_util.py:156-167."""
    img = np.array(img, dtype=np.float64)
    if img.ndim == 2:
        img = img[..., None]
    if mean is not None and std is not None and img.shape[-1] == len(mean):
        img = img * np.asarray(std)[None, None, :] + np.asarray(mean)[
            None, None, :
        ]
    if np.max(img) < 128:
        img = img * 255.0
    img = np.clip(img, 0, 255).astype(np.uint8)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img.transpose(2, 0, 1)


def dis_vis(distance, centers):
    """Geodesic weight map + seed markers. Reference: train_util.py:169-185."""
    plt = _plt()
    fig = plt.figure()
    plt.imshow(np.asarray(distance).squeeze(), interpolation="nearest")
    for center in np.atleast_2d(np.asarray(centers)):
        plt.scatter(center[0], center[1], c="r", s=5)
    return _fig_to_chw(plt, fig)


def depth_heatmap_vis(depth_map, gt_pose_2d, depth_scale=256, heat_w=6,
                      heat_h=6):
    """Per-joint depth-marginal strips with GT depth markers.
    Reference: train_util.py:187-227."""
    plt = _plt()
    import matplotlib.colors as mcolors

    depth_map = np.asarray(depth_map)
    gt_pose_2d = np.asarray(gt_pose_2d)
    k, h = depth_map.shape
    gt_depth = np.clip((gt_pose_2d[:, 2] / depth_scale + 1) / 2, 0, 1) * h

    cmap = mcolors.ListedColormap(["white", "red"])
    norm = mcolors.BoundaryNorm([0, 1, 2], cmap.N)

    fig, axes = plt.subplots(nrows=heat_h, ncols=heat_w, figsize=(10, 4))
    for i in range(min(k, (heat_h // 2) * heat_w)):
        strip = np.tile(depth_map[[i]], (10, 1))
        mask = np.zeros_like(strip)
        loc = int(gt_depth[i])
        mask[:, min(loc, h - 1)] = 1.0
        mask[:, max(0, min(loc, h - 1) - 1)] = 1.0
        r, c = (i // heat_w) * 2, i % heat_w
        axes[r, c].imshow(strip, cmap="Reds")
        axes[r, c].set_xticks([]), axes[r, c].set_yticks([])
        axes[r + 1, c].imshow(mask, cmap=cmap, norm=norm)
        axes[r + 1, c].set_xticks([]), axes[r + 1, c].set_yticks([])
    plt.tight_layout()
    return _fig_to_chw(plt, fig)
