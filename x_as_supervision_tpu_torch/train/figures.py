"""Offline qualitative figure writers (matplotlib composites): the port's
own copy of the JAX package's train/figures.py, drawing through the port's
train/vis.py.

The reference's figure utilities, show2Dpose / show3Dpose and the draw*
composites that place pose-overlaid crops next to predicted and GT 3D
skeletons in a 1080p figure file (reference: eval_utils.py:68-261). No
entry point calls them, in the JAX package or here: they are paper-figure
tools, importable, and ``save_qualitative_figure`` takes an evaluator batch
and its fetched step output (train/evaluator.py: ``fetch(Evaluator.step(
...))``). matplotlib is imported where a figure is drawn (the card's
machine has none).

Differences from the reference, as in the JAX package:
  * matplotlib >= 3.8 removed `ax.w_xaxis`; pane/line styling uses the
    public `ax.xaxis.pane` API.
  * `set_aspect('equal')` on 3D axes raised NotImplementedError for years;
    `set_box_aspect((1, 1, 1))` is the working equivalent.
  * pose_vis returns CHW uint8 (the event writer's layout), transposed to
    HWC for imshow as the reference does.
"""

from __future__ import annotations

import numpy as np

from . import vis

# Bone (start, end, is_left) tables of the reference's show*pose
# (eval_utils.py:83-87, 141-143). The 3D variant drops the neck/nose bones.
_I3 = np.array([1, 2, 3, 4, 5, 6, 7, 10, 11, 12, 13, 14, 15, 16, 17])
_J3 = np.array([0, 1, 2, 0, 4, 5, 0, 17, 17, 11, 12, 17, 14, 15, 7])
_LR3 = np.array([0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 0], dtype=bool)

_I2 = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17])
_J2 = np.array([0, 1, 2, 0, 4, 5, 0, 17, 8, 9, 17, 11, 12, 17, 14, 15, 7])
_LR2 = np.array([0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0],
                dtype=bool)


def _agg():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.gridspec as gridspec
    import matplotlib.pyplot as plt

    return plt, gridspec


def show3Dpose(vals, ax, lcolor="#3498db", rcolor="#F0E68C", radius=500):
    """Draw an 18-joint skeleton on a 3D axis.
    Reference: eval_utils.py:68-126."""
    vals = np.asarray(vals)
    for i in range(len(_I3)):
        x, y, z = [
            np.array([vals[_I3[i], j], vals[_J3[i], j]]) for j in range(3)
        ]
        ax.plot(x, y, z, lw=5, c=lcolor if _LR3[i] else rcolor)

    xroot, yroot, zroot = vals[0, 0], vals[0, 1], vals[0, 2]
    ax.set_xlim3d([-radius + xroot, radius + xroot])
    ax.set_zlim3d([-radius + zroot, radius + zroot])
    ax.set_ylim3d([-radius + yroot, radius + yroot])
    ax.set_xticks([])
    ax.set_yticks([])
    ax.set_zticks([])
    white = (1.0, 1.0, 1.0, 0.0)
    ax.xaxis.pane.set_color(white)
    ax.yaxis.pane.set_color(white)
    ax.xaxis.line.set_color(white)
    ax.yaxis.line.set_color(white)
    ax.zaxis.line.set_color(white)
    ax.set_box_aspect((1, 1, 1))


def show2Dpose(vals, ax, lcolor="#3498db", rcolor="#e74c3c", radius=350):
    """Draw an 18-joint skeleton on a 2D axis.
    Reference: eval_utils.py:129-169."""
    vals = np.asarray(vals)
    for i in range(len(_I2)):
        x, y = [
            np.array([vals[_I2[i], j], vals[_J2[i], j]]) for j in range(2)
        ]
        ax.plot(x, y, lw=2, c=lcolor if _LR2[i] else rcolor)
    ax.set_xticks([])
    ax.set_yticks([])
    xroot, yroot = vals[0, 0], vals[0, 1]
    ax.set_xlim([-radius + xroot, radius + xroot])
    ax.set_ylim([-radius + yroot, radius + yroot])
    ax.set_aspect("equal")


def _pose_panel(ax, p2d, img, flip_pairs, parent_ids):
    panel = vis.pose_vis(
        np.asarray(p2d), (256, 256), flip_pairs, parent_ids=parent_ids,
        img=img,
    )
    ax.imshow(np.transpose(panel, (1, 2, 0)))
    ax.set_axis_off()


def draw(p2d_front, front_img, p2d_back, back_img, p3d, p3d_gt,
         output_path, flip_pairs, parent_ids):
    """Two pose-overlaid crops + predicted/GT 3D skeletons -> 1080p file.
    Reference: eval_utils.py:171-197."""
    plt, gridspec = _agg()
    fig = plt.figure(figsize=(19.2, 10.8))
    gs = gridspec.GridSpec(1, 4)
    gs.update(wspace=-0.00, hspace=0.05)

    _pose_panel(plt.subplot(gs[0]), p2d_front, front_img, flip_pairs,
                parent_ids)
    _pose_panel(plt.subplot(gs[1]), p2d_back, back_img, flip_pairs,
                parent_ids)
    show3Dpose(p3d, plt.subplot(gs[2], projection="3d"),
               lcolor="#6A5ACD", rcolor="#FFA500")
    show3Dpose(p3d_gt, plt.subplot(gs[3], projection="3d"),
               lcolor="#3498db", rcolor="#F0E68C")
    fig.savefig(output_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def draw_2d(p2d_front, front_img, p2d_back, back_img, output_path,
            flip_pairs, parent_ids):
    """Two pose-overlaid crops. Reference: eval_utils.py:199-216."""
    plt, gridspec = _agg()
    fig = plt.figure(figsize=(19.2, 10.8))
    gs = gridspec.GridSpec(1, 2)
    gs.update(wspace=-0.00, hspace=0.05)
    _pose_panel(plt.subplot(gs[0]), p2d_front, front_img, flip_pairs,
                parent_ids)
    _pose_panel(plt.subplot(gs[1]), p2d_back, back_img, flip_pairs,
                parent_ids)
    fig.savefig(output_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def draw_mono(img, p2d, p3d, output_path, flip_pairs, parent_ids):
    """Raw crop + 3D skeleton. Reference: eval_utils.py:218-234."""
    plt, gridspec = _agg()
    fig = plt.figure(figsize=(19.2, 10.8))
    gs = gridspec.GridSpec(1, 2)
    gs.update(wspace=-0.00, hspace=0.05)
    ax0 = plt.subplot(gs[0])
    ax0.imshow(np.asarray(img))
    ax0.set_axis_off()
    show3Dpose(p3d, plt.subplot(gs[1], projection="3d"),
               lcolor="#6A5ACD", rcolor="#FFA500", radius=120)
    fig.savefig(output_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def draw_mono_2d(img, p2d, output_path, flip_pairs, parent_ids):
    """Raw crop + pose overlay. Reference: eval_utils.py:236-261."""
    plt, gridspec = _agg()
    fig = plt.figure(figsize=(19.2, 10.8))
    gs = gridspec.GridSpec(1, 2)
    gs.update(wspace=-0.00, hspace=0.05)
    ax0 = plt.subplot(gs[0])
    ax0.imshow(np.asarray(img))
    ax0.set_axis_off()
    _pose_panel(plt.subplot(gs[1]), p2d, img, flip_pairs, parent_ids)
    fig.savefig(output_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def save_qualitative_figure(batch, eval_out, cam_front, cam_back,
                            output_path, flip_pairs, parent_ids,
                            sample: int = 0):
    """Convenience wrapper over `draw` taking an evaluator batch + its
    device-step output dict (train/evaluator.py:
    fetch(Evaluator.step(...)))."""
    fi = np.asarray(batch[f"cam_{cam_front}_img"][sample])
    bi = np.asarray(batch[f"cam_{cam_back}_img"][sample])
    draw(
        np.asarray(eval_out["kp_pred_2d"][f"cam_{cam_front}"][sample]),
        fi,
        np.asarray(eval_out["kp_pred_2d"][f"cam_{cam_back}"][sample]),
        bi,
        np.asarray(eval_out["tri"][sample]),
        np.asarray(eval_out["kps_world_gt"][sample]),
        output_path, flip_pairs, parent_ids,
    )
