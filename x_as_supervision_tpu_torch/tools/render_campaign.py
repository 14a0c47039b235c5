"""Self-rendered accuracy-campaign dataset generator: the port's copy of the
JAX package's tools/render_campaign.py, drawing the same poses from the same
seeds (tools/prng.py is the port's copy of JAX's threefry stream), its SMPL
forward on the card unless the caller asks for the CPU.

Produces everything the S1 -> S2 training recipe consumes, from the
procedural humanoid body model (tools/humanoid.py), with no outside data:

  1. SMPL assets (<out>/smpl_models/smpl_{female,male}.npz,
     J_regressor_h36m.npy, humanoid_radii.npy)
  2. SURREAL-format segments (.mp4 / _info.mat / _segm.mat) with
     rule-sampled poses and splat-rendered masks, swept by the SURREAL
     constructor (tools/surreal_constructor.py) into the pseudo dataset
     (surreal_h36m_pose/: image/ mask/ joints/ info.npy), the S1
     supervision stream and the discriminator's "real" pose source
  3. An on-disk Human3.6M-format multi-camera dataset (annot meta files,
     images, SAM masks) for the `campaign_train` / `campaign_valid` subset
     policies (data/hm36.py): the "real" domain S2 adapts to with its
     unsupervised losses

The two domains differ in appearance (a flat-gray pseudo body against a
per-limb-colored, depth-shaded campaign body) but share the pose prior
(ops/geometry.py:rule_transformation_from) and the body model. Every hm36
folder and pseudo segment is seeded on its own and skipped when it is
already complete on disk, so a render resumed after an interruption, or
re-run after part of its output was deleted, converges to the same dataset
(campaign_manifest.py --check verifies it).

Usage:
  python -m x_as_supervision_tpu_torch.tools.render_campaign --out data/campaign
      [--device cpu]     # SMPL on the CPU; --platform cpu says the same
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import time

import numpy as np
import torch

from ..data.hm36 import SUBSET_POLICIES, all_folders
from ..models.smpl import smpl_forward
from ..ops.geometry import rule_transformation_from
from ..serve import resolve_device
from . import prng
from . import surreal_constructor as SC
from .campaign_manifest import write_manifest
from .humanoid import make_humanoid_smpl, splat_mask, splat_shaded

RES_X, RES_Y = 320, 240  # SURREAL video resolution


def _forward(model, pose, beta):
    """The SMPL forward of (B, 72) poses and (B, 10) betas on the model's
    device (fp32, TF32 off): numpy (verts, joints), not centred."""
    dev = model.v_template.device
    verts, joints = smpl_forward(
        model, torch.as_tensor(np.array(pose, np.float32), device=dev),
        torch.as_tensor(np.array(beta, np.float32), device=dev),
        center_idx=None,
    )
    return verts.cpu().numpy(), joints.cpu().numpy()


def _sample_poses(n, seed, batch=64):
    """Rule-prior SMPL poses/betas as numpy, drawn in fixed batches from
    JAX's threefry stream (the JAX package's keys and draws)."""
    poses, betas = [], []
    for i in range(0, n, batch):
        p, b = rule_transformation_from(
            prng.rule_draws_from_key(prng.prng_key(seed * 9973 + i), batch))
        poses.append(p.numpy())
        betas.append(b.numpy())
    return np.concatenate(poses)[:n], np.concatenate(betas)[:n]


def write_smpl_assets(smpl_root, model, h36m_reg, radii):
    os.makedirs(smpl_root, exist_ok=True)
    arrays = {name: getattr(model, name).cpu().numpy() for name in (
        "v_template", "shapedirs", "posedirs", "j_regressor", "weights",
        "betas_mean")}
    arrays.update(kintree_parents=np.asarray(model.kintree_parents),
                  faces=np.asarray(model.faces))
    for name in ("smpl_female.npz", "smpl_male.npz"):
        np.savez(os.path.join(smpl_root, name), **arrays)
    np.save(os.path.join(smpl_root, "J_regressor_h36m.npy"), h36m_reg)
    np.save(os.path.join(smpl_root, "humanoid_radii.npy"), radii)


# ---------------- pseudo stream: SURREAL segments ----------------

def _segment_complete(seg_dir, s):
    info = os.path.join(seg_dir, f"seg{s}_info.mat")
    return (os.path.isfile(info)
            and os.path.isfile(info.replace("_info.mat", "_segm.mat"))
            and os.path.isfile(info.replace("_info.mat", ".mp4")))


def synthesize_segments(surreal_root, model, radii, n_segments, n_frames,
                        seed=0):
    """Write SURREAL-format segments under <root>/train/runN/segM_*.

    Each segment draws from its own seeded generator and is skipped when
    already complete on disk, so an interrupted render resumed later (or a
    partially deleted dataset re-rendered) is identical to a single
    uninterrupted run. Returns the number of segments rendered.
    """
    import cv2
    import scipy.io as sio

    intrinsic = SC.get_intrinsic(RES_X, RES_Y)
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]

    rendered = 0
    for s in range(n_segments):
        seg_dir = os.path.join(surreal_root, "train", f"run{s % 4}",
                               f"seq{s}")
        if _segment_complete(seg_dir, s):
            print(f"skipping pseudo segment {s} (already rendered)",
                  flush=True)
            continue
        rendered += 1
        rng = np.random.default_rng(seed * 104729 + s + 1)
        zrot = float(rng.uniform(0, 2 * np.pi))
        rz = np.array([
            [math.cos(zrot), -math.sin(zrot), 0],
            [math.sin(zrot), math.cos(zrot), 0],
            [0, 0, 1],
        ])
        # 70001 offset: keeps pseudo pose seeds disjoint from the hm36
        # folder pose seeds (seed*293 + fi), which collide at seed=0
        poses, betas_all = _sample_poses(n_frames, seed * 131 + 70001 + s)
        betas = betas_all[0]
        gender = int(rng.integers(0, 2))
        # The Blender camera maps world +z (the post-rotate_body body-up
        # axis) to image-LEFT, so a naive root leaves every body lying
        # sideways. Choose the stored root so that the constructor's own
        # composition R90x . Rz(zrot) . R_stored lands at R_desired =
        # Ry(yaw) . Rx(pi) . R_rule — upright in the image with a random
        # per-segment yaw (wobbled per frame).
        yaw0 = float(rng.uniform(0, 2 * np.pi))
        r90x_inv = SC._axangle_to_mat(np.array([-np.pi / 2, 0, 0]))
        rz_inv = rz.T
        render_poses = poses.copy()
        for t in range(n_frames):
            yaw = yaw0 + float(rng.normal(0, 0.25))
            cy_, sy_ = math.cos(yaw), math.sin(yaw)
            r_yaw = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
            r_rule = SC._axangle_to_mat(poses[t, :3])
            r_desired = r_yaw @ np.diag([1.0, -1.0, -1.0]) @ r_rule
            poses[t, :3] = SC._mat_to_axangle(rz_inv @ r90x_inv @ r_desired)
            render_poses[t, :3] = SC.rotate_body(rz, poses[t, :3])

        pelvis_world = np.array([0.0, 0.0, 1.0])
        cam_loc = pelvis_world + np.array([8.0, 0.0, 0.0])
        extrinsic, r_ext, t_ext = SC.get_extrinsic(cam_loc)

        verts, joints = _forward(
            model, render_poses, np.broadcast_to(betas, (n_frames, 10))
        )
        joints3d = np.zeros((3, 24, n_frames), np.float32)
        joints2d = np.zeros((2, 24, n_frames), np.float32)
        frames, segms = [], {}
        body_tone = rng.integers(150, 185)
        for t in range(n_frames):
            trans = pelvis_world - joints[t, 0]
            v_w = verts[t] + trans
            j_w = joints[t] + trans
            joints3d[:, :, t] = j_w.T
            proj = SC.project_vertices(j_w, intrinsic, extrinsic)
            joints2d[:, :, t] = proj[:, :2].T

            v_cam = v_w @ r_ext.T + t_ext.reshape(3)
            mask = splat_mask(v_cam, radii, fx, fy, cx, cy, RES_Y, RES_X)
            segms[f"segm_{t + 1}"] = mask
            # pseudo appearance: flat near-gray body on dark noise
            frame = rng.integers(0, 35, (RES_Y, RES_X, 3)).astype(np.uint8)
            tone = np.array(
                [body_tone - 8, body_tone, body_tone + 5], np.uint8
            )
            frame[mask > 0] = tone
            frames.append(frame)

        os.makedirs(seg_dir, exist_ok=True)
        info_path = os.path.join(seg_dir, f"seg{s}_info.mat")
        # info.mat is written LAST: it is both the completeness sentinel
        # (_segment_complete) and the constructor's glob key, so a crash
        # mid-segment never leaves a segment that looks finished.
        sio.savemat(info_path.replace("_info.mat", "_segm.mat"), segms)
        vw = cv2.VideoWriter(
            info_path.replace("_info.mat", ".mp4"),
            cv2.VideoWriter_fourcc(*"mp4v"), 30, (RES_X, RES_Y),
        )
        for f in frames:
            vw.write(f)
        vw.release()
        sio.savemat(info_path, {
            "pose": poses.T.astype(np.float32),
            "shape": betas.reshape(10, 1).astype(np.float32),
            "zrot": np.array([[zrot]]),
            "camLoc": cam_loc.reshape(3, 1),
            "gender": np.array([[gender]]),
            "joints2D": joints2d, "joints3D": joints3d,
        })
    return rendered


# ---------------- "real" domain: H36M-format multi-camera ----------------

_JT_LIST = [1, 2, 3, 4, 7, 8, 9, 13, 14, 15, 16, 18, 19, 20, 26, 27, 28]

_PALETTE = [
    (60, 70, 170), (150, 90, 60), (70, 140, 60), (60, 120, 170),
    (140, 70, 140), (80, 160, 160), (160, 140, 70), (100, 100, 200),
]


def _write_meta(path, n_frames, img_size, rot, trans, fl, c_p, kps32):
    lines = [str(n_frames), "size %d %d" % (img_size, img_size)]
    lines.append("rot " + " ".join(str(v) for v in rot.T.flatten()))
    lines.append("trans " + " ".join(str(v) for v in trans))
    lines.append("fl " + " ".join(str(v) for v in fl))
    lines.append("cp " + " ".join(str(v) for v in c_p))
    lines.append("kp 0 0 0")
    lines.append("pp 0 0")
    lines.append("jt " + " ".join(str(v) for v in _JT_LIST))
    for f in range(n_frames):
        lines.append("kp " + " ".join("%.4f" % v for v in kps32[f].flatten()))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _background(rng, img_size):
    """Cluttered background: smooth gradient + dim shapes + noise."""
    import cv2

    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32) / img_size
    a, b, c = rng.uniform(20, 70, 3)
    bg = np.stack([a + 50 * yy, b + 50 * xx, c + 40 * (xx + yy) / 2],
                  axis=-1)
    bg = bg.astype(np.uint8)
    for _ in range(6):
        color = tuple(int(v) for v in rng.integers(25, 95, 3))
        p0 = rng.integers(0, img_size, 2)
        sz = rng.integers(20, img_size // 2, 2)
        cv2.rectangle(bg, tuple(p0), tuple(p0 + sz), color, -1)
    noise = rng.normal(0, 6, bg.shape)
    return np.clip(bg.astype(np.int16) + noise.astype(np.int16),
                   0, 255).astype(np.uint8)


def _folder_complete(hm_root, folder, n_frames):
    """True iff all 4 camera renders of `folder` already finished on disk.

    Frames are written in (cam, t) order, so per cam it suffices to check
    the meta file and the LAST frame/mask. Folders are independently
    seeded (seed * 7919 + fi), so skipping complete ones and re-rendering
    the rest reproduces a single uninterrupted run bit-for-bit.
    """
    for cam in range(4):
        cam_folder = f"{folder}_ca_{cam + 1:02d}"
        img_dir = os.path.join(hm_root, "images", cam_folder)
        mask_dir = img_dir.replace(
            os.path.join("hm36", "images"),
            os.path.join("sam_masks", "hm36"),
        )
        meta = os.path.join(hm_root, "annot", cam_folder, "matlab_meta.txt")
        last = "%s_%06d" % (cam_folder, n_frames)
        if not (os.path.isfile(meta)
                and os.path.isfile(os.path.join(img_dir, last + ".jpg"))
                and os.path.isfile(os.path.join(mask_dir, last + ".png"))):
            return False
    return True


def render_hm36(root, model, h36m_reg, radii, image_set, frames_per_folder,
                img_size=384, seed=0):
    """Render all folders of the given campaign subset policy; returns the
    number of images rendered (frames x 4 cameras of each folder not
    already complete on disk)."""
    import cv2

    _, _, f_start, f_end, subjects = SUBSET_POLICIES[image_set]
    folders = all_folders(subjects)[f_start:f_end]
    hm_root = os.path.join(root, "hm36")
    limb = model.weights.cpu().numpy().argmax(1)
    fl = np.array([img_size * 0.9375, img_size * 0.9375])  # 360 @ 384
    c_p = np.array([img_size / 2.0, img_size / 2.0])
    dist = 4000.0

    cams = []
    for cam in range(4):
        ang = cam * np.pi / 2 + 0.35
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        trans = rot.T @ np.array([0.0, 0.0, -dist])
        cams.append((rot, trans))

    rendered = 0
    for fi, folder in enumerate(folders):
        if _folder_complete(hm_root, folder, frames_per_folder):
            print(f"skipping {image_set} folder {folder} (already rendered)",
                  flush=True)
            continue
        rng = np.random.default_rng(seed * 7919 + fi)
        n = frames_per_folder
        poses, betas_all = _sample_poses(n, seed * 293 + fi)
        betas = np.broadcast_to(betas_all[0], (n, 10))  # one body per seq
        verts, _ = _forward(model, poses, betas)

        # world (mm, y-down like H36M): per-frame spin + pelvis wander
        kps17 = np.einsum("jv,bvc->bjc", h36m_reg, verts)
        world_v = np.empty_like(verts)
        world_j = np.empty_like(kps17)
        for t in range(n):
            th = 2 * np.pi * t / n + rng.normal(0, 0.1)
            c, s = np.cos(th), np.sin(th)
            ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            off = rng.uniform([-150, -40, -150], [150, 40, 150])
            for src, dst in ((verts[t], world_v), (kps17[t], world_j)):
                w = src @ ry.T
                w = w * np.array([1.0, -1.0, 1.0]) * 1000.0 + off
                dst[t] = w

        # constructor-order arms -> H36M semantic order (L at 11-13)
        world_j[:, 11:17] = world_j[:, [14, 15, 16, 11, 12, 13]]
        kps32 = np.zeros((n, 32, 3))
        for out_idx, meta_idx in enumerate(_JT_LIST):
            kps32[:, meta_idx - 1] = world_j[:, out_idx]

        for cam in range(4):
            rot, trans = cams[cam]
            cam_folder = f"{folder}_ca_{cam + 1:02d}"
            annot_dir = os.path.join(hm_root, "annot", cam_folder)
            img_dir = os.path.join(hm_root, "images", cam_folder)
            mask_dir = img_dir.replace(
                os.path.join("hm36", "images"),
                os.path.join("sam_masks", "hm36"),
            )
            os.makedirs(annot_dir, exist_ok=True)
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(mask_dir, exist_ok=True)
            _write_meta(os.path.join(annot_dir, "matlab_meta.txt"), n,
                        img_size, rot, trans, fl, c_p, kps32)

            # radii are meters; world is mm
            radii_mm = radii * 1000.0
            for t in range(n):
                v_cam = (world_v[t] - trans) @ rot.T
                mask = splat_mask(v_cam, radii_mm, fl[0], fl[1], c_p[0],
                                  c_p[1], img_size, img_size)
                img = _background(rng, img_size)
                body = splat_shaded(v_cam, radii_mm, limb, fl[0], fl[1],
                                    c_p[0], c_p[1], img_size, img_size,
                                    _PALETTE)
                img[mask > 0] = body[mask > 0]
                name = "%s_%06d.jpg" % (cam_folder, t + 1)
                cv2.imwrite(os.path.join(img_dir, name), img)
                cv2.imwrite(
                    os.path.join(mask_dir, name.replace(".jpg", ".png")),
                    mask * 255,
                )
        rendered += 4 * n
        print(f"rendered {image_set} folder {folder} "
              f"({n} frames x 4 cams)", flush=True)
    return rendered


def _rate(what, count, seconds):
    print(f"{what}: {count} in {seconds:.2f} s"
          + (f" ({count / seconds:.1f}/s)" if count and seconds else ""),
          flush=True)
    return dict(count=count, seconds=seconds)


def main(argv=None) -> dict:
    """Render the campaign the flags describe; returns how long each stage
    took and how much it rendered."""
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--pseudo_segments", type=int, default=150)
    p.add_argument("--pseudo_frames", type=int, default=48)
    p.add_argument("--sample_times", type=int, default=12)
    p.add_argument("--train_frames", type=int, default=160)
    p.add_argument("--valid_frames", type=int, default=80)
    p.add_argument("--img_size", type=int, default=384)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip_pseudo", action="store_true")
    p.add_argument("--skip_real", action="store_true")
    p.add_argument("--train_set", default="campaign_train")
    p.add_argument("--valid_set", default="campaign_valid")
    p.add_argument("--platform", default=None,
                   help="'cpu': the SMPL forward on the CPU (the JAX "
                        "tool's flag; --device cpu says the same)")
    p.add_argument("--device", default=None,
                   help="where the SMPL forward runs (default: the CUDA "
                        "card)")
    args = p.parse_args(argv)
    if args.platform not in (None, "cpu"):
        p.error(f"--platform {args.platform}: only 'cpu' is taken")
    device = resolve_device("cpu" if args.platform == "cpu"
                            else args.device)
    args.device = str(device)

    stats = {}
    t0 = time.perf_counter()
    model, h36m_reg, radii = make_humanoid_smpl(device=device)
    smpl_root = os.path.join(args.out, "smpl_models")
    write_smpl_assets(smpl_root, model, h36m_reg, radii)
    stats["smpl_assets_s"] = time.perf_counter() - t0

    if not args.skip_pseudo:
        surreal_root = os.path.join(args.out, "surreal")
        t0 = time.perf_counter()
        n = synthesize_segments(surreal_root, model, radii,
                                args.pseudo_segments, args.pseudo_frames,
                                seed=args.seed)
        stats["segments"] = _rate("pseudo segment frames rendered",
                                  n * args.pseudo_frames,
                                  time.perf_counter() - t0)
        pseudo_out = os.path.join(args.out, "surreal_h36m_pose")
        info_npy = os.path.join(pseudo_out, "info.npy")
        t0 = time.perf_counter()
        if os.path.isfile(info_npy):
            # the sweep is all-or-nothing (info.npy written last), so an
            # existing index means the pseudo dataset is complete
            print(f"pseudo dataset already swept "
                  f"({len(np.load(info_npy))} frames)")
            written = []
        else:
            np.random.seed(args.seed)
            ctor = SC.SurrealConstructor(
                smpl_root, pseudo_out, res=(RES_X, RES_Y),
                h36m_regressor=h36m_reg, device=device,
            )
            infos = sorted(glob.glob(os.path.join(
                surreal_root, "train", "*", "*", "*_info.mat"
            )))
            written = []
            for i, info in enumerate(infos):
                written.extend(
                    ctor.process_segment(i, info, args.sample_times)
                )
            np.save(info_npy, sorted(written))
            print(f"pseudo dataset: {len(written)} frames from "
                  f"{len(infos)} segments")
        stats["sweep"] = _rate("pseudo frames swept", len(written),
                               time.perf_counter() - t0)

    if not args.skip_real:
        for key, image_set, frames, seed in (
                ("train_set", args.train_set, args.train_frames, args.seed),
                ("valid_set", args.valid_set, args.valid_frames,
                 args.seed + 1)):
            t0 = time.perf_counter()
            n = render_hm36(args.out, model, h36m_reg, radii, image_set,
                            frames, args.img_size, seed=seed)
            stats[key] = _rate(f"{image_set} images rendered", n,
                               time.perf_counter() - t0)

    path = write_manifest(args.out, vars(args))
    print(f"manifest: {path}")
    return dict(stats, manifest=path, device=args.device)


if __name__ == "__main__":
    main()
