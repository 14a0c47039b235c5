"""Helpers of the port's checks, shared by tests/test_torch_*.py and
chip_smoke.py. Nothing here imports JAX.

  AnchoredDataset, AnchoredDetector
      an eval fixture whose detections lie near the ground truth, so that
      the multi-view DLT is well posed and the triangulated outputs can be
      held to fixed bounds. (A detector with random weights gives some
      joints views that no finite point fits; the DLT's answer for them is
      tens of meters away and keeps few digits.) The dataset writes each
      camera's target keypoints (the normalized GT with seeded noise, some
      L/R pairs swapped) into the first row of its image; the detector
      returns them plus a small multiple of a real detector's hypotheses,
      so the real forward still runs, the hypotheses still share x, y and
      still differ in z, and the L/R switch still has swaps to undo.
  result_lines
      eval_result.txt as (key, number or None) per line.
  flat, bitwise_diffs
      leaf-by-leaf comparison of nested state dicts (checkpoints).
  load_train_state
      a train state given as flat arrays (the tests' carry of a JAX train
      state, which a process without JAX reads from an npz) loaded into
      the port's modules and optimizers.
  read_events, events_in
      a reader of the port's TensorBoard event files that needs no
      TensorBoard: every record's two CRCs checked; each event's step,
      file_version, scalars and image sizes decoded.
"""

from __future__ import annotations

import os
import struct
import types

import numpy as np
import torch

from .train.eval_utils import DEFAULT_SWITCH_LIST
from .train.logging import masked_crc32c

# the real detector's share of an anchored detection (normalized units)
ANCHOR_SCALE = 0.01
# the targets' noise, about 30 mm in the 2000 mm box: a good multi-view
# detector's error, and about 300 times the fp32 DLT's own error per joint,
# so the triangulated lines of eval_result.txt keep their digits
NOISE = 0.03
# the chance that a target's L/R pair is swapped
SWAP_SHARE = 0.25


class AnchoredDataset:
    """Wraps a dataset with ``batch(start, n)``: each camera's image carries
    its target keypoints (B, K, 3) in row 0, pixels 0..K-1, channels x, y,
    z; the targets are the GT normalized as the evaluator normalizes it,
    plus N(0, NOISE), with each L/R pair swapped with probability
    SWAP_SHARE. Seeded by `start`, so two evaluators reading the same batch
    get the same targets."""

    def __init__(self, dataset, cam_id_list, img_size: float):
        self.dataset = dataset
        self.cam_id_list = tuple(cam_id_list)
        self.img_size = img_size

    def __len__(self):
        return len(self.dataset)

    def batch(self, start: int, batch_size: int) -> dict:
        out = self.dataset.batch(start, batch_size)
        rng = np.random.default_rng(start)
        s = self.img_size - 1
        for c in self.cam_id_list:
            ck = f"cam_{c}"
            j = out[f"{ck}_joints"].astype(np.float64)
            target = np.concatenate([j[..., :2] / s * 2 - 1, j[..., 2:] / s],
                                    axis=-1)
            target += rng.normal(0.0, NOISE, target.shape)
            swap = rng.random((target.shape[0], len(DEFAULT_SWITCH_LIST)))
            for p, (a, b) in enumerate(DEFAULT_SWITCH_LIST):
                rows = swap[:, p] < SWAP_SHARE
                target[rows, a], target[rows, b] = (target[rows, b].copy(),
                                                    target[rows, a].copy())
            img = out[f"{ck}_img"].copy()
            img[:, 0, :target.shape[1], :] = target
            out[f"{ck}_img"] = img
        return out


class AnchoredDetector(torch.nn.Module):
    """kps = the image's target keypoints + ANCHOR_SCALE * the wrapped
    detector's hypotheses (B, H, K, 3), from an NCHW image batch."""

    def __init__(self, detector: torch.nn.Module):
        super().__init__()
        self.detector = detector

    def forward(self, img):
        kps = self.detector(img).kps
        target = img[:, :, 0, :kps.shape[2]].permute(0, 2, 1).to(kps.dtype)
        return types.SimpleNamespace(kps=target[:, None] + ANCHOR_SCALE * kps)


def result_lines(path: str) -> list:
    """eval_result.txt as (key, number or None) per line."""
    out = []
    with open(path) as f:
        for line in f.read().splitlines():
            key, sep, value = line.partition(":")
            out.append((key, float(value.replace("%", "")) if sep else None))
    return out


def flat(tree, prefix: str = "") -> dict:
    """Every leaf of a nested dict / list of tensors and numbers, by path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}"))
    return out


def bitwise_diffs(got: dict, want: dict) -> list:
    """The paths of two flat() dicts whose leaves differ: a missing or extra
    path, another dtype or shape, one bit of a tensor (on any device), or
    another number."""
    bad = sorted(set(got) ^ set(want))
    for k, w in want.items():
        if k not in got:
            continue
        g = got[k]
        if torch.is_tensor(w):
            if not (torch.is_tensor(g) and g.dtype == w.dtype
                    and g.shape == w.shape
                    and torch.equal(g.to(w.device), w)):
                bad.append(k)
        elif g != w:
            bad.append(k)
    return bad


def load_train_state(spec, state, arrays: dict) -> None:
    """Load a train state given as flat arrays into `spec`'s modules and
    `state`: ``var/<module>.<name>`` parameters and BatchNorm statistics
    (module detector, physique or discriminator); ``mu/det/<name>``,
    ``nu/det/<name>`` the generator's Adam moments by TrainState.gen_names,
    ``mu/disc/<name>``, ``nu/disc/<name>`` the discriminator's by
    TrainState.disc_names, ``count/det`` and ``count/disc`` their update
    counts; ``pending/<name>`` the carried discriminator gradient."""
    def t(key):
        return torch.as_tensor(np.asarray(arrays[key])).clone()

    for prefix in ("detector", "physique", "discriminator"):
        head = f"var/{prefix}."
        getattr(spec, prefix).load_state_dict(
            {k[len(head):]: t(k) for k in arrays if k.startswith(head)},
            strict=False)
    for tag, opt, names, params in (
            ("det", state.opt_det, state.gen_names, state.gen_params),
            ("disc", state.opt_disc, state.disc_names, state.disc_params)):
        count = int(np.asarray(arrays[f"count/{tag}"]))
        for n, p in zip(names, params):
            opt.state[p] = {"step": torch.tensor(float(count)),
                            "exp_avg": t(f"mu/{tag}/{n}"),
                            "exp_avg_sq": t(f"nu/{tag}/{n}")}
    state.det_updates = int(np.asarray(arrays["count/det"]))
    state.disc_updates = int(np.asarray(arrays["count/disc"]))
    state.pending_disc_grads = [t(f"pending/{n}") for n in state.disc_names]


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        byte = buf[i]
        i += 1
        n |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return n, i


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of a protobuf
    message: an int for varints, bytes for the rest."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            value, i = buf[i:i + size], i + size
        elif wire == 2:
            size, i = _varint(buf, i)
            value, i = buf[i:i + size], i + size
        else:
            raise ValueError(f"protobuf wire type {wire}")
        yield field, wire, value


def _image(buf: bytes) -> tuple:
    """Image{height 1, width 2, colorspace 3, encoded_image_string 4} ->
    (height, width, colorspace), checked against the PNG's header."""
    f = {field: value for field, _, value in _fields(buf)}
    png = f[4]
    if png[:8] != b"\x89PNG\r\n\x1a\n" or png[12:16] != b"IHDR":
        raise ValueError("image is not a PNG")
    width, height = struct.unpack(">II", png[16:24])
    if (height, width) != (f[1], f[2]):
        raise ValueError(f"PNG is {height}x{width}, its Image {f[1]}x{f[2]}")
    return f[1], f[2], f[3]


def read_events(path: str) -> list[dict]:
    """Every event of one event file, each record's length and data CRCs
    checked (ValueError on a bad one): dicts of ``wall_time``, ``step``,
    ``file_version`` (or None), ``scalars`` {tag: value} and ``images``
    {tag: (height, width, colorspace)}."""
    with open(path, "rb") as f:
        data = f.read()
    events, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: bad length CRC at byte {i}")
        body = data[i + 12:i + 12 + length]
        (crc,) = struct.unpack("<I", data[i + 12 + length:i + 16 + length])
        if len(body) != length or crc != masked_crc32c(body):
            raise ValueError(f"{path}: bad data CRC at byte {i}")
        i += 16 + length
        event = dict(wall_time=None, step=0, file_version=None, scalars={},
                     images={})
        for field, _, value in _fields(body):
            if field == 1:
                (event["wall_time"],) = struct.unpack("<d", value)
            elif field == 2:
                event["step"] = value - (1 << 64) if value >> 63 else value
            elif field == 3:
                event["file_version"] = value.decode()
            elif field == 5:
                for sfield, _, sval in _fields(value):
                    if sfield != 1:
                        continue
                    v = {vf: vv for vf, _, vv in _fields(sval)}
                    tag = v[1].decode()
                    if 2 in v:
                        (event["scalars"][tag],) = struct.unpack("<f", v[2])
                    if 4 in v:
                        event["images"][tag] = _image(v[4])
        events.append(event)
    return events


def events_in(log_dir: str) -> dict:
    """read_events of every event file in `log_dir`, by file name."""
    return {name: read_events(os.path.join(log_dir, name))
            for name in sorted(os.listdir(log_dir)) if "tfevents" in name}


# ------------------------------------------------- on-disk dataset fixtures
#
# Miniature datasets in the real datasets' own layouts, read by the port's
# index builders and pipeline (data/): images rendered from the GT joints,
# so the crops hold the body. They need cv2 (and scipy for MPI-INF-3DHP).

H36M_FOLDER = "s_09_act_02_subact_01"


def write_mini_h36m(root, img_size: int = 640, n_frames: int = 8,
                    seed: int = 0, folders=(H36M_FOLDER,),
                    images: bool = True) -> str:
    """A Human3.6M tree under <root>/hm36: per folder and camera (4)
    ``annot/<folder>_ca_0<c>/matlab_meta.txt`` in the reference's line
    format (reference hm36.py:60-98), and with `images` the
    ``images/<folder>_ca_0<c>/<folder>_ca_0<c>_<frame>.jpg`` renders of the
    GT skeleton and their SAM masks ``<root>/sam_masks/hm36/...png``.
    The default folder is the ``mini`` subset policy's; the files equal
    those of the JAX package's tests/fixture_helpers.py:make_mini_h36m for
    the same arguments. Returns <root>/hm36 (dataset_params.dataset.path).
    `root` must not contain ``hm36`` or ``images`` (the mask path rewrite,
    data/pipeline.py:mask_path_for)."""
    from .data.affine import cv2_module
    from .data.synthetic import H36M_PARENT_IDS, _random_pose

    cv2 = cv2_module()
    hm_root = os.path.join(root, "hm36")
    rng = np.random.default_rng(seed)
    # the 17 H36M joints placed into the 32-joint world layout the meta holds
    jt_list = [1, 2, 3, 4, 7, 8, 9, 13, 14, 15, 16, 18, 19, 20, 26, 27, 28]

    def write_meta(path, kps32, rot, trans, fl, c_p):
        lines = [str(n_frames), "size %d %d" % (img_size, img_size),
                 "rot " + " ".join(str(v) for v in rot.T.flatten()),
                 "trans " + " ".join(str(v) for v in trans),
                 "fl " + " ".join(str(v) for v in fl),
                 "cp " + " ".join(str(v) for v in c_p),
                 "kp 0 0 0", "pp 0 0",
                 "jt " + " ".join(str(v) for v in jt_list)]
        lines += ["kp " + " ".join("%.4f" % v for v in kps32[f].flatten())
                  for f in range(n_frames)]
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")

    for folder in folders:
        poses18 = np.stack([_random_pose(rng) for _ in range(n_frames)])
        kps32 = np.zeros((n_frames, 32, 3))
        for out_idx, meta_idx in enumerate(jt_list):
            kps32[:, meta_idx - 1] = poses18[:, out_idx]
        for cam in range(4):
            angle = cam * np.pi / 2 + 0.3
            c, s = np.cos(angle), np.sin(angle)
            rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
            trans = rot.T @ np.array([0.0, 0.0, -4000.0])
            fl = np.array([600.0, 600.0])
            c_p = np.array([img_size / 2, img_size / 2])
            cam_folder = f"{folder}_ca_{cam + 1:02d}"
            annot_dir = os.path.join(hm_root, "annot", cam_folder)
            os.makedirs(annot_dir, exist_ok=True)
            write_meta(os.path.join(annot_dir, "matlab_meta.txt"), kps32,
                       rot, trans, fl, c_p)
            if not images:
                continue
            img_dir = os.path.join(hm_root, "images", cam_folder)
            mask_dir = os.path.join(root, "sam_masks", "hm36", cam_folder)
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(mask_dir, exist_ok=True)
            for f in range(n_frames):
                cam_pts = (kps32[f, [j - 1 for j in jt_list]] - trans) @ rot.T
                u = (cam_pts[:, 0] / cam_pts[:, 2] * fl[0] + c_p[0]).astype(int)
                v = (cam_pts[:, 1] / cam_pts[:, 2] * fl[1] + c_p[1]).astype(int)
                # thorax = shoulder midpoint (index 17 of the 18 joints)
                u = np.append(u, (u[11] + u[14]) // 2)
                v = np.append(v, (v[11] + v[14]) // 2)
                body = np.zeros((img_size, img_size), np.uint8)
                for j, p in enumerate(H36M_PARENT_IDS):
                    cv2.line(body, (u[j], v[j]), (u[p], v[p]), 255, 9)
                img = np.dstack([body // 2, (body // 3) * 2, body])
                img = (img + rng.integers(0, 15, img.shape)).astype(np.uint8)
                name = "%s_%06d" % (cam_folder, f + 1)
                cv2.imwrite(os.path.join(img_dir, name + ".jpg"), img)
                cv2.imwrite(os.path.join(mask_dir, name + ".png"), body)
    return hm_root


def _stick_figure(joints_px, size: int, parent_ids, width: int):
    """(size, size) uint8 body of 255s: the skeleton's bones as lines."""
    from .data.affine import cv2_module

    cv2 = cv2_module()
    body = np.zeros((size, size), np.uint8)
    pts = np.round(joints_px).astype(int)
    for j, p in enumerate(parent_ids):
        cv2.line(body, tuple(pts[j]), tuple(pts[p]), 255, width)
    return body


def write_surreal_pseudo(root, n: int, seed: int = 0, size: int = 256,
                         fmt: str = "ori_surreal") -> str:
    """A pseudo-image stream (dataset_params.smpl_pseudo_img) in `root`,
    whose name must hold ``surreal_h36m_pose`` (fmt ``ori_surreal``) or
    ``smpl_pseudo_img`` (fmt ``no_texture``), as data/pipeline.py
    dispatches on it. ``ori_surreal``, the layout of the JAX package's
    tools/surreal_constructor.py: `n` entries ``image/image_%06d.png``
    (BGR), ``mask/mask_%06d.png`` (0/1) and ``joints/joint_%06d.npy`` (18 x
    3: x, y in [-1, 1] of the patch, z in meters from the pelvis), their
    numbers (every third) in ``info.npy``. ``no_texture``: `n` iterations
    of batch 2 for cameras 0 and 1, ``image/<it>_cam_<c>_<b>.png`` and
    ``joints/<it>_cam_<c>_<b>.npy``, and ``info.npy`` the dict
    {max_iter_num, batch_size, cam_id_list}. Returns `root`."""
    from .data.affine import cv2_module
    from .data.synthetic import H36M_PARENT_IDS, _random_pose

    cv2 = cv2_module()
    rng = np.random.default_rng(seed)
    for sub in ("image", "mask", "joints"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    def entry(stem_img, stem_joint, stem_mask=None):
        pose = _random_pose(rng)  # mm, pelvis-centered
        xy = pose[:, :2] / 2000.0 * 2  # the 2000 mm box -> [-1, 1]
        px = (xy + 1) / 2 * (size - 1)
        body = _stick_figure(px, size, H36M_PARENT_IDS, max(2, size // 40))
        img = np.dstack([body // 3, body // 2, body])
        img = (img + rng.integers(0, 20, img.shape) * (body[..., None] > 0)
               ).astype(np.uint8)
        joints = np.concatenate([xy, pose[:, 2:] / 1000.0], axis=1)
        cv2.imwrite(os.path.join(root, "image", stem_img + ".png"), img)
        np.save(os.path.join(root, "joints", stem_joint + ".npy"),
                joints.astype(np.float32))
        if stem_mask is not None:
            cv2.imwrite(os.path.join(root, "mask", stem_mask + ".png"),
                        (body > 0).astype(np.uint8))

    if fmt == "ori_surreal":
        numbers = [3 * i for i in range(n)]
        for k in numbers:
            entry(f"image_{k:06d}", f"joint_{k:06d}", f"mask_{k:06d}")
        np.save(os.path.join(root, "info.npy"), np.array(numbers))
    elif fmt == "no_texture":
        info = {"max_iter_num": n, "batch_size": 2, "cam_id_list": [0, 1]}
        for it in range(n):
            for c in info["cam_id_list"]:
                for b in range(info["batch_size"]):
                    entry(f"{it}_cam_{c}_{b}", f"{it}_cam_{c}_{b}")
        np.save(os.path.join(root, "info.npy"), info, allow_pickle=True)
    else:
        raise ValueError(f"fmt {fmt!r}: 'ori_surreal' or 'no_texture'")
    return root


def write_mini_mpi(root, img_size: int = 2048, n_frames: int = 3,
                   seed: int = 4, subjects=(7, 8)) -> str:
    """An MPI-INF-3DHP tree under <root>/mpi_inf_3dhp: for each subject and
    both sequences, ``annot.mat`` (annot3: camera-frame 28-joint poses of
    all 14 cameras), ``camera.calibration``, and for the five chest-height
    cameras the frames ``images/video_<v>/frame_%06d.jpg``, their exposure
    masks (``masks/``, red channel) and chair masks (``chair_masks/``, all
    white: no joint occluded), and the SAM masks the pipeline reads
    (<root>/sam_masks/mpi_inf_3dhp/..., red channel), as the JAX package's
    tests/test_mpi_e2e.py writes them. The default subjects are the
    ``valid`` policy's. Returns <root>/mpi_inf_3dhp."""
    from scipy.io import savemat

    from .data import mpi_inf_3dhp as M
    from .data.affine import cv2_module

    cv2 = cv2_module()
    mpi_root = os.path.join(root, "mpi_inf_3dhp")
    rng = np.random.default_rng(seed)
    f = 1500.0 * img_size / 2048
    intr = [[f, f, img_size / 2, img_size / 2]] * M.TOTAL_MPI_VIDEO_NUM
    for subject in subjects:
        for seq in M.MPI_SEQ_IDX:
            rel = os.path.join(f"S{subject}", f"Seq{seq}")
            seq_dir = os.path.join(mpi_root, rel)
            kps_w = rng.normal(scale=250.0, size=(n_frames, M.MPI_JT_NUM, 3))
            kps_w[..., 2] *= 0.3
            pelvis_w = kps_w[:, M.MPI_TRAIN_ROOT_JT_IDX].mean(axis=0)
            extr = []
            annot3 = np.empty((M.TOTAL_MPI_VIDEO_NUM, 1), dtype=object)
            for cam_id in range(M.TOTAL_MPI_VIDEO_NUM):
                ang = cam_id * 0.37
                c, s = np.cos(ang), np.sin(ang)
                rot = np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
                ex = np.eye(4)
                ex[:3, :3] = rot
                ex[:3, 3] = np.array([0.0, 0.0, 4000.0]) - rot @ pelvis_w
                extr.append(ex)
                annot3[cam_id, 0] = (kps_w @ rot.T + ex[:3, 3]).reshape(
                    n_frames, -1)
            os.makedirs(seq_dir, exist_ok=True)
            savemat(os.path.join(seq_dir, "annot.mat"), {"annot3": annot3})
            lines = []
            for cam_id in range(M.TOTAL_MPI_VIDEO_NUM):
                fx, fy, cx, cy = intr[cam_id]
                lines += [
                    f"name          {cam_id}", "  sensor      10 10",
                    f"  size        {img_size} {img_size}", "  animated    0",
                    "  intrinsic   " + " ".join(str(v) for v in [
                        fx, 0, cx, 0, 0, fy, cy, 0, 0, 0, 1, 0, 0, 0, 0, 1]),
                    "  extrinsic   " + " ".join(
                        str(v) for v in extr[cam_id].flatten()),
                    "  radial      0"]
            with open(os.path.join(seq_dir, "camera.calibration"), "w") as fh:
                fh.write("\n".join(lines) + "\n")
            for vid in M.USE_MPI_VIDEO_IDX:
                dirs = [os.path.join(seq_dir, sub, f"video_{vid}") for sub in
                        ("images", "masks", "chair_masks")]
                dirs.append(os.path.join(root, "sam_masks", "mpi_inf_3dhp",
                                         rel, "masks", f"video_{vid}"))
                for d in dirs:
                    os.makedirs(d, exist_ok=True)
                rot, t = extr[vid][:3, :3], extr[vid][:3, 3]
                fx, fy, cx, cy = intr[vid]
                for fr in range(n_frames):
                    cam_kps = kps_w[fr] @ rot.T + t
                    uv = np.stack([cam_kps[:, 0] / cam_kps[:, 2] * fx + cx,
                                   cam_kps[:, 1] / cam_kps[:, 2] * fy + cy],
                                  axis=1).astype(int)
                    body = _stick_figure(uv, img_size, M.MPI_PARENT_IDS,
                                         max(2, img_size // 100))
                    img = np.dstack([body // 2, body // 3, body])
                    img += rng.integers(0, 20, img.shape, dtype=np.uint8)
                    red = np.dstack([body * 0, body * 0, body])
                    name = "frame_%06d.jpg" % (fr + 1)
                    cv2.imwrite(os.path.join(dirs[0], name), img)
                    cv2.imwrite(os.path.join(dirs[1], name), red)
                    cv2.imwrite(os.path.join(dirs[2], name),
                                np.full((img_size, img_size, 3), 255,
                                        np.uint8))
                    cv2.imwrite(os.path.join(dirs[3], name), red)
    return mpi_root


def hm36_dataset_params(root) -> dict:
    """config/HM36_Multi_SurS2.yaml's dataset_params (the card's machine
    has no yaml) with the dataset's path, both image sets and the pseudo
    stream pointed at the fixtures write_mini_h36m and write_surreal_pseudo
    write under `root` (``mini``; <root>/surreal_h36m_pose)."""
    return {
        "dataset": {"name": "hm36", "path": os.path.join(root, "hm36"),
                    "train_image_set": "mini", "test_image_set": "mini",
                    "sample_interval": 60, "extra_param": ""},
        "dataiter": {"mean": [0.0, 0.0, 0.0],
                     "std": [255.0, 255.0, 255.0]},
        "smpl_pseudo_img": {
            "use_flag": True, "use_mask": True,
            "data_path": os.path.join(root, "surreal_h36m_pose")},
        "use_full_kp": False,
        "rm_bg": True,
        "cam_id_list": [0, 1, 2, 3],
        "geodesic_pt_list": [],
        "geodesic_param_list": [2, 1, 3, 20, 0.0],
    }


# config/HM36_Multi_SurS2.yaml's train_params.aug: no augmentation
NO_AUG = {"scale_factor": 0.0, "rot_factor": 0, "color_factor": 0.0,
          "rot_aug_rate": 0.0, "flip_aug_rate": 0.0, "do_flip_aug": False}


def _body_silhouette(joints_px, size_hw, parent_ids, width: int):
    """(H, W) uint8 of 255s: the skeleton's bones as thick lines and a disc
    at each joint, a filled person shape rather than a stick figure."""
    from .data.affine import cv2_module

    cv2 = cv2_module()
    body = np.zeros(size_hw, np.uint8)
    pts = np.round(joints_px).astype(int)
    for j, p in enumerate(parent_ids):
        cv2.line(body, tuple(pts[j]), tuple(pts[p]), 255, width)
        cv2.circle(body, tuple(pts[j]), width // 2 + 2, 255, -1)
    return body


def _smooth_frame(body, rng, size_hw):
    """A BGR frame: a smooth background (a random 2 x 2 image stretched
    bilinearly), the body a flat colour. Smooth images write fast as PNG."""
    from .data.affine import cv2_module

    h, w = size_hw
    corners = rng.integers(30, 130, (2, 2, 3)).astype(np.uint8)
    img = cv2_module().resize(corners, (w, h))
    img[body > 0] = rng.integers(150, 240, 3).astype(np.uint8)
    return img


def write_mini_tiktok(root, n_frames: int = 48, videos=None,
                      size_hw=(1080, 604), seed: int = 0) -> str:
    """A TikTok dataset tree, the layout data/dataloader_2d.py:TikTok_dataset
    reads: for each video number v of `videos` (default the first training
    video) ``<root>/TikTok_dataset/<v:05d>/images/<i:05d>.png``, `n_frames`
    portrait BGR frames of `size_hw` (height, width; the dataset's own
    1080 x 604 by default), and ``masks/<i:05d>.png``, 0/255 person masks.
    Each frame holds a seeded random pose drawn as a filled person on a
    smooth background, its mask the same shape. The dataset keeps frames
    [20:-20] of each video, so `n_frames` - 40 samples a video. Returns
    <root>/TikTok_dataset (dataset_params.dataset.path)."""
    from .data.affine import cv2_module
    from .data.dataloader_2d import TIKTOK_TRAIN_VIDEOS
    from .data.synthetic import H36M_PARENT_IDS, _random_pose

    cv2 = cv2_module()
    videos = (TIKTOK_TRAIN_VIDEOS[0],) if videos is None else videos
    rng = np.random.default_rng(seed)
    data = os.path.join(root, "TikTok_dataset")
    h, w = size_hw
    png = [cv2.IMWRITE_PNG_COMPRESSION, 1]
    for v in videos:
        dirs = [os.path.join(data, f"{v:05d}", sub)
                for sub in ("images", "masks")]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        for i in range(n_frames):
            pose = _random_pose(rng)  # mm, pelvis-centred, y down
            scale = 0.55 * h / 1700.0 * rng.uniform(0.8, 1.1)
            centre = np.array([w / 2, h / 2]) + rng.uniform(-0.08, 0.08, 2) * (
                w, h)
            px = centre + pose[:, :2] * scale
            body = _body_silhouette(px, (h, w), H36M_PARENT_IDS,
                                    max(3, w // 20))
            name = f"{i:05d}.png"
            cv2.imwrite(os.path.join(dirs[0], name),
                        _smooth_frame(body, rng, (h, w)), png)
            cv2.imwrite(os.path.join(dirs[1], name), body, png)
    return data


def write_mini_mpii(root, n_images: int = 8, size_hw=(720, 1280),
                    seed: int = 0, overexposed=()) -> tuple[str, str]:
    """An MPII tree, the layout data/mpii.py reads: ``<root>/mpii/images/
    im%04d.jpg``, `n_images` BGR frames of `size_hw` (height, width) each
    holding one seeded random pose drawn as a filled person; their SAM-style
    masks ``<root>/sam_masks/mpii/im%04d.jpg`` (0/255, the person about 10-
    40 % of the frame); ``annot/mpii_valid.json`` (per image: its name,
    center, scale = the body's height / 200, the 16 MPII joints in 1-based
    pixels, all visible) and ``annot/mpii_gt_valid.mat`` (``headboxes_src``
    (2, 2, n): a box from the head top to the upper neck). The images whose
    index is in `overexposed` get an all-white mask, which the index's
    over-exposure filter drops. Returns (<root>/mpii, <root>/sam_masks/mpii):
    dataset_params.dataset.path and mask_path."""
    import json

    from scipy.io import savemat

    from .data.affine import cv2_module
    from .data.hm36 import S_HM36_2_MPII_JT
    from .data.synthetic import H36M_PARENT_IDS, _random_pose

    cv2 = cv2_module()
    rng = np.random.default_rng(seed)
    path = os.path.join(root, "mpii")
    mask_path = os.path.join(root, "sam_masks", "mpii")
    for d in (os.path.join(path, "images"), os.path.join(path, "annot"),
              mask_path):
        os.makedirs(d, exist_ok=True)
    h, w = size_hw
    anno, heads = [], np.zeros((2, 2, n_images))
    for i in range(n_images):
        pose = _random_pose(rng)
        body_h = 0.75 * h * rng.uniform(0.85, 1.0)
        centre = np.array([w / 2, h / 2]) + rng.uniform(-0.1, 0.1, 2) * (w, h)
        px = centre + pose[:, :2] * body_h / 1700.0
        body = _body_silhouette(px, (h, w), H36M_PARENT_IDS,
                                max(3, int(body_h / 7)))
        mask = (np.full((h, w), 255, np.uint8) if i in overexposed
                else body)
        name = f"im{i:04d}.jpg"
        cv2.imwrite(os.path.join(path, "images", name),
                    _smooth_frame(body, rng, (h, w)))
        cv2.imwrite(os.path.join(mask_path, name), mask)
        joints = px[S_HM36_2_MPII_JT] + 1.0  # MPII's 1-based pixels
        top, neck = joints[9], joints[8]
        half = 0.5 * np.linalg.norm(top - neck)
        heads[0, :, i] = np.minimum(top, neck) - half
        heads[1, :, i] = np.maximum(top, neck) + half
        lo, hi = px.min(axis=0), px.max(axis=0)
        anno.append({
            "image": name,
            "center": ((lo + hi) / 2 + 1.0).tolist(),
            "scale": float((hi[1] - lo[1]) / 200.0),
            "joints": joints.tolist(),
            "joints_vis": [1] * 16,
        })
    with open(os.path.join(path, "annot", "mpii_valid.json"), "w") as f:
        json.dump(anno, f)
    savemat(os.path.join(path, "annot", "mpii_gt_valid.mat"),
            {"headboxes_src": heads})
    return path, mask_path
