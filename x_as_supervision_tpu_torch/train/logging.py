"""TensorBoard logging with the reference's tag layout (training_loss/*,
training_pose_2d/*, training_mask/*, training_depth/*, training_smpl/*,
training_pseudo/*, meta/learning_rate/detector; reference:
train_util.py:229-305), ported from the JAX package's train/logging.py.

The event writer is the port's own: ``SummaryWriter`` writes
``events.out.tfevents.<unix time>.<host>`` files that TensorBoard reads,
with nothing outside the standard library and numpy, so logging runs the
same wherever the port runs. Each file is a sequence of TFRecords (uint64
length, masked CRC-32C of the length, the data, masked CRC-32C of the
data) holding protobuf ``Event`` messages, encoded here by hand: the first
holds ``file_version``, each later one a ``Summary`` of one value, a
scalar (``simple_value``) or a PNG image.
"""

from __future__ import annotations

import collections
import os
import socket
import struct
import time
import zlib

import numpy as np

from . import vis

# ------------------------------------------------------------ TFRecords


def _crc32c_table() -> list:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78); zlib.crc32
    is the other polynomial."""
    table = _CRC32C_TABLE
    c = 0xFFFFFFFF
    for byte in data:
        c = table[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


# ------------------------------------------------------------ protobuf


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # int64 two's complement, as protobuf encodes it
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _event(wall_time: float, step: int = 0, file_version: str | None = None,
           value: bytes | None = None) -> bytes:
    """Event{wall_time = 1 (double), step = 2 (int64), file_version = 3
    (string) | summary = 5 (Summary{value = 1 (repeated Value)})}."""
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if value is not None:
        out += _bytes_field(5, _bytes_field(1, value))
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    """Value{tag = 1, simple_value = 2 (float)}."""
    return (_bytes_field(1, tag.encode()) + _key(2, 5)
            + struct.pack("<f", value))


def _image_value(tag: str, height: int, width: int, channels: int,
                 png: bytes) -> bytes:
    """Value{tag = 1, image = 4 (Image{height = 1, width = 2,
    colorspace = 3, encoded_image_string = 4})}."""
    image = (_key(1, 0) + _varint(height) + _key(2, 0) + _varint(width)
             + _key(3, 0) + _varint(channels) + _bytes_field(4, png))
    return _bytes_field(1, tag.encode()) + _bytes_field(4, image)


def encode_png(hwc: np.ndarray) -> bytes:
    """An (H, W, 1 or 3) uint8 array as a PNG (8-bit gray or RGB, filter 0
    on every row)."""
    h, w, c = hwc.shape
    color = {1: 0, 3: 2}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(hwc).reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


# ------------------------------------------------------------ the writer

FLUSH_SECS = 120.0


class SummaryWriter:
    """TensorBoard event writer: add_scalar, add_image (CHW uint8), flush,
    close. Events reach the file at least every FLUSH_SECS seconds, as
    tensorboardX's writer flushes them by default. ``skipped`` counts, by
    tag, the panels that tb_vis and the evaluator could not draw on this
    machine (vis.missing())."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        base = os.path.join(log_dir, f"events.out.tfevents.{int(time.time())}"
                            f".{socket.gethostname()}")
        path, n = base, 0
        while os.path.exists(path):
            n += 1
            path = f"{base}.{n}"
        self.path = path
        self._file = open(path, "wb")
        self.skipped: collections.Counter = collections.Counter()
        self._flushed = time.monotonic()
        self._write(_event(time.time(), file_version="brain.Event:2"))
        self.flush()

    def _write(self, event: bytes) -> None:
        self._file.write(tfrecord(event))
        if time.monotonic() - self._flushed >= FLUSH_SECS:
            self.flush()

    def add_scalar(self, tag: str, value, global_step: int = 0,
                   walltime: float | None = None) -> None:
        self._write(_event(time.time() if walltime is None else walltime,
                           int(global_step),
                           value=_scalar_value(tag, float(value))))

    def add_image(self, tag: str, img_tensor, global_step: int = 0,
                  walltime: float | None = None) -> None:
        """img_tensor: (C, H, W) uint8, C = 1 or 3."""
        img = np.asarray(img_tensor)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[0] not in (
                1, 3):
            raise ValueError(f"add_image({tag!r}): a (1 or 3, H, W) uint8 "
                             f"image, not {img.dtype} {img.shape}")
        c, h, w = img.shape
        png = encode_png(img.transpose(1, 2, 0))
        self._write(_event(time.time() if walltime is None else walltime,
                           int(global_step),
                           value=_image_value(tag, h, w, c, png)))

    def flush(self) -> None:
        self._file.flush()
        self._flushed = time.monotonic()

    def close(self) -> None:
        if not self._file.closed:
            self._file.flush()
            self._file.close()


# the panels each optional package (vis.OPTIONAL) draws, by tag
PANELS_NEEDING = {
    "cv2": "the skeletons of training_pose_2d/*, training_pseudo/pose_2d_*, "
           "training_smpl/pose_smpl_2d_*, testing_pred_pose/*, "
           "testing_gt_pose/* (written without them)",
    "matplotlib": "training_pose_3d/*, training_pseudo/pose_3d_*, "
                  "training_smpl/pose_smpl_3d_*, training_depth/*, "
                  "training_weight/*, testing_pose_3D/*",
}


def create_writer(log_dir: str) -> SummaryWriter:
    for name in vis.missing():
        print(f"tensorboard: {name} is not installed; not written: "
              f"{PANELS_NEEDING[name]}", flush=True)
    return SummaryWriter(log_dir)


def figure(tb_log, tag: str, step: int, draw) -> None:
    """A matplotlib panel: draw() written under `tag`, or counted in
    tb_log.skipped where matplotlib is missing."""
    if "matplotlib" in vis.missing():
        tb_log.skipped[tag] += 1
        return
    tb_log.add_image(tag, draw(), step)


def pose_panel(tb_log, tag: str, step: int, img) -> None:
    """A pose_vis panel; where cv2 is missing it has no skeleton, and
    tb_log.skipped counts that under ``<tag> skeleton``."""
    if "cv2" in vis.missing():
        tb_log.skipped[tag + " skeleton"] += 1
    tb_log.add_image(tag, img, step)


def tb_vis(
    tb_log,
    cur_step: int,
    tb_pair_ids,
    tb_parent_ids,
    total_loss,
    loss_kp: dict,
    loss_disc,
    output: dict,
    x: dict,
    config: dict,
    detector_lr: float,
    image_every: int = 50,
    simple_version: bool = False,
):
    if tb_log is None:
        return

    if not simple_version:
        if total_loss is not None:
            tb_log.add_scalar("training_loss/total_loss", float(total_loss),
                              cur_step)
        for key, value in loss_kp.items():
            tb_log.add_scalar(
                f"training_loss/{key}", float(np.asarray(value).mean()),
                cur_step,
            )
        tb_log.add_scalar(
            "meta/learning_rate/detector", float(detector_lr), cur_step
        )
        for key in output:
            # learned-line-width scalars (reference train_util.py:240-243;
            # the shipped models never emit them; kept for parity)
            if key.startswith("line_width"):
                for i, val in enumerate(np.asarray(output[key]).ravel()):
                    tb_log.add_scalar(
                        f"training_line_width/{key}_{i}", float(val), cur_step
                    )
        if loss_disc is not None:
            tb_log.add_scalar(
                "training_loss/smpl_disc", float(loss_disc), cur_step
            )

    if cur_step % image_every != 0:
        return

    dp = config.get("dataset_params", {})
    mean = dp.get("dataiter", {}).get("mean")
    std = dp.get("dataiter", {}).get("std")

    def _ms(arr):
        # uint8-fed batches are raw 0..255 (normalization happens on the
        # device): skip the un-normalize for display
        if np.asarray(arr).dtype == np.uint8:
            return None, None
        return mean, std

    for key in x.keys():
        if "pseudo" in key:
            continue
        val = x[key]
        if key.endswith("img"):
            m, s = _ms(val)
            tb_log.add_image(
                f"training_img/{key}", vis.img_vis(val[0], m, s), cur_step
            )
        elif key.endswith("mask"):
            tb_log.add_image(
                f"training_mask/{key}", vis.img_vis(val[0]), cur_step
            )
        elif key.endswith("joints"):
            cam_key = key.split("_joints")[0]
            img = x.get(f"{cam_key}_img")
            if img is None:
                continue
            m, s = _ms(img)
            pose_panel(
                tb_log, f"training_pose_2d/{cam_key}_gt_pose", cur_step,
                vis.pose_vis(
                    np.asarray(val[0])[:, :2], img.shape[1:3], tb_pair_ids,
                    tb_parent_ids, img=np.asarray(img[0]), mean=m, std=s,
                    is_gt=True,
                ),
            )
        elif key.endswith("geodesic_dis"):
            cam_key = key.split("_geodesic_dis")[0]
            center = x.get(f"{cam_key}_geodesic_center")
            if center is None:
                center = np.zeros((1, 2))
            else:
                center = np.asarray(center[0])
            figure(tb_log, f"training_weight/{key}", cur_step,
                   lambda val=val, center=center: vis.dis_vis(
                       np.asarray(val[0]), center))

    for key in output.keys():
        val = np.asarray(output[key])
        if key.startswith("mask"):
            tb_log.add_image(
                f"training_mask/{key}", vis.img_vis(val[0]), cur_step
            )
        elif key.startswith("pose_2d"):
            mode = key.split("pose_2d_pred_")[1].rsplit("_", 1)[0]
            page = "training_pose_2d" if "pseudo" not in key else "training_pseudo"
            img = x.get(f"{mode}_img")
            if img is None:
                continue
            m, s = _ms(img)
            pose_panel(
                tb_log, f"{page}/{key}", cur_step,
                vis.pose_vis(
                    val[0][:, :2], img.shape[1:3], tb_pair_ids, tb_parent_ids,
                    img=np.asarray(img[0]), mean=m, std=s,
                ),
            )
        elif key.startswith("pose_3d"):
            page = "training_pose_3d" if "pseudo" not in key else "training_pseudo"
            figure(tb_log, f"{page}/{key}", cur_step,
                   lambda val=val: vis.pose_vis_3d(val[0], tb_pair_ids,
                                                   tb_parent_ids))
        elif key.startswith("pose_smpl_2d") and not simple_version:
            img = x.get("cam_0_img")
            size = img.shape[1:3] if img is not None else (256, 256)
            pose_panel(
                tb_log, f"training_smpl/{key}", cur_step,
                vis.pose_vis(val[0][:, :2], size, tb_pair_ids, tb_parent_ids),
            )
        elif key.startswith("pose_smpl_3d") and not simple_version:
            figure(tb_log, f"training_smpl/{key}", cur_step,
                   lambda val=val: vis.pose_vis_3d(val[0], tb_pair_ids,
                                                   tb_parent_ids))
        elif key.startswith("depth_map") and not simple_version:
            mode = key.split("depth_map_")[1]
            joints = x.get(f"{mode}_joints")
            if joints is None:
                continue
            figure(tb_log, f"training_depth/{key}", cur_step,
                   lambda val=val, joints=joints: vis.depth_heatmap_vis(
                       val, np.asarray(joints[0])))
        elif "logits" in key and not simple_version:
            tb_log.add_scalar(
                f"training_disc/{key}", float(val[0].squeeze()), cur_step
            )

    if "kp_gt_world" in output:
        figure(tb_log, "training_pose_3d/src_gt_pose_3d", cur_step,
               lambda: vis.pose_vis_3d(np.asarray(output["kp_gt_world"])[0],
                                       tb_pair_ids, tb_parent_ids))
