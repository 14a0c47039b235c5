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
