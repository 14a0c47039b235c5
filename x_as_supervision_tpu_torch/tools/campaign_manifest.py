"""Dataset manifest for the self-rendered accuracy campaign: the port's copy
of the JAX package's tools/campaign_manifest.py.

Records what a `render_campaign` invocation produced (the render args,
every hm36 camera folder's frame and mask counts and annotation digest, and
the pseudo stream's index digest) so a campaign dataset can be (a)
regenerated from its recorded args and (b) verified identical after
regeneration.

Pixel data is summarized by per-folder counts plus digests of the first and
last frame of each camera folder: renders are per-folder and per-segment
seed-deterministic, so the sentinel digests change whenever a regeneration
diverges, without hashing every image.

Usage:
  python -m x_as_supervision_tpu_torch.tools.campaign_manifest <root>
      # writes <root>/manifest.json from a disk scan
  python -m x_as_supervision_tpu_torch.tools.campaign_manifest <root> \
      --check [--manifest <reference.json>]
      # rescans and verifies against the reference manifest (default:
      # <root>/manifest.json); exits nonzero on any mismatch
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import sys


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def scan(root: str) -> dict:
    """Content summary of a rendered campaign dataset on disk."""
    out: dict = {"hm36": {}, "pseudo": {}}
    hm = os.path.join(root, "hm36")
    for meta in sorted(
        glob.glob(os.path.join(hm, "annot", "*", "matlab_meta.txt"))
    ):
        cam_folder = os.path.basename(os.path.dirname(meta))
        imgs = sorted(glob.glob(
            os.path.join(hm, "images", cam_folder, "*.jpg")
        ))
        masks = sorted(glob.glob(
            os.path.join(root, "sam_masks", "hm36", cam_folder, "*.png")
        ))
        entry = {
            "frames": len(imgs),
            "masks": len(masks),
            "meta_md5": _md5(meta),
        }
        if imgs:
            entry["img_first_md5"] = _md5(imgs[0])
            entry["img_last_md5"] = _md5(imgs[-1])
        if masks:
            entry["mask_first_md5"] = _md5(masks[0])
            entry["mask_last_md5"] = _md5(masks[-1])
        out["hm36"][cam_folder] = entry

    pseudo = os.path.join(root, "surreal_h36m_pose")
    info = os.path.join(pseudo, "info.npy")
    if os.path.isfile(info):
        joints = hashlib.md5()
        n_joint_files = 0
        for p in sorted(glob.glob(os.path.join(pseudo, "joints", "*"))):
            with open(p, "rb") as f:
                joints.update(f.read())
            n_joint_files += 1
        out["pseudo"] = {
            "frames": len(glob.glob(os.path.join(pseudo, "image", "*"))),
            "masks": len(glob.glob(os.path.join(pseudo, "mask", "*"))),
            "joint_files": n_joint_files,
            "joints_md5": joints.hexdigest(),
            "info_md5": _md5(info),
        }
    return out


def write_manifest(root: str, render_args: dict) -> str:
    path = os.path.join(root, "manifest.json")
    with open(path, "w") as f:
        json.dump(
            {"render_args": render_args, "data": scan(root)},
            f, indent=1, sort_keys=True,
        )
    return path


def _diff(ref: dict, got: dict, prefix: str = "") -> list[str]:
    lines = []
    for k in sorted(set(ref) | set(got)):
        where = f"{prefix}{k}"
        if k not in ref:
            lines.append(f"unexpected: {where}")
        elif k not in got:
            lines.append(f"missing:    {where}")
        elif isinstance(ref[k], dict) and isinstance(got[k], dict):
            lines.extend(_diff(ref[k], got[k], where + "/"))
        elif ref[k] != got[k]:
            lines.append(f"mismatch:   {where}: {ref[k]} != {got[k]}")
    return lines


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("root")
    p.add_argument("--check", action="store_true")
    p.add_argument("--manifest", default=None,
                   help="reference manifest for --check "
                        "(default: <root>/manifest.json)")
    args = p.parse_args()

    if not args.check:
        print(write_manifest(args.root, {}))
        return

    ref_path = args.manifest or os.path.join(args.root, "manifest.json")
    with open(ref_path) as f:
        ref = json.load(f)["data"]
    lines = _diff(ref, scan(args.root))
    if lines:
        print(f"manifest check FAILED against {ref_path}:")
        print("\n".join(lines[:50]))
        sys.exit(1)
    print(f"manifest check OK against {ref_path}")


if __name__ == "__main__":
    main()
