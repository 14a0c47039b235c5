"""The port's campaign renderer (x_as_supervision_tpu_torch/tools/
render_campaign.py) against the JAX package's tools/render_campaign.py: one
render per package of the same arguments (campaign_valid, 6 folders x 4
cameras x 2 frames at 64^2; 2 pseudo segments x 6 frames swept at
--sample_times 2; seed 0), compared file by file under
checks.CAMPAIGN_BOUNDS, whose comment gives each bound's reason. Measured
on the CPU: every hm36 JPEG and mask, segment mask and SMPL array equal;
kp numbers of matlab_meta.txt at most 2 units of their last printed digit
apart; .mat poses and joints3D 2.4e-7, joints2D 1.5e-5 px; the pseudo
joints 1.2e-7 where the crop is the same, and 3 of the 4 swept frames
cropped one pixel apart (the crop box's corners land on integers), their
joints 0.023 apart (3 px of 256), their masks 1.0 % of pixels.

Then the port's own render, damaged three ways, re-rendered by its CLI in
a process where jax and the JAX package cannot be imported, passes the
port's campaign_manifest --check against its first manifest.
"""

import glob
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import scipy.io as sio
import torch

from x_as_supervision_tpu.tools import render_campaign as JR
from x_as_supervision_tpu.tools import surreal_constructor as JSC
from x_as_supervision_tpu_torch import checks
from x_as_supervision_tpu_torch.tools import campaign_manifest as M
from x_as_supervision_tpu_torch.tools import render_campaign as R
from x_as_supervision_tpu_torch.tools import surreal_constructor as SC
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
SAMPLE_TIMES = 2
# the valid set twice: the second pass (seed + 1) finds every folder done
RENDER = ["--train_frames", "2", "--valid_frames", "2",
          "--pseudo_segments", "2", "--pseudo_frames", "6",
          "--sample_times", str(SAMPLE_TIMES), "--img_size", "64",
          "--seed", str(SEED), "--train_set", "campaign_valid",
          "--valid_set", "campaign_valid"]
B = checks.CAMPAIGN_BOUNDS


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    base = tmp_path_factory.mktemp("campaign")
    jax_root, port_root = str(base / "jax"), str(base / "port")
    with mock.patch.object(sys, "argv",
                           ["render_campaign", "--out", jax_root] + RENDER):
        JR.main()
    stats = R.main(["--out", port_root, "--device", "cpu"] + RENDER)
    diffs, bad = checks.campaign_diffs(jax_root, port_root)
    manifests = [json.load(open(os.path.join(r, "manifest.json")))
                 for r in (jax_root, port_root)]
    return dict(jax=jax_root, port=port_root, stats=stats, diffs=diffs,
                bad=bad, manifests=manifests)


def test_render_stats(renders):
    s = renders["stats"]
    assert s["device"] == "cpu"
    assert s["segments"]["count"] == 2 * 6
    assert s["train_set"]["count"] == 6 * 4 * 2
    assert s["valid_set"]["count"] == 0  # every folder already rendered
    info = np.load(os.path.join(renders["port"], "surreal_h36m_pose",
                                "info.npy"))
    assert s["sweep"]["count"] == len(info) > 0


def test_same_files_and_no_bound_broken(renders):
    assert checks._tree(renders["jax"]) == checks._tree(renders["port"])
    assert renders["bad"] == []


def test_smpl_assets_equal(renders):
    assert renders["diffs"]["smpl"] == 0.0
    names = sorted(os.listdir(os.path.join(renders["port"], "smpl_models")))
    assert names == ["J_regressor_h36m.npy", "humanoid_radii.npy",
                     "smpl_female.npz", "smpl_male.npz"]


def test_meta_within_printed_digits(renders):
    d = renders["diffs"]
    assert d["meta_units"] <= B["meta_units"]
    metas = glob.glob(os.path.join(renders["port"], "hm36", "annot", "*",
                                   "matlab_meta.txt"))
    assert len(metas) == 6 * 4
    for path in metas:
        units, other = checks._meta_units(
            path.replace(renders["port"], renders["jax"]), path)
        assert other == [] and units <= B["meta_units"]


def test_hm36_images_and_masks(renders):
    d = renders["diffs"]
    assert d["jpg_share"] <= B["jpg_share"]
    assert d["mask_share"] <= B["mask_share"]
    jpgs = glob.glob(os.path.join(renders["port"], "hm36", "images", "*",
                                  "*.jpg"))
    assert len(jpgs) == 6 * 4 * 2


def test_segment_mats(renders):
    d = renders["diffs"]
    for key in ("mat_pose", "mat_joints3d", "mat_joints2d"):
        assert d[key] <= B[key], (key, d[key])
    assert d["segm_share"] <= B["mask_share"]
    info = sio.loadmat(os.path.join(renders["port"], "surreal", "train",
                                    "run1", "seq1", "seg1_info.mat"))
    assert info["pose"].shape == (72, 6) and info["joints3D"].shape == \
        (3, 24, 6)


def test_pseudo_stream(renders):
    d = renders["diffs"]
    info = [np.load(os.path.join(r, "surreal_h36m_pose", "info.npy"))
            for r in (renders["jax"], renders["port"])]
    np.testing.assert_array_equal(*info)
    assert d["pseudo_joints"] <= B["pseudo_joints"]
    assert d["pseudo_image_share"] <= B["pseudo_image_share"]
    assert d["pseudo_moved_xy"] <= B["pseudo_moved_xy"]
    assert d["pseudo_moved_mask_share"] <= B["pseudo_moved_mask_share"]


def test_pseudo_crops_move_only_where_the_box_moved(renders):
    """Replays the sweep's frame draws: a swept frame's joints differ by
    more than pseudo_joints only where the two constructors' crop boxes
    differ (a corner that moves need not move the crop), and those boxes
    by one pixel at most."""
    port_root, jax_root = renders["port"], renders["jax"]
    smpl = os.path.join(port_root, "smpl_models")
    reg = np.load(os.path.join(smpl, "J_regressor_h36m.npy"))
    port = SC.SurrealConstructor(smpl, os.path.join(port_root, "_p"),
                                 h36m_regressor=reg)
    ref = JSC.SurrealConstructor(smpl, os.path.join(port_root, "_j"),
                                 h36m_regressor=reg)
    infos = sorted(glob.glob(os.path.join(port_root, "surreal", "train",
                                          "*", "*", "*_info.mat")))
    written = set(np.load(os.path.join(port_root, "surreal_h36m_pose",
                                       "info.npy")).tolist())
    np.random.seed(SEED)
    checked = 0
    for i, path in enumerate(infos):
        info = sio.loadmat(path)
        for ii, t in enumerate(SC.sample_time_idx(info, port.margin,
                                                  SAMPLE_TIMES)):
            idx = i * SAMPLE_TIMES + ii
            boxes = [np.concatenate(c.build_frame(info, t)[1:])[:, :2]
                     .astype(int) for c in (port, ref)]
            moved = np.abs(boxes[0] - boxes[1]).max()
            assert moved <= 1
            if idx not in written:
                continue
            rel = os.path.join("surreal_h36m_pose", "joints",
                               f"joint_{idx:06d}.npy")
            xy = np.abs(np.load(os.path.join(port_root, rel))[:, :2]
                        - np.load(os.path.join(jax_root, rel))[:, :2]).max()
            if xy > B["pseudo_joints"]:
                assert moved == 1, (idx, xy)
            checked += 1
    assert checked == len(written)


def test_manifest_counts_and_args(renders):
    jm, pm = renders["manifests"]
    assert checks.manifest_counts(jm) == checks.manifest_counts(pm)
    assert len(pm["data"]["hm36"]) == 6 * 4
    assert set(pm["render_args"]) == set(jm["render_args"]) | {"device"}
    assert pm["render_args"]["device"] == "cpu"
    agree = checks.manifest_agreement(jm, pm)
    assert agree["counts_equal"] and agree["digests"] == 6 * 4 * 5 + 2


def test_render_needs_a_card_unless_told_cpu(tmp_path):
    out = str(tmp_path / "none")
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            R.main(["--out", out])
        with pytest.raises(SystemExit):
            R.main(["--out", out, "--platform", "tpu"])
    assert not os.path.exists(out)
    stats = R.main(["--out", out, "--platform", "cpu", "--skip_pseudo",
                    "--skip_real"])
    assert stats["device"] == "cpu"
    assert os.path.isfile(os.path.join(out, "smpl_models", "smpl_male.npz"))


def _check(root: str, ref: str) -> int:
    with mock.patch.object(sys, "argv", ["campaign_manifest", root,
                                         "--check", "--manifest", ref]):
        try:
            M.main()
        except SystemExit as e:
            return e.code
    return 0


def test_regenerate_or_reuse_without_jax(renders, tmp_path):
    root = str(tmp_path / "data")
    shutil.copytree(renders["port"], root)
    ref = str(tmp_path / "manifest_ref.json")
    shutil.copy(os.path.join(root, "manifest.json"), ref)

    # the three kinds of damage of an interrupted render: one camera's last
    # mask, one segment's info.mat (its sentinel), the swept pseudo output
    victim = sorted(renders["manifests"][1]["data"]["hm36"])[5]
    os.remove(os.path.join(root, "sam_masks", "hm36", victim,
                           f"{victim}_000002.png"))
    os.remove(os.path.join(root, "surreal", "train", "run1", "seq1",
                           "seg1_info.mat"))
    shutil.rmtree(os.path.join(root, "surreal_h36m_pose"))
    assert _check(root, ref) == 1

    code = (
        "import runpy, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'x_as_supervision_tpu'):\n"
        "    sys.modules[name] = None\n"
        "sys.argv = ['render_campaign'] + sys.argv[1:]\n"
        "runpy.run_module('x_as_supervision_tpu_torch.tools.render_campaign',"
        " run_name='__main__')\n"
        "bad = [n for n, m in sys.modules.items() if m is not None and\n"
        "       n.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'x_as_supervision_tpu')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code, "--out", root, "--device", "cpu"]
        + RENDER, cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "skipping campaign_valid folder" in out
    assert "skipping pseudo segment 0" in out
    assert f"rendered campaign_valid folder {victim[:-6]}" in out
    assert _check(root, ref) == 0


def test_manifest_check_catches_divergence(renders, tmp_path):
    root = str(tmp_path / "data")
    shutil.copytree(renders["port"], root)
    ref = os.path.join(renders["port"], "manifest.json")
    assert _check(root, ref) == 0
    meta = sorted(glob.glob(os.path.join(root, "hm36", "annot", "*",
                                         "matlab_meta.txt")))[0]
    with open(meta, "a") as f:
        f.write("\n")
    assert _check(root, ref) == 1
