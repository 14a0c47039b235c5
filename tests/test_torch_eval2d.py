"""The port's 2D eval (x_as_supervision_tpu_torch/eval2d.py: evaluate_pckh,
the eval2d CLI), its TikTok train CLI (train2d3d.py), serving from a
checkpoint of the port (serve.py, infer.py), the offline figure writers
(train/figures.py) and the JSON copies of the 2D configs, on the CPU,
against the JAX package where it has the same function.

The MPII fixture is x_as_supervision_tpu_torch/checks.py:write_mini_mpii
(the dataset's layout); the protocol cases are those of the JAX package's
tests/test_eval2d_cli.py, on the port's function.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")
pytest.importorskip("scipy.io")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import conditioned_pair  # noqa: E402
from x_as_supervision_tpu_torch import checks  # noqa: E402
from x_as_supervision_tpu_torch.data.dataloader_2d import (  # noqa: E402
    mpii_dataset,
)
from x_as_supervision_tpu_torch.data.hm36 import (  # noqa: E402
    S_HM36_2_MPII_JT,
)
from x_as_supervision_tpu_torch.data.mpii import (  # noqa: E402
    MPII_FLIP_PAIRS,
    mpii,
)
from x_as_supervision_tpu_torch.eval2d import evaluate_pckh  # noqa: E402
from x_as_supervision_tpu_torch.serve import PoseEstimator  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCH = 64
IMAGES = 8
BATCH = 4
TINY_DETECTOR = {"name": "resnet_multi", "num_kp": 18, "depth_dim": 8,
                 "num_hypo": 3, "neighbor_size": 3, "num_layers": 18}


@pytest.fixture(scope="module")
def mini_mpii(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mpii2d"))
    return checks.write_mini_mpii(root, n_images=IMAGES, size_hw=(240, 320),
                                  seed=7)


@pytest.fixture(scope="module")
def mpii_ds(mini_mpii):
    path, masks = mini_mpii
    return mpii_dataset(mpii("valid", path, masks, PATCH, PATCH, ""),
                        patch_size=PATCH)


# evaluate_pckh calls forward_fn(imgs) without the batch; the stubs need
# its GT, so the dataset's batch() is wrapped to keep the last one
_CUR = [None]


@pytest.fixture()
def capture(monkeypatch, mpii_ds):
    orig = mpii_ds.batch

    def batch(start, size):
        _CUR[0] = orig(start, size)
        return _CUR[0]

    monkeypatch.setattr(mpii_ds, "batch", batch)
    return mpii_ds


def _gt_as_pred(batch, num_hypo=1, swap_lr=False):
    """Detector-contract predictions (B, H, 18, 3) whose MPII projection
    equals the batch GT (optionally every L/R pair swapped)."""
    gt16 = np.asarray(batch["cam_mono_joints"])[..., :2]
    if swap_lr:
        perm = list(range(16))
        for a, b in MPII_FLIP_PAIRS:
            perm[a], perm[b] = perm[b], perm[a]
        gt16 = gt16[:, perm]
    pred18 = np.zeros((gt16.shape[0], 18, 2))
    for mpii_idx, hm_idx in enumerate(S_HM36_2_MPII_JT):
        pred18[:, hm_idx] = gt16[:, mpii_idx]
    norm = pred18 / (PATCH - 1) * 2 - 1
    kps = np.concatenate([norm, np.zeros_like(norm[..., :1])], -1)
    return np.tile(kps[:, None], (1, num_hypo, 1, 1))


def test_exact_gt_scores_one_hundred(capture):
    got = evaluate_pckh(capture, lambda imgs: _gt_as_pred(_CUR[0]), PATCH,
                        BATCH, "confident")
    assert got == pytest.approx(100.0)


def test_swapped_gt_rescued_by_switch(capture):
    got = evaluate_pckh(capture,
                        lambda imgs: _gt_as_pred(_CUR[0], swap_lr=True),
                        PATCH, BATCH, "confident")
    assert got == pytest.approx(100.0)


def test_shift_beyond_half_a_head_scores_zero(capture):
    """Every joint moved by more than any head size and any joint-to-joint
    distance of the crop, so that no L/R switch rescues one."""
    def fwd(imgs):
        kps = _gt_as_pred(_CUR[0])
        kps[..., 0] += 4.0
        return kps

    assert evaluate_pckh(capture, fwd, PATCH, BATCH, "confident") == \
        pytest.approx(0.0)


def test_best_gather_recovers_the_gt_hypothesis(capture):
    def fwd(imgs):
        kps = _gt_as_pred(_CUR[0], num_hypo=3)
        kps[:, 0] += 0.9  # hypothesis 0 far off
        kps[:, 2] -= 0.7
        return kps  # hypothesis 1 the GT

    assert evaluate_pckh(capture, fwd, PATCH, BATCH, "best") == \
        pytest.approx(100.0)
    assert evaluate_pckh(capture, fwd, PATCH, BATCH, "confident") < 50.0


@pytest.mark.parametrize("mode", ["best", "confident"])
def test_evaluate_pckh_matches_jax(mpii_ds, monkeypatch, mode):
    """The same random predictions through both packages' evaluate_pckh:
    the PCKh equal, the back-mapped points within 1e-4 px."""
    from eval2d import evaluate_pckh as jax_evaluate_pckh
    from x_as_supervision_tpu.train import metrics as JM

    def forward(seed):
        rng = np.random.default_rng(seed)

        def fwd(imgs):
            kps = rng.uniform(-0.9, 0.9, (len(imgs), 3, 18, 3))
            return kps.astype(np.float32)

        return fwd

    seen = []
    orig = JM.keypoint_pckh

    def spy(pred, gt, head, *a, **k):
        seen.append((np.asarray(pred), np.asarray(gt)))
        return orig(pred, gt, head, *a, **k)

    monkeypatch.setattr(JM, "keypoint_pckh", spy)
    want = jax_evaluate_pckh(mpii_ds, forward(1), float(PATCH), BATCH, mode)
    points = []
    got = evaluate_pckh(mpii_ds, forward(1), float(PATCH), BATCH, mode,
                        points)
    assert got == want
    assert 0.0 < got < 100.0
    assert len(points) == len(seen) == len(mpii_ds) // BATCH
    for (gp, gg), (wp, wg) in zip(points, seen):
        np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(gg, wg)


def test_jax_detector_and_its_port_score_the_same(mpii_ds):
    """A flax-initialized detector carried into the port (weights.py,
    conditioned), both in fp32 on the MPII crops: the same PCKh."""
    jdet, jvars, tdet, _ = conditioned_pair(TINY_DETECTOR, PATCH, 4, seed=2)
    tdet.eval()

    def jax_fwd(imgs):
        return np.asarray(jdet.apply(jvars, jnp.asarray(imgs), train=False)
                          .kps)

    @torch.inference_mode()
    def port_fwd(imgs):
        return tdet(torch.from_numpy(imgs).permute(0, 3, 1, 2)).kps.numpy()

    imgs = mpii_ds.batch(0, BATCH)["cam_mono_img"]
    np.testing.assert_allclose(port_fwd(imgs), jax_fwd(imgs), atol=1e-4)
    for mode in ("best", "confident"):
        assert evaluate_pckh(mpii_ds, port_fwd, PATCH, BATCH, mode) == \
            evaluate_pckh(mpii_ds, jax_fwd, PATCH, BATCH, mode)


# ------------------------------------------------------------------- CLIs


@pytest.fixture(scope="module")
def mono_run(tmp_path_factory, mini_mpii):
    """train2d3d on a tiny TikTok fixture (2 steps of 2, the pseudo stream
    on, the shipped config's losses on a tiny model) -> its checkpoint ->
    eval2d on the MPII fixture, both CLIs on the CPU."""
    root = str(tmp_path_factory.mktemp("mono_cli"))
    data = checks.write_mini_tiktok(root, n_frames=44, size_hw=(150, 90),
                                    seed=1)
    pseudo = checks.write_surreal_pseudo(
        os.path.join(root, "surreal_h36m_pose"), 6, seed=2, size=PATCH)
    cfg = json.load(open(os.path.join(
        REPO, "x_as_supervision_tpu_torch", "configs",
        "TikTok_Multi_S1.json")))
    cfg["dataset_params"]["dataset"]["path"] = data
    cfg["dataset_params"]["smpl_pseudo_img"]["data_path"] = pseudo
    mp = cfg["model_params"]
    mp["detector_params"].update(TINY_DETECTOR)
    mp["smpl_disc_params"].update(input_dim=16, hidden_dim=16, output_dim=16)
    mp["physique_mask_generator_params"]["layers"] = [4, 8]
    cfg["train_params"].update(batch_size=2, num_epochs=1, checkpoint_freq=1)
    tik = os.path.join(root, "TikTok_Tiny.json")
    json.dump(cfg, open(tik, "w"))
    log = os.path.join(root, "log")
    res = subprocess.run(
        [sys.executable, "-m", "x_as_supervision_tpu_torch.train2d3d",
         "--config", tik, "--seed", "0", "--log_dir", log, "--device",
         "cpu", "--fp32", "--worker", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    (run,) = os.listdir(log)
    ckpt = os.path.join(log, run, "00000_ckpt")

    path, masks = mini_mpii
    mcfg = json.load(open(os.path.join(
        REPO, "x_as_supervision_tpu_torch", "configs", "MPII_2D.json")))
    mcfg["dataset_params"]["dataset"].update(path=path, mask_path=masks)
    mcfg["model_params"]["detector_params"].update(TINY_DETECTOR)
    mcfg["train_params"].update(batch_size=BATCH, patch_width=PATCH,
                                patch_height=PATCH)
    mpii_cfg = os.path.join(root, "MPII_Tiny.json")
    json.dump(mcfg, open(mpii_cfg, "w"))
    res_eval = subprocess.run(
        [sys.executable, "-m", "x_as_supervision_tpu_torch.eval2d",
         "--config", mpii_cfg, "--checkpoint", ckpt, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    return dict(train=res, eval=res_eval, run=os.path.join(log, run),
                ckpt=ckpt, mpii_cfg=mpii_cfg, root=root)


def test_train2d3d_cli_runs_on_cpu(mono_run):
    lines = [ln for ln in mono_run["train"].stdout.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 2  # 4 frames after the trim, batches of 2
    for ln in lines:
        values = dict(kv.split("=") for kv in ln.split() if "=" in kv)
        # the shipped config's losses: no symmetry loss configured
        assert sorted(values) == [
            "loss/physique_recons", "loss/reconstruction", "loss/smpl_gen",
            "loss/smpl_pseudo_img", "loss_disc", "loss_total"]
        assert np.isfinite([float(v) for v in values.values()]).all()
    # (eval/ is eval2d's, which the fixture ran after training)
    assert sorted(os.listdir(mono_run["run"])) == [
        "00000_ckpt", "TikTok_Tiny.json", "eval", "tensorboard"]
    events = checks.events_in(os.path.join(mono_run["run"], "tensorboard"))
    (name,) = events
    tags = {t for e in events[name] for t in e["scalars"]}
    assert "training_loss/smpl_pseudo_img" in tags


def test_eval2d_cli_runs_on_cpu(mono_run):
    res = mono_run["eval"]
    assert res.returncode == 0, res.stderr[-3000:]
    out = os.path.join(mono_run["run"], "eval", "eval2d_result.txt")
    line = open(out).read().strip()
    key, value = line.split(":")
    assert key == "PCKh@0.5" and 0.0 <= float(value) <= 100.0
    assert f"PCKh@0.5: {float(value)}" in res.stdout


def test_serving_from_a_checkpoint(mono_run, mpii_ds, tmp_path):
    """PoseEstimator(checkpoint_path=...) and infer --checkpoint give what
    serving the checkpoint's detector state_dict gives."""
    from x_as_supervision_tpu_torch.config import load_config
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt

    cfg = load_config(mono_run["mpii_cfg"])
    imgs = (mpii_ds.batch(0, 3)["cam_mono_img"] * 255).astype(np.uint8)
    kw = dict(batch_size=2, dtype=torch.float32, device="cpu")
    got = PoseEstimator(cfg, checkpoint_path=mono_run["ckpt"], **kw)(imgs)
    want = PoseEstimator(cfg, det_state=ckpt.restore_detector(
        mono_run["ckpt"]), **kw)(imgs)
    np.testing.assert_array_equal(got.kps_patch, want.kps_patch)
    with pytest.raises(ValueError, match="checkpoint_path"):
        PoseEstimator(cfg, **kw)

    img_dir = tmp_path / "patches"
    img_dir.mkdir()
    for i, img in enumerate(imgs):
        cv2.imwrite(str(img_dir / f"{i}.png"), img[..., ::-1])
    out = tmp_path / "poses.json"
    res = subprocess.run(
        [sys.executable, "-m", "x_as_supervision_tpu_torch.infer",
         "--config", mono_run["mpii_cfg"], "--checkpoint", mono_run["ckpt"],
         "--images", str(img_dir), "--out", str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    poses = json.load(open(out))
    # the CLI computes in bf16, as PoseEstimator's default
    bf16 = PoseEstimator(cfg, checkpoint_path=mono_run["ckpt"],
                         device="cpu")(imgs.astype(np.float32))
    for i in range(3):
        np.testing.assert_allclose(poses[f"{i}.png"]["kps_patch_norm"],
                                   bf16.kps_patch[i], atol=1e-6)
    res = subprocess.run(
        [sys.executable, "-m", "x_as_supervision_tpu_torch.infer",
         "--config", mono_run["mpii_cfg"], "--images", str(img_dir),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "--checkpoint" in res.stderr


# ---------------------------------------------------------------- figures


def test_figure_writers_match_jax(tmp_path):
    """The port's offline figure writers write the JAX package's files,
    byte for byte, from the same inputs."""
    pytest.importorskip("matplotlib")
    from x_as_supervision_tpu.train import figures as JF
    from x_as_supervision_tpu_torch.train import figures as PF

    rng = np.random.default_rng(0)
    flip = np.array([[1, 4], [2, 5], [3, 6], [14, 11], [15, 12], [16, 13]])
    parents = np.array([0, 0, 1, 2, 0, 4, 5, 0, 17, 8, 9, 17, 11, 12, 17,
                        14, 15, 7])
    img = rng.uniform(0, 1, (PATCH, PATCH, 3)).astype(np.float32)
    p2d = [rng.uniform(-0.8, 0.8, (18, 2)).astype(np.float32)
           for _ in range(2)]
    p3d = [rng.normal(scale=200.0, size=(18, 3)) for _ in range(2)]
    batch = {"cam_0_img": img[None], "cam_1_img": img[None] * 0.5}
    eval_out = {"kp_pred_2d": {"cam_0": p2d[0][None], "cam_1": p2d[1][None]},
                "tri": p3d[0][None], "kps_world_gt": p3d[1][None]}
    calls = {
        "draw": lambda F, o: F.draw(p2d[0], img, p2d[1], img, p3d[0], p3d[1],
                                    o, flip, parents),
        "draw_2d": lambda F, o: F.draw_2d(p2d[0], img, p2d[1], img, o, flip,
                                          parents),
        "draw_mono": lambda F, o: F.draw_mono(img, p2d[0], p3d[0], o, flip,
                                              parents),
        "draw_mono_2d": lambda F, o: F.draw_mono_2d(img, p2d[0], o, flip,
                                                    parents),
        "save_qualitative_figure": lambda F, o: F.save_qualitative_figure(
            batch, eval_out, 0, 1, o, flip, parents),
    }
    for name, call in calls.items():
        files = {}
        for side, mod in (("jax", JF), ("port", PF)):
            files[side] = str(tmp_path / f"{name}_{side}.png")
            call(mod, files[side])
        with open(files["jax"], "rb") as a, open(files["port"], "rb") as b:
            want, got = a.read(), b.read()
        assert len(got) > 10_000 and got == want, name


# ---------------------------------------------------------------- configs


# every shipped config (the card's machine has no yaml)
CONFIGS = sorted(f[:-len(".yaml")] for f in os.listdir(os.path.join(
    REPO, "config")) if f.endswith(".yaml"))


def test_every_shipped_config_has_a_json_copy():
    assert len(CONFIGS) == 17
    copies = sorted(f[:-len(".json")] for f in os.listdir(os.path.join(
        REPO, "x_as_supervision_tpu_torch", "configs")))
    assert copies == CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_json_config_is_the_yaml_config(name):
    with open(os.path.join(REPO, "config", f"{name}.yaml")) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(REPO, "x_as_supervision_tpu_torch", "configs",
                           f"{name}.json")) as f:
        got = json.load(f)
    assert got == want
