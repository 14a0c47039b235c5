"""The port's serving path (x_as_supervision_tpu_torch/serve.py, infer.py)
against the JAX package's, on the same weights; device selection; and that
the port loads nothing of JAX."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import conditioned_pair
from x_as_supervision_tpu.ops import geometry as JG
from x_as_supervision_tpu.serve import PoseEstimator as JaxPoseEstimator
from x_as_supervision_tpu_torch.serve import PoseEstimator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DET18 = dict(name="resnet_multi", num_kp=18, depth_dim=8, num_hypo=2,
             neighbor_size=3, num_layers=18)
CONFIG = {
    "dataset_params": {
        "cam_id_list": [0],
        "dataiter": {"mean": [0.0, 0.0, 0.0], "std": [255.0, 255.0, 255.0]},
    },
    "model_params": {"detector_params": DET18},
    "train_params": {"patch_width": 64, "patch_height": 64},
}


@pytest.fixture(scope="module")
def pair():
    """(JAX estimator, port estimator on the CPU) on the same weights."""
    _, jvars, tdet, _ = conditioned_pair(DET18, 64, 4, seed=1)
    jest = JaxPoseEstimator(CONFIG, det_vars=jvars, batch_size=4,
                            dtype=jnp.float32)
    est = PoseEstimator(CONFIG, det_state=tdet.state_dict(), batch_size=4,
                        dtype=torch.float32, device="cpu")
    return jest, est


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (n, 64, 64, 3)).astype(np.float32)


def test_outputs_match_jax(pair):
    jest, est = pair
    imgs = _images(6)
    got, want = est(imgs), jest(imgs)
    assert got.kps_patch.shape == (6, 2, 18, 3)
    # fp32 through 18 layers, convs summed in another order
    np.testing.assert_allclose(got.kps_patch, want.kps_patch, atol=1e-5)
    np.testing.assert_allclose(got.kps_pixels, want.kps_pixels, atol=1e-3)
    np.testing.assert_allclose(
        got.kps_pixels[..., 0], (got.kps_patch[..., 0] + 1) / 2 * 63,
        atol=1e-4)
    np.testing.assert_allclose(got.kps_pixels[..., 2],
                               got.kps_patch[..., 2] * 63, atol=1e-4)


def test_results_do_not_depend_on_chunking(pair):
    _, est = pair
    imgs = _images(6, seed=1)
    whole = est(imgs).kps_patch
    single = est(imgs[5:6]).kps_patch
    np.testing.assert_allclose(single[0], whole[5], atol=2e-5)


def test_lift_to_world_matches_jax_geometry(pair):
    _, est = pair
    rng = np.random.default_rng(1)
    n, h = 3, 2
    kps = rng.uniform(-0.5, 0.5, (n, h, 18, 3)).astype(np.float32)
    rot = np.stack([
        np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(n)
    ]).astype(np.float32)
    cam = {
        "trans_image": np.tile(
            np.array([[0.25, 0.02, 8.0], [-0.01, 0.25, 4.0]], np.float32),
            (n, 1, 1)),
        "pelvis": rng.uniform(4000, 6000, (n, 3)).astype(np.float32),
        "k_mat": np.tile(
            np.array([[1000.0, 0, 500], [0, 1100.0, 480], [0, 0, 1]],
                     np.float32), (n, 1, 1)),
        "rot_world": rot,
        "trans_world": rng.normal(0, 100, (n, 3)).astype(np.float32),
    }
    world = est.lift_to_world(kps, cam)
    assert world.shape == (n, h, 18, 3)
    for hypo in range(h):
        params = {
            "cam_0_trans_image": jnp.asarray(cam["trans_image"]),
            "cam_0_img": jnp.zeros((n, 64, 64, 3)),
            "cam_0_pelvis": jnp.asarray(cam["pelvis"]),
            "cam_0_k_mat": jnp.asarray(cam["k_mat"]),
            "cam_0_trans_world": jnp.asarray(cam["trans_world"]),
            "cam_0_rot_world": jnp.asarray(cam["rot_world"]),
        }
        want = JG.convert_patch_to_world(jnp.asarray(kps[:, hypo]), params,
                                         "cam_0", is_norm=True)
        # fp32 on world coordinates of a few 1e3 mm
        np.testing.assert_allclose(world[:, hypo], np.asarray(want),
                                   rtol=1e-5, atol=1e-2)


def test_default_device_without_cuda_raises(pair, monkeypatch):
    _, est = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoseEstimator(CONFIG, det_state=est.detector.state_dict())


def test_infer_cli_matches_estimator(pair, tmp_path):
    import cv2
    import yaml

    from x_as_supervision_tpu.tools.convert_torch_resnet import (
        _flatten_into,
        convert_full_detector,
    )
    from x_as_supervision_tpu_torch import infer

    _, est = pair
    imgs = _images(3, seed=2).astype(np.uint8)
    (tmp_path / "imgs").mkdir()
    for i, img in enumerate(imgs):
        cv2.imwrite(str(tmp_path / "imgs" / f"{i}.png"), img[..., ::-1])
    sd = {k: v.numpy() for k, v in est.detector.state_dict().items()}
    params, stats = convert_full_detector(sd, 18)
    flat = {}
    _flatten_into(flat, params, (), "params")
    _flatten_into(flat, stats, (), "batch_stats")
    np.savez(tmp_path / "det.npz", **flat)
    cfg = dict(CONFIG, train_params=dict(
        CONFIG["train_params"], num_epochs=1, batch_size=4,
        lr_kp_detector=1e-4))
    cfg["model_params"] = dict(cfg["model_params"], loss_config={})
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))

    infer.main(["--config", str(tmp_path / "cfg.yaml"),
                "--weights", str(tmp_path / "det.npz"),
                "--images", str(tmp_path / "imgs"),
                "--out", str(tmp_path / "poses.json"), "--device", "cpu"])
    out = json.loads((tmp_path / "poses.json").read_text())
    # the CLI serves in the default bf16, as the JAX CLI does
    want = PoseEstimator(CONFIG, det_state=est.detector.state_dict(),
                         device="cpu")(imgs.astype(np.float32))
    for i in range(3):
        np.testing.assert_allclose(out[f"{i}.png"]["kps_patch_norm"],
                                   want.kps_patch[i], atol=1e-6)


def test_chip_smoke_without_cuda_fails_without_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import x_as_supervision_tpu_torch as p\n"
        "names = [m.name for m in\n"
        "         pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'x_as_supervision_tpu')]\n"
        "print(len(names))\n"
        "print(' '.join(names))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # every module: config, infer, serve, weights, models/{,detector,resnet},
    # ops/{,_build,conv_bn,geometry,integral,integral_kernel}, and the
    # datasets of data/
    count, names = res.stdout.strip().splitlines()[-2:]
    assert int(count) >= 13
    for mod in ("affine", "augment", "dataloader_2d", "factory", "geodesic",
                "hm36", "imdb", "loader", "mpi_inf_3dhp", "mpii", "pipeline",
                "samples"):
        assert f"x_as_supervision_tpu_torch.data.{mod}" in names.split()
    # the 2D path's entry points and the figure writers
    for mod in ("eval2d", "train2d3d", "train.figures"):
        assert f"x_as_supervision_tpu_torch.{mod}" in names.split()
