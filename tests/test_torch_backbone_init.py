"""The port's ImageNet backbone initialization
(x_as_supervision_tpu_torch/weights.py: resolve_backbone_init,
backbone_state_dict, init_backbone; the trainer's backbone_init and the
train CLI's --backbone_init) against the JAX package's
(tools/convert_torch_resnet.py), on files the tests write.

A torchvision-layout .pth and the JAX npz converted from it by the JAX
package's converter load into the same port state_dict, bitwise, and into
the same backbone as the JAX package's graft of that npz.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x_as_supervision_tpu.models.detector import build_detector as jax_build
from x_as_supervision_tpu.tools.convert_torch_resnet import (
    load_npz_into_variables,
)
from x_as_supervision_tpu.tools.convert_torch_resnet import (
    resolve_backbone_init as jax_resolve,
)
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu_torch.models.detector import build_detector
from x_as_supervision_tpu_torch.train.factory import flagship_config
from x_as_supervision_tpu_torch.train.trainer import Trainer
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

DEPTH = 18  # the tiny flagship config's backbone


def _det_params() -> dict:
    return flagship_config(tiny=True)["model_params"]["detector_params"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A torchvision ResNet-18 state_dict (the port's backbone names without
    ``net.backbone.``, seeded weights and statistics, an fc layer and
    num_batches_tracked as torchvision saves them) and the JAX package's
    npz converted from it."""
    root = tmp_path_factory.mktemp("pretrained")
    det = build_detector(_det_params())
    weights.init_weights(det, 11)
    gen = torch.Generator().manual_seed(12)
    sd = {}
    for k, v in det.state_dict().items():
        if not k.startswith("net.backbone."):
            continue
        name = k[len("net.backbone."):]
        if "running_var" in name:
            v = torch.rand(v.shape, generator=gen) + 0.5
        elif v.is_floating_point():
            v = v + 0.1 * torch.randn(v.shape, generator=gen)
        else:
            v = torch.tensor(7)
        sd[name] = v
    sd["fc.weight"] = torch.randn(1000, 512, generator=gen)
    sd["fc.bias"] = torch.zeros(1000)
    pth = str(root / "resnet18.pth")
    torch.save(sd, pth)
    npz = jax_resolve(pth, DEPTH)  # the JAX converter's npz beside it
    assert npz.endswith("_r18.npz") and os.path.isfile(npz)
    return dict(sd=sd, pth=pth, npz=npz)


def test_pth_and_npz_load_the_same_backbone(files):
    from_pth = weights.backbone_state_dict(files["pth"])
    from_npz = weights.backbone_state_dict(files["npz"])
    assert sorted(from_pth) == sorted(from_npz)
    for k in from_pth:
        assert torch.equal(from_pth[k], from_npz[k]), k
    # every backbone tensor but the step counters, none of fc
    det = build_detector(_det_params())
    want = {k for k in det.state_dict()
            if k.startswith("net.backbone.") and "num_batches" not in k}
    assert set(from_pth) == want
    for k, v in from_pth.items():
        assert torch.equal(v, files["sd"][k[len("net.backbone."):]].float())


def test_init_backbone_matches_the_jax_graft(files):
    """The port's detector after init_backbone(npz) against the JAX
    detector's variables after load_npz_into_variables(npz), carried into
    the port's names: the backbone equal, bitwise; the head untouched."""
    jdet = jax_build(_det_params(), dtype=jnp.float32)
    init = jdet.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                     train=False)
    grafted = load_npz_into_variables(files["npz"], init)
    want = weights.state_dict_from_variables(
        jax.tree_util.tree_map(np.asarray, grafted))
    det = build_detector(_det_params())
    det.load_state_dict(weights.state_dict_from_variables(
        jax.tree_util.tree_map(np.asarray, init)))
    head = {k: v.clone() for k, v in det.state_dict().items()
            if k.startswith("net.head.")}
    weights.init_backbone(det, files["npz"])
    got = det.state_dict()
    for k, v in want.items():
        if "num_batches" not in k:
            assert torch.equal(got[k], v), k
    for k, v in head.items():
        assert torch.equal(got[k], v), k


def test_auto_detection_under_data_pretrained(files, tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.chdir(tmp_path)
    assert weights.resolve_backbone_init(None, DEPTH) is None
    assert jax_resolve(None, DEPTH) is None
    os.makedirs("data/pretrained")
    base = os.path.join("data", "pretrained", f"resnet{DEPTH}_imagenet")
    shutil.copy(files["pth"], base + ".pth")
    assert weights.resolve_backbone_init(None, DEPTH) == base + ".pth"
    assert weights.resolve_backbone_init(None, 50) is None
    # the trainer finds it when nothing names a file
    cfg = flagship_config(tiny=True)
    cfg["train_params"].update(batch_size=2, num_epochs=1)
    ds = SyntheticPoseDataset(num_samples=4, cam_id_list=(0, 1),
                              patch_size=64)
    trainer = Trainer(cfg, ds, seed=0, dtype=torch.float32, device="cpu",
                      num_workers=1)
    assert f"backbone initialized from {base}.pth" in capsys.readouterr().out
    got = trainer.spec.detector.state_dict()
    for k, v in weights.backbone_state_dict(files["pth"]).items():
        assert torch.equal(got[k], v), k
    # an npz there comes first, as in the JAX package
    shutil.copy(files["npz"], base + ".npz")
    assert weights.resolve_backbone_init(None, DEPTH) == base + ".npz"
    assert jax_resolve(None, DEPTH) == base + ".npz"


def test_missing_or_unknown_files_raise_as_in_jax(tmp_path):
    for spec in (str(tmp_path / "nope.npz"), str(tmp_path / "nope.pth"),
                 str(tmp_path / "nope.pth.tar"), str(tmp_path / "w.ckpt")):
        with pytest.raises((FileNotFoundError, ValueError)) as want:
            jax_resolve(spec, DEPTH)
        with pytest.raises(want.type) as got:
            weights.resolve_backbone_init(spec, DEPTH)
        assert str(got.value) == str(want.value)


def test_a_backbone_of_another_depth_is_refused(files, tmp_path):
    det = build_detector({**_det_params(), "num_layers": 50})
    with pytest.raises((ValueError, RuntimeError)):
        weights.init_backbone(det, files["pth"])


def test_train_cli_backbone_init(files, tmp_path, capsys):
    """--backbone_init, and detector_params.backbone_init in the config."""
    from x_as_supervision_tpu_torch.train.__main__ import main

    cfg = flagship_config(tiny=True)
    cfg["train_params"].update(batch_size=2, num_epochs=1)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    args = ["--config", str(path), "--synthetic", "--seed", "0", "--device",
            "cpu", "--fp32", "--steps", "0", "--worker", "1"]
    by_flag = main(args + ["--backbone_init", files["pth"],
                           "--log_dir", str(tmp_path / "a")])
    cfg["model_params"]["detector_params"]["backbone_init"] = files["npz"]
    path.write_text(json.dumps(cfg))
    by_config = main(args + ["--log_dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert f"backbone initialized from {files['pth']}" in out
    assert f"backbone initialized from {files['npz']}" in out
    a = by_flag.spec.detector.state_dict()
    b = by_config.spec.detector.state_dict()
    for k, v in weights.backbone_state_dict(files["pth"]).items():
        assert torch.equal(a[k], v) and torch.equal(b[k], v), k
