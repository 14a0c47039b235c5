"""A JAX (Orbax) train checkpoint carried into the port by
scripts/jax_checkpoint_to_torch.py (x_as_supervision_tpu_torch/convert.py's
mapping), on the CPU.

The JAX tiny flagship state after one jitted fused step (so the Adam
moments, the counts and the carried discriminator gradient are not zero;
the detector conditioned first, as tests/torch_parity.py:conditioned_pair
does, for a stable eval forward) is saved by the JAX package's
save_checkpoint, converted by the script and restored by the port's
restore_resume:

  * every parameter, statistic, Adam moment and count, the carried
    gradient, step and epoch equal the JAX state's under the mapping,
    bitwise;
  * the next step from the restored state matches JAX's next step within
    tests/step_bounds.py (losses 1e-4 relative, as tests/test_torch_train.py);
  * restore_finetune takes the weights only, and PoseEstimator on the
    checkpoint matches the JAX package's PoseEstimator on the JAX detector
    within tests/test_torch_serve.py's bounds.

And, from the initial state's shapes alone (jax.eval_shape, seeded values):
per-camera BatchNorm, the link's _StatsBN tree (fuse_bn), the phase head,
the other three discriminators (the flagship's decoupled SAGE one is
above), no physique net and no discriminator map every leaf of the JAX
state to a port tensor and fill every port tensor.
"""

from __future__ import annotations

import importlib.util
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from torch_parity import (
    assert_step_matches,
    jax_state_in_port_names,
    nchw,
    raw_train_state,
    to_numpy_tree,
    train_state_arrays,
)
from x_as_supervision_tpu.tools.convert_torch_resnet import (
    convert_full_detector,
)
from x_as_supervision_tpu.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu.serve import PoseEstimator as JaxPoseEstimator
from x_as_supervision_tpu.train import checkpoint as jax_ckpt
from x_as_supervision_tpu.train.factory import build_gan_spec as jax_spec
from x_as_supervision_tpu.train.state import (
    init_train_state,
    make_optimizers,
    make_train_step,
)
from x_as_supervision_tpu_torch.convert import (
    load_train_state,
    train_state_arrays_from_jax,
)
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.models.detector import (
    build_detector as torch_build,
)
from x_as_supervision_tpu_torch.serve import PoseEstimator
from x_as_supervision_tpu_torch.train import checkpoint as ckpt
from x_as_supervision_tpu_torch.train.factory import (
    build_gan_spec,
    flagship_config,
)
from x_as_supervision_tpu_torch.train.state import TrainState, train_step
from x_as_supervision_tpu_torch.train.trainer import to_device
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2
STEPS_PER_EPOCH = 10
LR = 1e-4


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch",
        os.path.join(REPO, "scripts", "jax_checkpoint_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _init(cfg: dict, batch):
    spec = jax_spec(cfg)
    opt_det, opt_disc = make_optimizers(cfg["train_params"], STEPS_PER_EPOCH)
    return spec, opt_det, opt_disc, batch


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_ckpt")
    cfg = _flagship_config(tiny=True)
    ds = SyntheticPoseDataset(num_samples=2 * BATCH, cam_id_list=(0, 1),
                              patch_size=64)
    batches = [ds.device_batch(i * BATCH, BATCH) for i in range(2)]
    spec, opt_det, opt_disc, _ = _init(cfg, batches[0])
    js = jax.jit(lambda k: init_train_state(spec, k, batches[0], opt_det,
                                            opt_disc))(jax.random.PRNGKey(0))
    # the detector conditioned for a stable eval forward in the port and
    # carried back, as tests/torch_parity.py:conditioned_pair does
    det_params = cfg["model_params"]["detector_params"]
    tdet = torch_build(det_params)
    tdet.load_state_dict(weights.state_dict_from_variables(to_numpy_tree(
        {"params": js.det_params, "batch_stats": js.det_stats})))
    images = np.random.default_rng(1).uniform(
        0, 1, (4, 64, 64, 3)).astype(np.float32)
    weights.condition_for_eval(tdet, nchw(images))
    params, stats = convert_full_detector(
        {k: v.numpy() for k, v in tdet.state_dict().items()},
        det_params["num_layers"])
    js = jax.tree.map(jnp.asarray, js.replace(det_params=params,
                                              det_stats=stats))
    step = make_train_step(spec, opt_det, opt_disc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        js1, _, _ = step(js, batches[0], jax.random.PRNGKey(0), do_disc=True,
                         do_gen=True, with_outputs=False)
        # the trainer bumps the epoch before it saves epoch 0
        js1 = js1.replace(epoch=jnp.asarray(1, jnp.int32))
        src = jax_ckpt.save_checkpoint(str(root / "jax"), 0, js1)
        # a host copy: the step donates its state's buffers
        host = jax.tree.map(np.array, js1)
        js2, jmetrics, _ = step(js1, batches[1], jax.random.PRNGKey(1),
                                do_disc=True, do_gen=True,
                                with_outputs=False)
    config = root / "tiny_flagship.json"
    config.write_text(json.dumps(flagship_config(tiny=True)))
    out = _converter().main(["--config", str(config), "--checkpoint", src,
                             "--out", str(root / "port")])
    return dict(js1=host, js2=js2, jmetrics=jmetrics, batch=batches[1],
                config=str(config), path=out)


def _port_state(config_path: str):
    from x_as_supervision_tpu_torch.config import load_config

    spec = build_gan_spec(load_config(config_path), torch.float32)
    return spec, TrainState(spec, load_config(config_path)["train_params"],
                            STEPS_PER_EPOCH)


def test_converted_checkpoint_restores_bitwise(carried):
    assert os.path.basename(carried["path"]) == "00000_ckpt"
    want = train_state_arrays(carried["js1"])
    spec, state = _port_state(carried["config"])
    ckpt.restore_resume(carried["path"], state)
    checked = set()

    def same(key, tensor):
        w = np.asarray(want[key])
        g = tensor.detach().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert np.array_equal(g, w), key
        checked.add(key)

    for prefix in ("detector", "physique", "discriminator"):
        for k, v in getattr(spec, prefix).state_dict().items():
            if "num_batches" not in k:
                same(f"var/{prefix}.{k}", v)
    for tag, opt, names, params in (
            ("det", state.opt_det, state.gen_names, state.gen_params),
            ("disc", state.opt_disc, state.disc_names, state.disc_params)):
        for n, p in zip(names, params):
            same(f"mu/{tag}/{n}", opt.state[p]["exp_avg"])
            same(f"nu/{tag}/{n}", opt.state[p]["exp_avg_sq"])
            assert float(opt.state[p]["step"]) == int(want[f"count/{tag}"])
    for n, g in zip(state.disc_names, state.pending_disc_grads):
        same(f"pending/{n}", g)
    assert state.det_updates == int(want["count/det"]) == 1
    assert state.disc_updates == int(want["count/disc"]) == 1
    assert (state.step, state.epoch) == (1, 1)
    assert checked | {"count/det", "count/disc", "step", "epoch"} == set(want)
    # one step moved the moments and left a gradient to carry
    assert any(np.abs(want[k]).max() > 0 for k in want
               if k.startswith("pending/"))
    assert all(np.abs(want[k]).max() > 0 for k in want
               if k.startswith("nu/det/detector.net.backbone.conv1"))


def test_step_after_restore_matches_jax(carried):
    spec, state = _port_state(carried["config"])
    ckpt.restore_resume(carried["path"], state)
    spec.discriminator.header.p_dropout = 0.0
    metrics = train_step(state, to_device(carried["batch"], "cpu"))
    for k, w in carried["jmetrics"].items():
        np.testing.assert_allclose(float(metrics[k]), float(w), rtol=1e-4,
                                   err_msg=k)
    got = {}
    for prefix in ("detector", "physique", "discriminator"):
        got.update({f"{prefix}.{k}": v.detach().clone() for k, v in
                    getattr(spec, prefix).state_dict().items()
                    if "num_batches" not in k})
    assert_step_matches(jax_state_in_port_names(carried["js2"]), got,
                        jax_state_in_port_names(carried["js1"]), spec, LR)


def test_finetune_and_serving_match_jax(carried):
    want = train_state_arrays(carried["js1"])
    spec, state = _port_state(carried["config"])
    ckpt.restore_finetune(carried["path"], state)
    for k, v in spec.detector.state_dict().items():
        if "num_batches" not in k:
            assert np.array_equal(v.numpy(), want["var/detector." + k]), k
    assert not state.opt_det.state and state.step == 0 == state.epoch
    assert ckpt.restore_detector(carried["path"]).keys() == \
        spec.detector.state_dict().keys()

    js1 = carried["js1"]
    config = {
        "dataset_params": {"cam_id_list": [0], "dataiter": {
            "mean": [0.0, 0.0, 0.0], "std": [255.0, 255.0, 255.0]}},
        "model_params": {"detector_params":
                         flagship_config(tiny=True)["model_params"][
                             "detector_params"]},
        "train_params": {"patch_width": 64, "patch_height": 64},
    }
    jest = JaxPoseEstimator(config, det_vars={
        "params": js1.det_params, "batch_stats": js1.det_stats},
        batch_size=4, dtype=jnp.float32)
    est = PoseEstimator(config, checkpoint_path=carried["path"],
                        batch_size=4, dtype=torch.float32, device="cpu")
    imgs = np.random.default_rng(0).uniform(
        0, 255, (6, 64, 64, 3)).astype(np.float32)
    got, ref = est(imgs), jest(imgs)
    # test_torch_serve.py's bounds
    np.testing.assert_allclose(got.kps_patch, ref.kps_patch, atol=1e-5)
    np.testing.assert_allclose(got.kps_pixels, ref.kps_pixels, atol=1e-3)


def _variant(flags: tuple) -> dict:
    cfg = _flagship_config(tiny=True)
    mp = cfg["model_params"]
    for flag in flags:
        if flag == "per_camera_bn":
            mp["per_camera_bn"] = True
        elif flag in ("fuse_bn", "phase_head"):
            mp["detector_params"][flag] = True
        elif flag == "no_physique":
            del mp["physique_mask_generator_params"]
        elif flag == "no_discriminator":
            del mp["smpl_disc_params"]
        else:
            mp["smpl_disc_params"].update(name=flag, use_bn=True)
    return cfg


# fuse_bn apart from per_camera_bn: grouped statistics take the plain path
@pytest.mark.parametrize("flags", [
    ("fuse_bn", "phase_head", "res_sage_gcn"),
    ("per_camera_bn", "res_gcn"),
    ("simple_gcn", "no_physique"),
    ("no_discriminator",),
], ids="+".join)
def test_every_leaf_maps_on_init(flags, monkeypatch):
    import x_as_supervision_tpu.models.detector as jax_detector

    cfg = _variant(flags)
    if "fuse_bn" in flags:
        # the link's _StatsBN tree is built where the kernel may run; its
        # shapes need no kernel
        monkeypatch.setattr(jax_detector, "pallas_ok", lambda: True)
    ds = SyntheticPoseDataset(num_samples=BATCH, cam_id_list=(0, 1),
                              patch_size=64)
    spec, opt_det, opt_disc, batch = _init(cfg, ds.device_batch(0, BATCH))
    assert spec.detector.fuse_bn == ("fuse_bn" in flags)
    shapes = jax.eval_shape(lambda k: init_train_state(
        spec, k, batch, opt_det, opt_disc), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    js = jax.tree.map(lambda s: rng.standard_normal(
        s.shape, np.float32) if s.dtype == np.float32
        else np.zeros(s.shape, s.dtype), shapes)
    arrays = train_state_arrays_from_jax(raw_train_state(js))
    pspec = build_gan_spec(cfg, torch.float32)
    state = TrainState(pspec, cfg["train_params"], STEPS_PER_EPOCH)
    load_train_state(pspec, state, arrays)  # raises on a tensor left unfilled
    # as many numbers on each side
    jax_leaves = [js.det_params, js.det_stats, js.phys_params, js.phys_stats,
                  js.disc_params]
    n_jax = sum(np.size(x) for t in jax_leaves for x in jax.tree.leaves(t))
    n_port = sum(v.numel() for m in (pspec.detector, pspec.physique,
                                     pspec.discriminator) if m is not None
                 for k, v in m.state_dict().items()
                 if "num_batches" not in k)
    assert n_jax == n_port
    n_moments = sum(v.size for k, v in arrays.items()
                    if k.startswith(("mu/", "nu/")))
    assert n_moments == 2 * sum(p.numel() for p in state.gen_params
                                + state.disc_params)
    assert (pspec.physique is None) == ("no_physique" in flags)
    assert (pspec.discriminator is None) == ("no_discriminator" in flags)


def test_a_leaf_left_over_raises():
    cfg = _flagship_config(tiny=True)
    ds = SyntheticPoseDataset(num_samples=BATCH, cam_id_list=(0, 1),
                              patch_size=64)
    spec, opt_det, opt_disc, batch = _init(cfg, ds.device_batch(0, BATCH))
    shapes = jax.eval_shape(lambda k: init_train_state(
        spec, k, batch, opt_det, opt_disc), jax.random.PRNGKey(0))
    js = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    raw = raw_train_state(js)
    raw["det_stats"]["net"]["extra"] = {"mean": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="map to no tensor"):
        train_state_arrays_from_jax(raw)
