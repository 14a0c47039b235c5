"""The port's rematerialization modes (``model_params.remat``;
models/composed.py, models/detector.py, models/remat.py) on the CPU, on the
tiny flagship config in fp32:

  (a) the mode mapping is the JAX package's composed._remat_mode, an
      absent key ``full``;
  (b) one fused train step in each mode equals the ``none`` step from the
      same weights and batch, bitwise: losses, every gradient, the carried
      discriminator gradient, the parameters after Adam and every
      BatchNorm's running statistics and num_batches_tracked (a recompute
      that folded its batch statistics in again would move them twice);
      and the fused link's Bottleneck (ResNet-50's, which the tiny
      config's ResNet-18 has none of) under a checkpoint region against
      the plain forward, pooled and per camera;
  (c) the regions are real: the bytes the generator forward saves for its
      backward fall from ``none`` to ``pseudo`` to ``full``, and under
      ``head_decode`` no saved tensor has the K*D-channel logits' shape;
  (d) the ``head_decode`` step against the JAX package's step in the same
      mode, from the same carried train state (the mode whose stage split
      could misname parameters); ``full`` is held to JAX by
      tests/test_torch_train.py, whose tiny config remats on both sides;
  (e) two gloo ranks under ``full`` against one process (the recompute's
      all-reduces run inside the backward: a rank that ordered them
      otherwise would hang, hence the spawn's timeout).
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from torch_dp import spawn
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu_torch.models import composed
from x_as_supervision_tpu_torch.models import resnet as R
from x_as_supervision_tpu_torch.models.remat import checkpoint
from x_as_supervision_tpu_torch.train import state as S
from x_as_supervision_tpu_torch.train.factory import (
    build_gan_spec,
    flagship_config,
)
from x_as_supervision_tpu_torch.train.trainer import step_generator, to_device
from torch_parity import jax_init_state
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

MODES = ("none", "full", "pseudo", "head_decode", "decode")
BATCH = 2
SEED = 3
STEPS_PER_EPOCH = 10
LR = 1e-4


def _config(mode):
    cfg = flagship_config(tiny=True)
    cfg["model_params"]["remat"] = mode
    return cfg


def _batch(start=0):
    ds = SyntheticPoseDataset(num_samples=4 * BATCH, cam_id_list=(0, 1),
                              patch_size=64)
    return ds.device_batch(start, BATCH)


def _gan(mode):
    cfg = _config(mode)
    spec = build_gan_spec(cfg, torch.float32)
    for i, m in enumerate((spec.detector, spec.physique,
                           spec.discriminator)):
        weights.init_weights(m, SEED + i)
    return spec, S.TrainState(spec, cfg["train_params"], STEPS_PER_EPOCH)


# ------------------------------------------------------------ (a) mapping

def test_mode_mapping_is_the_jax_packages():
    from x_as_supervision_tpu.models import composed as J

    for value in (True, False, None) + MODES:
        assert composed._remat_mode(value) == J._remat_mode(value), value
    for bad in ("ful", "True", "checkpoint"):
        with pytest.raises(ValueError):
            J._remat_mode(bad)
        with pytest.raises(ValueError):
            composed._remat_mode(bad)
    mp = flagship_config(tiny=True)["model_params"]
    del mp["remat"]
    want = J.GanSpec.from_config(mp, None, None, None).remat_mode
    got = composed.GanSpec.from_config(mp, None, None, None).remat_mode
    assert got == want == "full"


def test_factory_reads_the_key():
    """The tiny config asks for full; an absent key is full; decode alone
    sets the detector's remat_decode."""
    assert build_gan_spec(flagship_config(tiny=True)).remat_mode == "full"
    assert flagship_config()["model_params"]["remat"] is False
    cfg = flagship_config(tiny=True)
    del cfg["model_params"]["remat"]
    spec = build_gan_spec(cfg)
    assert spec.remat_mode == "full" and not spec.detector.remat_decode
    for mode in MODES:
        spec = build_gan_spec(_config(mode))
        assert spec.remat_mode == mode
        assert spec.detector.remat_decode == (mode == "decode")
    with pytest.raises(ValueError):
        build_gan_spec(_config("everything"))


# the launches a flagship step (4 x 32, bf16) makes by mode, as the card
# counts them (chip_smoke.py phase 17): decode forward, decode backward,
# link, conv3x3
FLAGSHIP_LAUNCHES = {"none": (2, 2, 14, 18), "full": (4, 2, 28, 18),
                     "pseudo": (3, 2, 21, 18), "head_decode": (4, 2, 14, 18),
                     "decode": (4, 2, 14, 18)}


@pytest.mark.parametrize("mode", MODES)
def test_launch_reckoning(mode):
    """checks.train_launches, which chip_smoke.py holds every train phase
    to: the flagship step in each mode, per camera (one link launch a
    camera slice), and the key absent (the shipped configs): full's."""
    from x_as_supervision_tpu_torch.checks import train_launches

    names = ("integral_marginals", "integral_marginals_bwd", "conv_bn_link",
             "conv3x3")
    launches, paths = train_launches(flagship_config(), mode)
    assert launches == dict(zip(names, FLAGSHIP_LAUNCHES[mode]))
    assert paths == {"conv_bn_link": {"launches_wgmma": launches[
                         "conv_bn_link"], "launches_fma": 0},
                     "conv3x3": {"launches_tc": 14, "launches_thin": 4,
                                 "launches_cuda_core": 0}}
    percam = flagship_config()
    percam["model_params"]["per_camera_bn"] = True
    assert (train_launches(percam, mode)[0]["conv_bn_link"]
            == 4 * FLAGSHIP_LAUNCHES[mode][2])
    del percam["model_params"]["remat"]
    assert train_launches(percam)[0]["conv_bn_link"] == 4 * 28


# ------------------------------------------------------- (b) each mode

def _step(mode):
    """One fused step of `mode`: metrics, the gradients Adam took, the
    carried discriminator gradient and every module tensor after it."""
    spec, state = _gan(mode)
    applied = []
    real_apply = S._apply

    def record(opt, params, grads, lr):
        applied.append([g.detach().clone() for g in grads])
        real_apply(opt, params, grads, lr)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "_apply", record)
        metrics = S.train_step(state, to_device(_batch(), "cpu"),
                               step_generator(SEED, 0, "cpu"))
    after = {}
    for name in ("detector", "physique", "discriminator"):
        after.update({f"{name}.{k}": v.detach().clone() for k, v in
                      getattr(spec, name).state_dict().items()})
    names = ([f"disc_grad.{n}" for n in state.disc_names]
             + [f"gen_grad.{n}" for n in state.gen_names])
    grads = dict(zip(names, applied[0] + applied[1]))
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads=grads, after=after,
                pending=dict(zip(state.disc_names,
                                 state.pending_disc_grads)))


@pytest.fixture(scope="module")
def reference():
    return _step("none")


@pytest.mark.parametrize("mode", MODES[1:])
def test_mode_step_equals_none(reference, mode):
    got = _step(mode)
    assert got["metrics"] == reference["metrics"]
    for part in ("grads", "pending", "after"):
        assert sorted(got[part]) == sorted(reference[part])
        for k, want in reference[part].items():
            # the same ops on the same values in the same order: bitwise
            assert torch.equal(got[part][k], want), (part, k)
    # every detector BatchNorm moved once a forward: two (cameras, pseudo)
    tracked = {k: int(v) for k, v in got["after"].items()
               if k.startswith("detector.") and "num_batches" in k}
    assert tracked and set(tracked.values()) == {2}


@pytest.mark.parametrize("groups", [1, 2])
def test_link_bottleneck_under_checkpoint(groups):
    """ResNet-50's fused Bottleneck (the link: fold_batch_stats, the link,
    apply_stats) in a checkpoint region against its plain train forward:
    output, input and parameter gradients bitwise, running statistics
    moved once."""
    torch.manual_seed(0)
    plain = R.Bottleneck(1024, 256).train()
    with torch.no_grad():
        for bn in (plain.bn1, plain.bn2, plain.bn3):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
    R.set_bn_groups(plain, groups)
    assert plain.fused_link
    remat = copy.deepcopy(plain)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 1024, 4, 4, generator=gen) * 2.0 + 0.5
    wgt = torch.randn(4, 1024, 4, 4, generator=gen)

    def run(block, fn):
        xi = x.clone().requires_grad_()
        y = fn(xi)
        grads = torch.autograd.grad((y * wgt).sum(),
                                    [xi] + list(block.parameters()))
        return y.detach(), grads

    want_y, want_g = run(plain, plain)
    got_y, got_g = run(remat, lambda t: checkpoint(remat, t))
    assert torch.equal(got_y, want_y)
    for g, w in zip(got_g, want_g):
        assert torch.equal(g, w)
    for (n, v), (_, w) in zip(remat.named_buffers(), plain.named_buffers()):
        assert torch.equal(v, w), n
    assert int(remat.bn1.num_batches_tracked) == groups


# ------------------------------------------------- (c) saved for backward

def _saved(mode):
    """(bytes, shapes) of what the generator forward saves for backward
    outside its checkpoint regions."""
    spec, _ = _gan(mode)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t.numel() * t.element_size()

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda n: None):
        composed.generator_forward(
            spec, composed.preprocess_batch(to_device(_batch(), "cpu"),
                                            spec),
            step_generator(SEED, 0, "cpu"))
    return shapes, spec


def _nbytes(shapes):
    return sum(int(np.prod(s)) * 4 for s in shapes)


def test_regions_save_less():
    saved = {m: _saved(m)[0] for m in ("none", "pseudo", "full")}
    none, pseudo, full = (_nbytes(saved[m]) for m in ("none", "pseudo",
                                                       "full"))
    assert full < pseudo < none, (full, pseudo, none)
    # the pseudo stream's forward is about half of the detector's share
    assert none - pseudo > 0.3 * (none - full)


def test_head_decode_keeps_no_logits():
    shapes, spec = _saved("head_decode")
    det = spec.detector
    logits = (2 * BATCH, det.num_kp * 8, 16, 16)  # (B, K*D, H, W), D = 8
    assert logits not in shapes
    none_shapes, _ = _saved("none")
    assert logits in none_shapes  # the decode saves them without a region
    assert _nbytes(shapes) < _nbytes(none_shapes)


# ---------------------------------------------- (d) head_decode against JAX

def test_head_decode_step_matches_jax(tmp_path_factory):
    import flax.linen as fnn
    import jax

    from torch_parity import (
        assert_step_matches,
        carry_train_state,
        jax_state_in_port_names,
    )
    from x_as_supervision_tpu.data.synthetic import (
        SyntheticPoseDataset as JaxDataset,
    )
    from x_as_supervision_tpu.train.factory import build_gan_spec as jspec
    from x_as_supervision_tpu.train.state import (
        make_optimizers,
        make_train_step,
    )

    cfg = _config("head_decode")
    batch = JaxDataset(num_samples=BATCH, cam_id_list=(0, 1),
                       patch_size=64).device_batch(0, BATCH)
    spec = jspec(cfg)
    assert spec.remat_mode == "head_decode"
    opt_det, opt_disc = make_optimizers(cfg["train_params"], STEPS_PER_EPOCH)
    js = jax_init_state(tmp_path_factory, cfg, batch, opt_det, opt_disc,
                        STEPS_PER_EPOCH, jit=True)
    pspec = build_gan_spec(cfg, torch.float32)
    pspec.discriminator.header.p_dropout = 0.0
    state = S.TrainState(pspec, cfg["train_params"], STEPS_PER_EPOCH)
    before = jax_state_in_port_names(js)
    carry_train_state(pspec, state, js)
    with pytest.MonkeyPatch.context() as mp:
        # the frameworks draw different bits: dropout off on both sides
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        js, jmetrics, _ = make_train_step(spec, opt_det, opt_disc)(
            js, batch, jax.random.PRNGKey(0), do_disc=True, do_gen=True,
            with_outputs=False)
    metrics = S.train_step(state, to_device(batch, "cpu"))
    assert sorted(metrics) == sorted(jmetrics)
    for k, w in jmetrics.items():
        # tests/test_torch_train.py's bound
        np.testing.assert_allclose(float(metrics[k]), float(w), rtol=1e-4,
                                   err_msg=k)
    got = {}
    for prefix in ("detector", "physique", "discriminator"):
        got.update({f"{prefix}.{k}": v.detach().clone() for k, v in
                    getattr(pspec, prefix).state_dict().items()
                    if "num_batches" not in k})
    assert_step_matches(jax_state_in_port_names(js), got, before, pspec, LR)


# ------------------------------------------------- (e) two ranks, full

def test_two_ranks_under_full_match_one_process(tmp_path):
    """tests/torch_dp.py's port_steps job (the one-process step and the
    data-parallel one from the same state, each rank on its half) on the
    tiny config under full with per-camera statistics, 2 steps of global
    batch 4."""
    cfg = _config("full")
    cfg["model_params"]["per_camera_bn"] = True
    workdir = str(tmp_path)
    ds = SyntheticPoseDataset(num_samples=8, cam_id_list=(0, 1),
                              patch_size=64)
    for i in range(2):
        np.savez(os.path.join(workdir, f"batch_{i}.npz"),
                 **ds.device_batch(i * 4, 4))
    with open(os.path.join(workdir, "plan.json"), "w") as f:
        json.dump({"configs": {"full": cfg}, "steps": 2, "seed": SEED,
                   "steps_per_epoch": STEPS_PER_EPOCH, "lr": LR}, f)
    try:
        ranks = spawn("port_steps", 2, workdir, timeout=240)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for i in range(2):
        want = ranks[0]["full"][i]["want_metrics"]
        for rank in ranks:
            step = rank["full"][i]
            assert step["want_metrics"] == want
            for k, w in want.items():
                # tests/test_torch_parallel_step.py's bound
                np.testing.assert_allclose(step["metrics"][k], w, rtol=1e-4,
                                           err_msg=k)
        assert ranks[0]["full"][i]["state_verdict"] is None, \
            ranks[0]["full"][i]["state_verdict"]
        a, b = (rank["full"][i]["digests"] for rank in ranks)
        assert len(a) > 100 and a == b
