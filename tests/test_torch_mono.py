"""The port's mono / 2D training path against the JAX package's, on the CPU:
the TikTok dataset and its helpers (x_as_supervision_tpu_torch/data/
dataloader_2d.py) on an on-disk fixture in the dataset's layout
(checks.write_mini_tiktok), SyntheticMonoDataset, and the composed model's
mono branch (models/composed.py) on the tiny flagship config with one
``mono`` camera at 64^2, fp32 (the generator gradients in float64).

The datasets read the same files with the same numpy and cv2 calls, so
they are held exactly. The JAX package's TikTok holder of the pseudo stream
lacks ``uint8_feed`` (its first sample raises AttributeError); the tests
set it to False on the JAX instance, the fp32 feed the port's holder sets.

The model: gradients of the generator loss (in float64 on both sides, see
test_mono_generator_gradients_match_jax) and of the discriminator loss at
one state, and a 3-step fused trajectory with outputs, each step from the JAX
state carried into the port (as tests/test_torch_train.py, with its
tolerances), from flax-initialized weights with each residual branch's last
BatchNorm scale at 0.1 (_conditioned); the discriminator header's dropout
is off on both sides.
"""

import copy
import os
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_init_state
from torch_parity import few_torch_threads  # noqa: F401 (autouse)
from torch_ties import assert_held  # noqa: E402

cv2 = pytest.importorskip("cv2")

from __graft_entry__ import _flagship_config  # noqa: E402
from torch_parity import (  # noqa: E402
    assert_step_matches,
    carry_train_state,
    jax_state_in_port_names,
    to_numpy_tree,
)
from x_as_supervision_tpu.data import dataloader_2d as JD  # noqa: E402
from x_as_supervision_tpu.data.synthetic import (  # noqa: E402
    SyntheticMonoDataset as JaxMono,
)
from x_as_supervision_tpu.models.composed import (  # noqa: E402
    discriminator_forward as jax_disc_forward,
)
from x_as_supervision_tpu.models.composed import (  # noqa: E402
    generator_forward as jax_gen_forward,
)
from x_as_supervision_tpu.train.factory import (  # noqa: E402
    build_gan_spec as jax_spec,
)
from x_as_supervision_tpu.tools.convert_torch_resnet import (  # noqa: E402
    convert_full_detector,
)
from x_as_supervision_tpu.train.state import (  # noqa: E402
    make_optimizers,
    make_train_step,
)
from x_as_supervision_tpu_torch import checks, weights  # noqa: E402
from x_as_supervision_tpu_torch.data import dataloader_2d as PD  # noqa: E402
from x_as_supervision_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticMonoDataset as PortMono,
)
from x_as_supervision_tpu_torch.models.composed import (  # noqa: E402
    discriminator_forward,
    generator_forward,
)
from x_as_supervision_tpu_torch.train.factory import (  # noqa: E402
    build_gan_spec,
    flagship_config,
)
from x_as_supervision_tpu_torch.train.state import (  # noqa: E402
    TrainState,
    train_step,
)
from x_as_supervision_tpu_torch.train.trainer import to_device  # noqa: E402

FRAMES = 44  # 4 samples a video after the 20 / 20 trim
FRAME_HW = (150, 90)
GEODESIC = [2, 1, 3, 20, 0.0]
# 4 images a BatchNorm statistic, as the tiny flagship's 2 cameras x 2:
# a random-weight train-mode ResNet at 2 is chaotic (scripts/
# parity_sensitivity.py)
BATCH = 4
STEPS = 3
STEPS_PER_EPOCH = 10
LR = 1e-4


# ------------------------------------------------------------------ data


@pytest.fixture(scope="module")
def tiktok(tmp_path_factory):
    """One training and one validation video, and a pseudo stream."""
    root = str(tmp_path_factory.mktemp("tiktok"))
    data = checks.write_mini_tiktok(
        root, n_frames=FRAMES, size_hw=FRAME_HW, seed=3,
        videos=(PD.TIKTOK_TRAIN_VIDEOS[0], PD.TIKTOK_VALID_VIDEOS[0]))
    pseudo = checks.write_surreal_pseudo(
        os.path.join(root, "surreal_h36m_pose"), 6, seed=4, size=64)
    return data, {"use_flag": True, "use_mask": True, "data_path": pseudo}


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, str):
        assert a == b, where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where


def test_video_lists_match_the_jax_package():
    assert PD.TIKTOK_TRAIN_VIDEOS == JD.TIKTOK_TRAIN_VIDEOS
    assert PD.TIKTOK_VALID_VIDEOS == JD.TIKTOK_VALID_VIDEOS


def test_center_padding_matches_jax():
    img = np.random.default_rng(0).integers(0, 255, (9, 4, 3), np.uint8)
    _same(PD.center_padding(img), JD.center_padding(img))
    with pytest.raises(AssertionError):
        PD.center_padding(img.transpose(1, 0, 2))


@pytest.mark.parametrize("mask_center", [True, False])
def test_generate_mono_item_matches_jax(tiktok, mask_center):
    """Square-padded and cropped around the mask (TikTok), or cropped to a
    given box unpadded (MPII)."""
    frame = os.path.join(tiktok[0], f"{PD.TIKTOK_TRAIN_VIDEOS[0]:05d}",
                         "images", "00021.png")
    smp = {"image": frame, "mask": frame.replace("images", "masks"),
           "center_x": 40.0, "center_y": 70.0, "width": 60.0,
           "height": 60.0}
    kw = dict(ct_padding=mask_center, use_mask_center=mask_center,
              patch_size=64)
    _same(PD.generate_mono_item(smp, **kw), JD.generate_mono_item(smp, **kw))


def _outcome(seed: int) -> str:
    """What data_color_aug does with the rng of `seed`."""
    rng = np.random.default_rng(seed)
    if rng.random() < 0.4:
        return "none"
    return ("jitter", "equalize", "blur", "invert")[rng.integers(0, 4)]


def _seed_for(outcome: str) -> int:
    return next(s for s in range(1000) if _outcome(s) == outcome)


@pytest.mark.parametrize("outcome",
                         ["none", "jitter", "equalize", "blur", "invert"])
def test_data_color_aug_matches_jax(outcome):
    seed = _seed_for(outcome)
    img = np.random.default_rng(9).uniform(0, 1, (32, 32, 3)).astype(
        np.float32)
    got = PD.data_color_aug(img, np.random.default_rng(seed))
    want = JD.data_color_aug(img, np.random.default_rng(seed))
    _same(got, want)
    assert (got is img) == (outcome == "none")


def _tiktok_pair(tiktok, mode: str, pseudo: bool):
    data, stream = tiktok
    args = (data, GEODESIC, stream if pseudo else None,
            {"mean": None, "std": None})
    want = JD.TikTok_dataset(*args, mode=mode, rect_3d_width=256, seed=5)
    got = PD.TikTok_dataset(*args, mode=mode, rect_3d_width=256, seed=5)
    if pseudo:
        # the JAX holder lacks the attribute (see the module docstring)
        want._pseudo_holder.uint8_feed = False
    return want, got


@pytest.mark.parametrize("pseudo", [True, False])
@pytest.mark.parametrize("mode", ["train", "valid"])
def test_tiktok_samples_match_jax(tiktok, mode, pseudo):
    want, got = _tiktok_pair(tiktok, mode, pseudo)
    assert len(got) == len(want) == FRAMES - 40
    for i in range(len(got)):
        w, g = want.sample(i), got.sample(i)
        # the frame numbers [20:-20] of the right video
        name = os.path.basename(g["cam_mono_img_path"])
        assert 20 <= int(name[:5]) < FRAMES - 20
        # the pseudo stream in either mode, as the JAX package draws it
        assert ("cam_mono_pseudo_img" in g) == pseudo
        _same(w, g, f"{mode}[{i}]")


def test_tiktok_batches_match_jax(tiktok):
    want, got = _tiktok_pair(tiktok, "train", True)
    _same(want.batch(1, 3), got.batch(1, 3))
    _same(want.device_batch(0, 4), got.device_batch(0, 4))
    _same(want.batch_from_indices([3, 0]), got.batch_from_indices([3, 0]))


def test_the_port_trains_the_shipped_pseudo_stream(tiktok):
    """TikTok_Multi_S1's pseudo stream: the JAX package's holder has no
    uint8_feed, so its first sample raises (a fault of the reference); the
    port's takes the fp32 feed."""
    data, stream = tiktok
    args = (data, GEODESIC, stream, {"mean": None, "std": None})
    with pytest.raises(AttributeError, match="uint8_feed"):
        JD.TikTok_dataset(*args, mode="train").sample(0)
    out = PD.TikTok_dataset(*args, mode="train").sample(0)
    assert out["cam_mono_pseudo_img"].dtype == np.float32
    assert out["cam_mono_pseudo_joints"].shape == (18, 3)


def test_synthetic_mono_matches_jax():
    for pseudo in (True, False):
        want = JaxMono(num_samples=5, patch_size=32, seed=3,
                       with_pseudo=pseudo)
        got = PortMono(num_samples=5, patch_size=32, seed=3,
                       with_pseudo=pseudo)
        assert len(got) == len(want)
        _same(want.batch(2, 4), got.batch(2, 4))
        _same(want.device_batch(0, 2), got.device_batch(0, 2))
        _same(want.batch_from_indices([4, 1]), got.batch_from_indices([4, 1]))


# ----------------------------------------------------------------- model


def _mono(cfg: dict) -> dict:
    """The config with one mono camera (symmetry stays configured: the mono
    branch leaves it out)."""
    cfg = copy.deepcopy(cfg)
    cfg["model_params"]["cam_id_list"] = ["mono"]
    cfg["dataset_params"]["cam_id_list"] = ["mono"]
    assert "symmetry_loss" in cfg["model_params"]["loss_config"]
    return cfg


def _port_spec(dtype=torch.float32):
    pspec = build_gan_spec(_mono(flagship_config(tiny=True)), dtype)
    pspec.discriminator.header.p_dropout = 0.0
    return pspec


def _fp64(tree):
    """A numpy tree with its float32 leaves in float64."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.asarray(a).dtype == np.float32 else np.asarray(a), tree)


def _physique_off_the_kink(js):
    """`js` with each physique BatchNorm's scale at 0.05 and its bias at +1
    and -1 on alternate channels: every leaky-ReLU input of the physique
    net then lies well off the kink (half the channels on each slope),
    where the unconditioned state has one 1e-6 from it, which a 1e-6
    change anywhere upstream moves across (scripts/
    mono_gradient_rounding.py)."""
    params = dict(js.phys_params)
    for name, p in params.items():
        if name.startswith("_BN_"):
            c = p["BatchNorm_0"]["scale"].shape[0]
            params[name] = {"BatchNorm_0": {
                "scale": jnp.full((c,), 0.05, jnp.float32),
                "bias": jnp.asarray(np.where(np.arange(c) % 2, -1.0, 1.0),
                                    jnp.float32)}}
    return js.replace(phys_params=params)


def _generator_grads_fp64(cfg: dict, js, batch: dict):
    """d(sum of the generator losses) in float64 on both sides from the
    state `js` on `batch`: JAX under jax.enable_x64 with its spec's dtype
    float64, the port's spec in float64. Returns (JAX's, the port's), each
    keyed as the port's (gen, name) and (disc, name), and the port's
    leaky-ReLU input nearest the kink in the physique net."""
    with jax.enable_x64(True):
        spec = jax_spec(cfg, dtype=jnp.float64)
        det_stats, phys_stats, jbatch = (
            jax.tree_util.tree_map(jnp.asarray, _fp64(t))
            for t in (js.det_stats, js.phys_stats, batch))

        def gen_loss(gen_params, disc_params):
            losses, _, _, _ = jax_gen_forward(
                spec, {"params": gen_params["detector"],
                       "batch_stats": det_stats},
                {"params": gen_params["physique"],
                 "batch_stats": phys_stats},
                disc_params, jbatch, jax.random.PRNGKey(1), train=True)
            return sum(jnp.mean(v) for v in losses.values())

        params = jax.tree_util.tree_map(jnp.asarray, _fp64(
            ({"detector": js.det_params, "physique": js.phys_params},
             js.disc_params)))
        jg_gen, jg_disc = to_numpy_tree(
            jax.jit(jax.grad(gen_loss, argnums=(0, 1)))(*params))
    assert all(a.dtype == np.float64 for a in
               jax.tree_util.tree_leaves((jg_gen, jg_disc)))
    want = _port_names(jg_gen, jg_disc, js)

    pspec = _port_spec(torch.float64)
    state = TrainState(pspec, cfg["train_params"], STEPS_PER_EPOCH)
    carry_train_state(pspec, state, js)
    for module in (pspec.detector, pspec.physique, pspec.discriminator):
        module.double()
    tbatch = {k: v.double() if v.is_floating_point() else v
              for k, v in to_device(batch, "cpu").items()}
    near = []
    hooks = [bn.register_forward_hook(
        lambda m, i, o: near.append(float(o.detach().abs().min())))
        for bn in pspec.physique.bns]
    losses, _ = generator_forward(pspec, tbatch)
    for h in hooks:
        h.remove()
    grads = torch.autograd.grad(sum(v.mean() for v in losses.values()),
                                state.gen_params + state.disc_params,
                                allow_unused=True)
    names = ([("gen", n) for n in state.gen_names]
             + [("disc", n) for n in state.disc_names])
    return want, dict(zip(names, grads)), min(near)


@pytest.fixture(scope="module")
def mono_model(tmp_path_factory):
    cfg = _mono(_flagship_config(tiny=True))
    ds = JaxMono(num_samples=BATCH * STEPS, patch_size=64, seed=0)
    batches = [ds.device_batch(i * BATCH, BATCH) for i in range(STEPS)]
    spec = jax_spec(cfg)
    opt_det, opt_disc = make_optimizers(cfg["train_params"], STEPS_PER_EPOCH)
    js = _conditioned(jax_init_state(tmp_path_factory, cfg, batches[0],
                                     opt_det, opt_disc, STEPS_PER_EPOCH,
                                     jit=True))
    step = make_train_step(spec, opt_det, opt_disc)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batches[0])
    jkeys: list = []

    def gen_losses(gen_params, disc_params, jbatch):
        losses, outputs, _, _ = jax_gen_forward(
            spec, {"params": gen_params["detector"],
                   "batch_stats": js.det_stats},
            {"params": gen_params["physique"], "batch_stats": js.phys_stats},
            disc_params, jbatch, jax.random.PRNGKey(1), train=True)
        jkeys[:] = sorted(outputs)
        return {k: jnp.mean(v) for k, v in losses.items()}

    def disc_loss(disc_params):
        loss, outputs, _ = jax_disc_forward(
            spec, disc_params, {"params": js.det_params,
                                "batch_stats": js.det_stats},
            jbatch, jax.random.PRNGKey(2), train=True)
        return loss

    pspec = _port_spec()
    state = TrainState(pspec, cfg["train_params"], STEPS_PER_EPOCH)
    carry_train_state(pspec, state, js)
    tbatch = to_device(batches[0], "cpu")
    gen_out: dict = {}
    losses, _ = generator_forward(pspec, tbatch, outputs=gen_out)
    loss_disc = discriminator_forward(pspec, tbatch)
    # the same losses in float64 from the same state: the exact value
    # against which each side's float32 rounding is measured
    pspec64 = _port_spec(torch.float64)
    carry_train_state(pspec64, TrainState(pspec64, cfg["train_params"],
                                          STEPS_PER_EPOCH), js)
    for module in (pspec64.detector, pspec64.physique,
                   pspec64.discriminator):
        module.double()
    with torch.no_grad():
        exact_losses, _ = generator_forward(pspec64, {
            k: v.double() if v.is_floating_point() else v
            for k, v in tbatch.items()})
    grads_dd = torch.autograd.grad(loss_disc, state.disc_params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        gen_params = {"detector": js.det_params, "physique": js.phys_params}
        jlosses = jax.jit(gen_losses)(gen_params, js.disc_params, jbatch)
        want_g, got_g, kink_margin = _generator_grads_fp64(
            cfg, _physique_off_the_kink(js), batches[0])
        jloss_disc, jg_dd = jax.jit(jax.value_and_grad(disc_loss))(
            js.disc_params)

        traj = []
        for i, batch in enumerate(batches):
            before = jax_state_in_port_names(js)
            carry_train_state(pspec, state, js)
            js, jmetrics, jouts = step(js, batch, jax.random.PRNGKey(i),
                                       do_disc=True, do_gen=True,
                                       with_outputs=True)
            metrics, outs = train_step(state, to_device(batch, "cpu"),
                                       with_outputs=True)
            got = {}
            for prefix in ("detector", "physique", "discriminator"):
                got.update({f"{prefix}.{k}": v.detach().clone() for k, v in
                            getattr(pspec, prefix).state_dict().items()
                            if "num_batches" not in k})
            traj.append(dict(
                before=before,
                want_metrics={k: float(v) for k, v in jmetrics.items()},
                metrics=metrics,
                want=jax_state_in_port_names(js), got=got,
                want_pending=weights.discriminator_state_dict(
                    to_numpy_tree(js.pending_disc_grads)),
                pending=dict(zip(state.disc_names,
                                 state.pending_disc_grads)),
                jouts={k: np.asarray(v) for k, v in jouts.items()},
                outs={k: v.numpy() for k, v in outs.items()}))
    return dict(
        losses=losses, jlosses={k: float(v) for k, v in jlosses.items()},
        exact_losses={k: float(v) for k, v in exact_losses.items()},
        gen_keys=sorted(gen_out), jgen_keys=jkeys,
        got_grads=got_g, want_grads=want_g, kink_margin=kink_margin,
        loss_disc=float(loss_disc.detach()), jloss_disc=float(jloss_disc),
        got_dd=dict(zip(state.disc_names, grads_dd)),
        want_dd=weights.discriminator_state_dict(to_numpy_tree(jg_dd)),
        cancelled={"physique." + n
                   for n in pspec.physique.bn_cancelled_biases()},
        traj=traj, pspec=pspec)


def _conditioned(js):
    """`js` with each residual branch's last BatchNorm scale at 0.1, as
    chip_smoke.py conditions its card-vs-CPU steps: a flax-initialized
    ResNet in train mode at 64^2 is chaotic enough that fp32 rounding moves
    single gradient tensors by percents (measured here: a sum of the bare
    detector's keypoints, the same weights and images, JAX against the
    port, 1e-2 of a head tensor's largest entry); damped branches make it
    near-linear."""
    sd = {k: v.numpy().copy() for k, v in weights.state_dict_from_variables(
        {"params": to_numpy_tree(js.det_params),
         "batch_stats": to_numpy_tree(js.det_stats)}).items()}
    for k in sd:
        if re.fullmatch(r"net\.backbone\.layer\d\.\d+\.bn2\.weight", k):
            sd[k][:] = 0.1
    params, _ = convert_full_detector(sd, 18)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(js.det_params))
    return js.replace(det_params=params)


def _port_names(jg_gen, jg_disc, js) -> dict:
    """JAX gradients keyed as the port's (gen, name) and (disc, name)."""
    sd = {"detector." + k: v for k, v in weights.state_dict_from_variables(
        {"params": to_numpy_tree(jg_gen["detector"]),
         "batch_stats": to_numpy_tree(js.det_stats)}).items()}
    sd.update({"physique." + k: v for k, v in weights.physique_state_dict(
        {"params": to_numpy_tree(jg_gen["physique"]),
         "batch_stats": to_numpy_tree(js.phys_stats)}).items()})
    out = {("gen", k): v for k, v in sd.items()}
    out.update({("disc", k): v for k, v in weights.discriminator_state_dict(
        to_numpy_tree(jg_disc)).items()})
    return out


def test_mono_generator_losses_match_jax(mono_model):
    got, want = mono_model["losses"], mono_model["jlosses"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        # fp32, the same weights and batch, summed in other orders (the
        # physique loss against the port's float64 where its own float32
        # rounding takes more than half of that: the physique net's
        # near-constant channels, tests/torch_ties.py:assert_held)
        assert_held(float(got[k].detach()), w, mono_model["exact_losses"][k],
                    rtol=2e-5, atol=0.0, err_msg=k)
    np.testing.assert_allclose(mono_model["loss_disc"],
                               mono_model["jloss_disc"], rtol=1e-5)


def test_mono_symmetry_is_a_zero_tensor(mono_model):
    """Symmetry configured, one mono camera: JAX's 0.0 (a sum over no
    camera), the port's a zero tensor on the step's device, which the
    trainer's one packed fetch stacks."""
    sym = mono_model["losses"]["symmetry"]
    assert torch.is_tensor(sym) and sym.shape == () and float(sym) == 0.0
    assert mono_model["jlosses"]["symmetry"] == 0.0
    for step in mono_model["traj"]:
        assert step["want_metrics"]["loss/symmetry"] == 0.0
        assert float(step["metrics"]["loss/symmetry"]) == 0.0


def test_mono_outputs_have_jax_keys_and_no_gt_world(mono_model):
    assert mono_model["gen_keys"] == mono_model["jgen_keys"]
    assert "kp_gt_world" not in mono_model["gen_keys"]
    assert "pose_3d_depth_cam_mono" in mono_model["gen_keys"]
    for step in mono_model["traj"]:
        assert sorted(step["outs"]) == sorted(step["jouts"])
        assert "kp_gt_world" not in step["outs"]


@pytest.mark.parametrize("part", ["detector", "physique", "discriminator"])
def test_mono_generator_gradients_match_jax(mono_model, part):
    """In float64 on both sides (_generator_grads_fp64), with the physique
    net off its leaky-ReLU kinks (_physique_off_the_kink). At the
    unconditioned state the float32 gradients part by up to 6e-2 of a
    physique kernel's largest entry: the rendered masks are mostly
    background, so each physique channel is near constant after its
    BatchNorm, one leaky-ReLU input lies 1e-6 from the kink, on whichever
    side each package's rounding puts it, and conditioned channels leave
    the weight gradients small sums of large cancelling terms, which
    float32 cannot hold at 1e-4 (scripts/mono_gradient_rounding.py)."""
    assert mono_model["kink_margin"] > 1e-3
    want, got = mono_model["want_grads"], mono_model["got_grads"]
    side = "disc" if part == "discriminator" else "gen"
    prefix = "" if part == "discriminator" else part + "."
    keys = [k for k in want if k[0] == side and k[1].startswith(prefix)
            and "running" not in k[1] and "num_batches" not in k[1]]
    assert keys
    for key in keys:
        w = want[key].numpy()
        g = got[key]
        g = np.zeros_like(w) if g is None else g.numpy()
        if side == "gen" and key[1] in mono_model["cancelled"]:
            # a train-mode BN cancels these biases: zero up to rounding
            scale = max(float(np.abs(want[k].numpy()).max()) for k in want
                        if k[1].startswith("physique."))
            assert np.abs(g).max() <= 1e-5 * scale, key
            continue
        # test_torch_gan.py's bound; the JAX package keeps some float32
        # inside (its input feed, the decode's interpret-mode kernel), so
        # not float64's. The discriminator's gradient of the generator
        # loss is that of the detached smpl_gen term.
        tol = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=tol,
                                   err_msg=str(key))


def test_mono_discriminator_gradients_match_jax(mono_model):
    for k, w in mono_model["want_dd"].items():
        w = w.numpy()
        np.testing.assert_allclose(
            mono_model["got_dd"][k].numpy(), w, rtol=1e-4,
            atol=1e-5 * float(np.abs(w).max()), err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_mono_trajectory_losses_match_jax(mono_model, i):
    step = mono_model["traj"][i]
    want = step["want_metrics"]
    got = {k: float(v) for k, v in step["metrics"].items()}
    assert sorted(got) == sorted(want)
    for k in want:
        if want[k] == 0.0:
            assert got[k] == 0.0, k
            continue
        # test_torch_train.py's bound
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_mono_trajectory_parameters_match_jax(mono_model, i):
    step = mono_model["traj"][i]
    assert_step_matches(step["want"], step["got"], step["before"],
                        mono_model["pspec"], LR)
    want, got = step["want_pending"], step["pending"]
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    assert scale > 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5 * scale, err_msg=k)
