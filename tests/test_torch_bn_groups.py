"""Per-camera BatchNorm in the port (models/resnet.py: BatchNorm2d groups,
set_bn_groups; model_params.per_camera_bn), the counterpart of the JAX
package's tests/test_bn_groups.py: the grouped module equals each camera
slice through the pooled one (values, gradients, and the running statistics
after G sequential momentum updates); the grouped Bottleneck runs the link
once per camera slice; the tiny detector (ResNet-18, 64^2, 2 cameras) and
the physique net grouped against the JAX package's grouped modules in train
mode; identical state_dict keys pooled and grouped; and the factory's
wiring. fp32.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from x_as_supervision_tpu.models.detector import KPDetector3DMulti
from x_as_supervision_tpu.models.physique import (
    PhysiqueMaskGenerator as JaxPhysique,
)
from x_as_supervision_tpu.models.resnet import Bottleneck as JaxBottleneck
from x_as_supervision_tpu.models.resnet import _BN as JaxBN
from x_as_supervision_tpu.train.factory import build_gan_spec as jax_spec
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.models import resnet as R
from x_as_supervision_tpu_torch.models.detector import build_detector
from x_as_supervision_tpu_torch.models.physique import PhysiqueMaskGenerator
from x_as_supervision_tpu_torch.train.factory import (
    build_gan_spec,
    flagship_config,
)
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

TINY = dict(name="resnet_multi", num_kp=4, depth_dim=8, num_hypo=2,
            neighbor_size=3, num_layers=18)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _groups(module):
    return {m.groups for m in module.modules()
            if isinstance(m, R.BatchNorm2d)}


def test_grouped_bn_equals_per_camera_pooled_bn_and_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 4, 4, 8)).astype(np.float32) * 2 + 0.5
    x[3:] = x[3:] * 3 - 1  # the second camera's statistics differ
    r = rng.normal(size=x.shape).astype(np.float32)
    bn = R.BatchNorm2d(8, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
        bn.running_mean.normal_()
        bn.running_var.uniform_(0.5, 2.0)
    pooled, grouped = copy.deepcopy(bn), copy.deepcopy(bn)
    R.set_bn_groups(grouped, 2)

    def run(mod, lo, hi):
        xt = _nchw(x[lo:hi]).requires_grad_(True)
        y = mod(xt)
        g = torch.autograd.grad((y * _nchw(r[lo:hi])).sum(),
                                [xt, mod.weight, mod.bias])
        return y.detach(), g

    y_g, g_g = run(grouped, 0, 6)
    y0, g0 = run(pooled, 0, 3)
    y1, g1 = run(pooled, 3, 6)
    # each camera's slice normalized by its own statistics, exactly as the
    # pooled module does it on that slice alone
    torch.testing.assert_close(y_g, torch.cat([y0, y1]), rtol=0, atol=0)
    torch.testing.assert_close(g_g[0], torch.cat([g0[0], g1[0]]), rtol=0,
                               atol=0)
    for a, b0, b1 in zip(g_g[1:], g0[1:], g1[1:]):
        torch.testing.assert_close(a, b0 + b1, rtol=1e-6, atol=1e-6)
    # running statistics: two sequential momentum updates in camera order
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(grouped, name),
                                   getattr(pooled, name), rtol=0, atol=0)

    # and JAX's grouped _BN on the same numbers
    variables = {
        "params": {"BatchNorm_0": {"scale": bn.weight.detach().numpy(),
                                   "bias": bn.bias.detach().numpy()}},
        "batch_stats": {"BatchNorm_0": {"mean": bn.running_mean.numpy(),
                                        "var": bn.running_var.numpy()}}}
    want, mut = JaxBN(groups=2).apply(variables, jnp.asarray(x), train=True,
                                      mutable=["batch_stats"])
    np.testing.assert_allclose(y_g.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(grouped.running_mean.numpy(), stats["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grouped.running_var.numpy(), stats["var"],
                               rtol=1e-5, atol=1e-6)
    # eval: the running statistics, whatever the groups
    grouped.eval(), pooled.eval()
    torch.testing.assert_close(grouped(_nchw(x)), pooled(_nchw(x)))


def test_groups_must_divide_the_batch():
    bn = R.BatchNorm2d(4).train()
    R.set_bn_groups(bn, 4)
    with pytest.raises(ValueError):
        bn(torch.randn(6, 4, 2, 2))


@pytest.fixture(scope="module")
def bottleneck_case():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 6, 6, 1024)).astype(np.float32)
    x[2:] = x[2:] * 2 + 0.3
    r = rng.normal(size=x.shape).astype(np.float32)
    variables = _np(JaxBottleneck(256).init(jax.random.PRNGKey(1),
                                            jnp.asarray(x), train=False))
    for i in range(3):
        p = variables["params"][f"_BN_{i}"]["BatchNorm_0"]
        s = variables["batch_stats"][f"_BN_{i}"]["BatchNorm_0"]
        c = p["scale"].shape[0]
        p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        p["bias"] = rng.normal(size=c).astype(np.float32) * 0.2
        s["mean"] = rng.normal(size=c).astype(np.float32) * 0.2
        s["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    block = JaxBottleneck(256, bn_groups=2)

    def loss(params, x_):
        y, mut = block.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             x_, train=True, mutable=["batch_stats"])
        return (y * r).sum(), (y, mut["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                           jnp.asarray(x))
    sd = {}
    for i in range(3):
        sd[f"conv{i + 1}.weight"] = weights._conv(
            variables["params"][f"Conv_{i}"]["kernel"])
        weights._bn(sd, f"bn{i + 1}", variables["params"][f"_BN_{i}"],
                    variables["batch_stats"][f"_BN_{i}"])
    want = dict(y=np.asarray(y), gx=np.asarray(gx), gp=_np(gp),
                stats=_np(stats))
    return x, r, sd, want


def test_grouped_bottleneck_launches_the_link_per_camera(bottleneck_case,
                                                        monkeypatch):
    x, r, sd, want = bottleneck_case
    block = R.Bottleneck(1024, 256).train()
    block.load_state_dict(sd)
    R.set_bn_groups(block, 2)
    assert block.fused_link
    calls = []
    real = R.fused_link
    monkeypatch.setattr(R, "fused_link",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    xt = _nchw(x).requires_grad_(True)
    y = block(xt)
    # one link per camera slice, each of the slice's 2 images
    assert calls == [torch.Size([2, 256, 6, 6])] * 2
    names = [n for n, _ in block.named_parameters()]
    grads = torch.autograd.grad((y * _nchw(r)).sum(),
                                [xt] + list(block.parameters()))
    # fp32, three convs and the per-camera batch reductions in other
    # orders (JAX runs its unfused grouped path)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               want["y"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grads[0].permute(0, 2, 3, 1).numpy(),
                               want["gx"], rtol=1e-3,
                               atol=1e-4 * np.abs(want["gx"]).max())
    for name, g in zip(names, grads[1:]):
        mod, leaf = name.split(".")
        i = int(mod[-1]) - 1
        if mod.startswith("conv"):
            w = want["gp"][f"Conv_{i}"]["kernel"].transpose(3, 2, 0, 1)
        else:
            w = want["gp"][f"_BN_{i}"]["BatchNorm_0"][
                {"weight": "scale", "bias": "bias"}[leaf]]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    got = block.state_dict()
    for i in range(3):
        s = want["stats"][f"_BN_{i}"]["BatchNorm_0"]
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            # two sequential updates; the link's bn2 folds the one-pass
            # variance of each camera's (sum, sumsq)
            np.testing.assert_allclose(got[f"bn{i + 1}.{ours}"].numpy(),
                                       s[theirs], rtol=1e-4, atol=1e-5,
                                       err_msg=f"bn{i + 1}.{ours}")


def _tiny_pair(groups: int):
    jdet = KPDetector3DMulti(num_kp=4, depth_dim=8, num_hypo=2,
                             neighbor_size=3, num_layers=18,
                             bn_groups=groups)
    variables = _np(KPDetector3DMulti(
        num_kp=4, depth_dim=8, num_hypo=2, neighbor_size=3,
        num_layers=18).init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), train=False))
    # residual branches scaled down (each BasicBlock's last BN scale 0.1):
    # a random ResNet-18 in train mode at 64^2 is otherwise chaotic
    for name, block in variables["params"]["net"]["backbone"].items():
        if name.startswith("BasicBlock_"):
            block["_BN_1"]["BatchNorm_0"]["scale"] = np.full_like(
                block["_BN_1"]["BatchNorm_0"]["scale"], 0.1)
    det = build_detector(dict(TINY, bn_groups=groups), train=True)
    det.load_state_dict(weights.state_dict_from_variables(variables))
    return jdet, variables, det


def test_tiny_detector_grouped_matches_jax_in_train_mode():
    jdet, variables, det = _tiny_pair(2)
    assert _groups(det) == {2}
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    imgs[2:] = imgs[2:] * 0.5 + 0.4  # camera 1 sees other statistics
    (want, mut) = jdet.apply(variables, jnp.asarray(imgs), train=True,
                             mutable=["batch_stats"], stage="features")
    got = det.net.head.features[:-1](det.net.backbone(_nchw(imgs)))
    # fp32 through 18 conditioned layers and the deconv head, every conv
    # summed in another order (measured 1.6e-5 on features up to 6.4)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)
    sd = det.state_dict()
    want_sd = weights.state_dict_from_variables(
        {"params": variables["params"],
         "batch_stats": _np(mut["batch_stats"])})
    worst = 0.0
    for k, v in want_sd.items():
        if "running" in k and not k.startswith("net.head.features.9"):
            worst = max(worst, float(np.abs(sd[k].numpy() - v.numpy()).max()
                                     / (np.abs(v.numpy()).max() + 1e-3)))
    # the running statistics after 2 sequential updates per BN
    assert worst <= 1e-4, worst
    # and grouped is not pooled: the pooled statistics move the features
    # (measured by 4.0)
    _, _, det_pooled = _tiny_pair(1)
    pooled = det_pooled.net.head.features[:-1](
        det_pooled.net.backbone(_nchw(imgs)))
    assert (pooled - got).abs().max() > 100 * 1e-4


def test_tiny_detector_grouped_decode_matches_jax():
    jdet, variables, det = _tiny_pair(2)
    imgs = np.random.default_rng(2).uniform(0, 1, (4, 64, 64, 3)).astype(
        np.float32)
    (want, _) = jdet.apply(variables, jnp.asarray(imgs), train=True,
                           mutable=["batch_stats"])
    got = det(_nchw(imgs))
    # normalized coordinates in [-1, 1] (measured 1.7e-6)
    np.testing.assert_allclose(got.kps.detach().numpy(),
                               np.asarray(want.kps), rtol=0, atol=2e-5)


def test_physique_grouped_matches_jax():
    layers = (4, 8)
    rng = np.random.default_rng(3)
    x = np.exp(-rng.uniform(0, 8, (4, 16, 16, 1))).astype(np.float32)
    x[2:] = x[2:] ** 0.5
    r = rng.normal(size=x.shape).astype(np.float32)
    jnet = JaxPhysique(num_features=layers, bn_groups=2)
    variables = _np(JaxPhysique(num_features=layers).init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))

    def loss(params, x_):
        y, mut = jnet.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            x_, train=True, mutable=["batch_stats"])
        return (y * r).sum(), (y, mut["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                           jnp.asarray(x))
    net = PhysiqueMaskGenerator(layers, bn_groups=2).train()
    net.load_state_dict(weights.physique_state_dict(variables))
    assert _groups(net) == {2}
    xt = _nchw(x).requires_grad_(True)
    y = net(xt)
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad((y * _nchw(r)).sum(),
                                [xt] + list(net.parameters()))
    # fp32 through the convs and per-camera batch normalizations
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-5)
    gx = np.asarray(gx)
    np.testing.assert_allclose(grads[0].permute(0, 2, 3, 1).numpy(), gx,
                               rtol=1e-3, atol=1e-4 * np.abs(gx).max())
    want_sd = weights.physique_state_dict({"params": _np(gp),
                                           "batch_stats": _np(stats)})
    cancelled = set(net.bn_cancelled_biases())
    for n, g in zip(names, grads[1:]):
        w = want_sd[n].numpy()
        if n in cancelled:  # a train-mode BN follows: zero up to rounding
            assert np.abs(g.numpy()).max() <= 1e-4 * np.abs(gx).max(), n
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=n)
    sd = net.state_dict()
    for k, v in want_sd.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_state_dict_keys_identical_pooled_and_grouped():
    pooled = build_detector(TINY)
    grouped = build_detector(dict(TINY, bn_groups=2))
    assert list(pooled.state_dict()) == list(grouped.state_dict())
    grouped.load_state_dict(pooled.state_dict())  # checkpoints interchange
    assert (list(PhysiqueMaskGenerator((4, 8)).state_dict())
            == list(PhysiqueMaskGenerator((4, 8), bn_groups=4).state_dict()))


def test_per_camera_bn_factory_wiring():
    cfg = flagship_config(tiny=True)
    cfg["model_params"]["per_camera_bn"] = True
    spec = build_gan_spec(cfg)
    cams = len(cfg["model_params"]["cam_id_list"])
    assert _groups(spec.detector) == _groups(spec.physique) == {cams}
    # the JAX factory makes the same groups from the same config
    jcfg = _flagship_config(tiny=True)
    jcfg["model_params"]["per_camera_bn"] = True
    jspec = jax_spec(jcfg)
    assert jspec.detector.bn_groups == jspec.physique.bn_groups == cams
    assert _groups(build_gan_spec(flagship_config(tiny=True)).detector) == {1}
    # an explicit detector_params.bn_groups without per_camera_bn stays, as
    # the JAX factory keeps it (the physique net pools)
    cfg = flagship_config(tiny=True)
    cfg["model_params"]["detector_params"]["bn_groups"] = 2
    spec = build_gan_spec(cfg)
    assert _groups(spec.detector) == {2} and _groups(spec.physique) == {1}
    jcfg = _flagship_config(tiny=True)
    jcfg["model_params"]["detector_params"]["bn_groups"] = 2
    jspec = jax_spec(jcfg)
    assert (jspec.detector.bn_groups, jspec.physique.bn_groups) == (2, 1)
