"""The port's ResNet detector (x_as_supervision_tpu_torch/models,
weights.py) against the JAX package's, on the same weights.

Weights start as flax-initialized JAX variables, go through the port's
weights.py, are conditioned in the port (an untrained eval forward with fresh
BN statistics is chaotic) and go back through the JAX package's
convert_full_detector, so both packages run the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import conditioned_pair, nchw, to_numpy_tree
from x_as_supervision_tpu.models.detector import KPDetector3DMulti
from x_as_supervision_tpu.models.resnet import Bottleneck as JaxBottleneck
from x_as_supervision_tpu.models.resnet import ResPoseNet as JaxResPoseNet
from x_as_supervision_tpu.tools.convert_torch_resnet import (
    _flatten_into,
    convert_full_detector,
)
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.models import resnet as R
from x_as_supervision_tpu_torch.models.detector import build_detector
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

DET50 = dict(name="resnet_multi", num_kp=18, depth_dim=8, num_hypo=3,
             neighbor_size=3, num_layers=50)


def _jax_vars(det_params, size=64, seed=0):
    det = KPDetector3DMulti(
        num_kp=det_params["num_kp"], depth_dim=det_params["depth_dim"],
        num_hypo=det_params["num_hypo"],
        neighbor_size=det_params["neighbor_size"],
        num_layers=det_params["num_layers"],
    )
    return to_numpy_tree(det.init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, size, size, 3)), train=False))


@pytest.mark.parametrize("num_layers", [18, 50])
def test_state_dict_round_trips_to_the_jax_tree(num_layers):
    variables = _jax_vars(dict(DET50, num_layers=num_layers))
    sd = weights.state_dict_from_variables(variables)
    det = build_detector(dict(DET50, num_layers=num_layers))
    det.load_state_dict(sd)  # strict: every key present, shapes right
    params, stats = convert_full_detector(
        {k: v.numpy() for k, v in sd.items()}, num_layers)
    back = {"params": params, "batch_stats": stats}
    leaves, tree = jax.tree_util.tree_flatten(variables)
    back_leaves, back_tree = jax.tree_util.tree_flatten(back)
    assert tree == back_tree
    for a, b in zip(leaves, back_leaves):
        np.testing.assert_array_equal(a, b)


def test_npz_loads_like_the_nested_tree(tmp_path):
    variables = _jax_vars(dict(DET50, num_layers=18))
    flat = {}
    _flatten_into(flat, variables["params"], (), "params")
    _flatten_into(flat, variables["batch_stats"], (), "batch_stats")
    np.savez(tmp_path / "det.npz", **flat)
    got = weights.load_npz(str(tmp_path / "det.npz"))
    want = weights.state_dict_from_variables(variables)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_fused_bottleneck_matches_jax_unfused(monkeypatch):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 6, 1024)).astype(np.float32)
    jblock = JaxBottleneck(256, fuse_bn=False)
    variables = to_numpy_tree(jblock.init(jax.random.PRNGKey(1),
                                          jnp.asarray(x), train=False))
    for i in range(3):  # non-trivial BN folds
        bn_p = variables["params"][f"_BN_{i}"]["BatchNorm_0"]
        bn_s = variables["batch_stats"][f"_BN_{i}"]["BatchNorm_0"]
        c = bn_p["scale"].shape[0]
        bn_p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        bn_p["bias"] = rng.normal(size=c).astype(np.float32) * 0.2
        bn_s["mean"] = rng.normal(size=c).astype(np.float32) * 0.2
        bn_s["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    want = jblock.apply(variables, jnp.asarray(x), train=False)

    block = R.Bottleneck(1024, 256).eval()
    assert block.fused_link
    sd = {}
    for i in range(3):
        sd[f"conv{i + 1}.weight"] = weights._conv(
            variables["params"][f"Conv_{i}"]["kernel"])
        weights._bn(sd, f"bn{i + 1}", variables["params"][f"_BN_{i}"],
                    variables["batch_stats"][f"_BN_{i}"])
    block.load_state_dict(sd)
    calls = []
    real = R.fused_link
    monkeypatch.setattr(R, "fused_link",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        got = block(nchw(x))
    assert calls == [1]  # the link went through ops/conv_bn.py
    # fp32, three convs summed in another order
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_resnet50_detector_matches_jax():
    jdet, jvars, tdet, images = conditioned_pair(DET50, 64, 2, seed=0)
    jnet = JaxResPoseNet(18, 8, 50)
    jlogits = jnet.apply(
        {"params": jvars["params"]["net"],
         "batch_stats": jvars["batch_stats"]["net"]},
        jnp.asarray(images), train=False,
    )
    jkps = jdet.apply(jvars, jnp.asarray(images), train=False).kps
    with torch.no_grad():
        logits = tdet.net(nchw(images))
        kps = tdet(nchw(images)).kps
    assert logits.shape == (2, 18 * 8, 16, 16)
    assert kps.shape == (2, 3, 18, 3)
    # fp32 through 50 conditioned layers and the head, each conv summed in
    # another order: measured 2e-5 at most on logits up to 7, 5e-7 on kps
    np.testing.assert_allclose(logits.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jlogits), rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(kps.numpy(), np.asarray(jkps), atol=1e-5)


@pytest.mark.parametrize("key", ["phase_head", "subpixel", "s2d_stem"])
def test_head_and_stem_variants_compute_the_standard_function(key):
    """The JAX detector as its build_detector makes it from the same
    detector_params (phase_head: the phase-layout deconv head, the same
    function with the same parameters; subpixel and s2d_stem: not read
    there) against the port's standard head, on the same conditioned
    weights, forward in eval and in train mode."""
    params = dict(DET50, num_layers=18, **{key: True})
    jdet, jvars, tdet, images = conditioned_pair(params, 64, 2, seed=1)
    assert jdet.phase_head == (key == "phase_head")
    want = jdet.apply(jvars, jnp.asarray(images), train=False).kps
    with torch.no_grad():
        got = tdet(nchw(images)).kps
    # normalized coordinates, fp32 through 18 conditioned layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    (want, _) = jdet.apply(jvars, jnp.asarray(images), train=True,
                           mutable=["batch_stats"])
    tdet.train()
    with torch.no_grad():
        got = tdet(nchw(images)).kps
    np.testing.assert_allclose(got.numpy(), np.asarray(want.kps), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avg_pool_head_matches_jax(dtype):
    """The port's AvgPoolHead against the JAX package's on the flax Dense
    carried through weights.avg_pool_head_state_dict, on one seeded input:
    fp32 to 1e-5, bf16 compute to 1e-2; the output fp32 in both (the JAX
    package's tests/test_models.py holds its own the same way)."""
    from x_as_supervision_tpu.models.resnet import AvgPoolHead as JaxHead

    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 4, 32)).astype(np.float32)  # NHWC
    jhead = JaxHead(out_channels=54, dtype=getattr(jnp, dtype))
    variables = to_numpy_tree(jhead.init(jax.random.PRNGKey(2),
                                         jnp.asarray(x)))
    want = jhead.apply(variables, jnp.asarray(x))
    head = R.AvgPoolHead(32, 54, dtype=getattr(torch, dtype))
    head.load_state_dict(weights.avg_pool_head_state_dict(
        variables["params"]))
    got = head(nchw(x))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert got.shape == (3, 54)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)
