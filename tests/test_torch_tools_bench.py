"""The port's device benchmarks (x_as_supervision_tpu_torch/tools/
bench_conv_bn.py, bench_resnet_control.py, bench_serve.py) on the CPU,
against the JAX package where it computes the same thing.

On the CPU each kernel wrapper runs its plain version, so these tests hold
what a tool computes and reports (its inputs, its model, its step, its
FLOP count, its rows), not a kernel: the card's numbers come from
chip_smoke.py's ``tools`` phase.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from torch_parity import nchw, to_numpy_tree
from x_as_supervision_tpu.ops import conv_bn_pallas as J
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.ops.conv_bn import bn_relu_conv_plain
from x_as_supervision_tpu_torch.tools import (
    bench_conv_bn,
    bench_resnet_control,
    bench_serve,
)
from x_as_supervision_tpu_torch.train.factory import flagship_config
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

CHECK_BATCHES = (1, 2)


@pytest.fixture(scope="module")
def check_rows():
    return bench_conv_bn.main(["--shapes", "8x64", "--check_batches",
                               ",".join(map(str, CHECK_BATCHES)), "--dtype",
                               "f32", "--device", "cpu"])


@pytest.mark.parametrize("i", range(len(CHECK_BATCHES)))
def test_conv_bn_check_batches_rows(check_rows, i):
    """One row per batch size, NCHW shapes, each the link against its plain
    version on the tool's own draws (on the CPU the link is the plain
    version, so exactly 0)."""
    row = check_rows[i]
    assert row["shape"] == f"{CHECK_BATCHES[i]}x64x8x8"
    assert row["layout"] == "NCHW" and row["device"] == "cpu"
    assert row["y_max_abs_err"] == 0 and row["stats_max_abs_err"] == 0
    assert row["y_max"] > 0


@pytest.mark.parametrize("batch", CHECK_BATCHES)
def test_plain_link_matches_xla_chain(batch):
    """The port's plain link on bench_conv_bn's draws against the JAX
    package's xla_bn_relu_conv (NHWC, HWIO) on the same arrays, fp32:
    y and the stats within 1e-5 of their largest magnitude."""
    rng = np.random.default_rng(batch)
    x, w, scale, shift = bench_conv_bn.inputs(rng, batch, 8, 64)
    got_y, got_s = bn_relu_conv_plain(*(torch.from_numpy(a)
                                        for a in (x, w, scale, shift)))
    want_y, want_s = J.xla_bn_relu_conv(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(scale),
        jnp.asarray(shift))
    want_y = np.asarray(want_y).transpose(0, 3, 1, 2)
    want_s = np.asarray(want_s)
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=0,
                               atol=1e-5 * np.abs(want_y).max())
    for k in range(2):
        np.testing.assert_allclose(got_s[k].numpy(), want_s[k], rtol=0,
                                   atol=1e-5 * np.abs(want_s[k]).max())


def test_conv_bn_bench_rows_on_cpu():
    """The timed rows on the CPU: times labelled ``cpu``, no device
    metric (bound, FLOP rate) and no launch."""
    rows = bench_conv_bn.main(["--shapes", "8x64,4x128", "--batch", "2",
                               "--iters", "1", "--device", "cpu"])
    assert [r["shape"] for r in rows] == ["64x8x8", "128x4x4"]
    for r in rows:
        assert r["device"] == "cpu" and r["path"] == "plain"
        assert r["bound_ms"] is None and r["fused_tflops"] is None
        assert set(r["launches_per_call"].values()) == {0}
        assert r["max_abs_err"] == 0
        assert min(r["fused_ms"], r["plain_ms"], r["library_ms"]) > 0
        assert r["speedup"] == pytest.approx(r["plain_ms"] / r["fused_ms"])


# ---------------------------------------------------------------- control

CONTROL = dict(layers=18, size=32, batch=4)


def _jax_classifier(dtype=jnp.float32):
    import flax.linen as nn

    from x_as_supervision_tpu.models.resnet import ResNetBackbone

    class ResNetClassifier(nn.Module):
        """The JAX tool's classifier (tools/bench_resnet_control.py) in
        `dtype`."""

        @nn.compact
        def __call__(self, x, train: bool = True):
            feats = ResNetBackbone(num_layers=CONTROL["layers"], dtype=dtype,
                                   name="backbone")(x, train)
            return nn.Dense(1000, dtype=dtype)(feats.mean(axis=(1, 2)))

    return ResNetClassifier()


def _jax_loss(model, variables, imgs, labels):
    def loss_fn(params):
        logits, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            imgs, train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()

    return loss_fn


@pytest.fixture(scope="module")
def control_case():
    """The JAX classifier's weights (each residual branch's last BatchNorm
    scale 0.1, the tests' conditioning of a random-weight ResNet in train
    mode: at 32^2 layer4's BatchNorms see 4 values a channel), seeded
    images and labels; the JAX step's loss and gradients in float64 (the
    reference the port's fp32 rounding is held to: JAX's own fp32 step,
    jitted and op by op, differ by 1.8e-4 of a gradient's largest entry);
    XLA's FLOP count of the JAX tool's whole fp32 step (value_and_grad,
    Adam, the update)."""
    model = _jax_classifier()
    rng = np.random.default_rng(3)
    b, s = CONTROL["batch"], CONTROL["size"]
    imgs = rng.normal(size=(b, s, s, 3)).astype(np.float32)
    labels = rng.integers(0, 1000, b)
    variables = to_numpy_tree(jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.asarray(imgs[:1]), train=False))
    for name, block in variables["params"]["backbone"].items():
        if name.startswith("BasicBlock"):
            bn = block["_BN_1"]["BatchNorm_0"]
            bn["scale"] = np.full_like(bn["scale"], 0.1)

    tx = optax.adam(1e-3)
    loss_fn = _jax_loss(model, variables, jnp.asarray(imgs),
                        jnp.asarray(labels))

    def step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    params = variables["params"]
    cost = jax.jit(step).lower(params, tx.init(params)).compile()
    cost = cost.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost

    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        loss64 = _jax_loss(_jax_classifier(jnp.float64), f64,
                           jnp.asarray(imgs, jnp.float64),
                           jnp.asarray(labels))
        loss, grads = jax.jit(jax.value_and_grad(loss64))(f64["params"])
        grads = jax.tree.map(lambda a: np.asarray(a, np.float64), grads)
        loss = float(loss)
    return dict(variables=variables, imgs=imgs, labels=labels, loss=loss,
                grads=grads, xla_flops=float(cost["flops"]))


def _port_model(variables):
    model = bench_resnet_control.ResNetClassifier(CONTROL["layers"],
                                                  torch.float32).train()
    model.load_state_dict(weights.resnet_classifier_state_dict(variables))
    return model


def test_control_step_matches_jax(control_case):
    """The port's classifier step (ResNet-18 at 32^2, batch 4, fp32) on the
    JAX classifier's weights (weights.resnet_classifier_state_dict) against
    the JAX step (float64): the loss within 1e-5 relative, each parameter's
    gradient within 1e-4 of its largest entry."""
    c = control_case
    model = _port_model(c["variables"])
    loss = bench_resnet_control.loss_fn(
        model, nchw(c["imgs"]), torch.from_numpy(c["labels"]))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = weights.resnet_classifier_state_dict(
        {"params": c["grads"], "batch_stats": c["variables"]["batch_stats"]})
    assert abs(loss.item() - c["loss"]) <= 1e-5 * abs(c["loss"])
    assert set(names) <= set(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("layers,size,batch", [(18, 32, 4), (50, 64, 2)])
def test_control_flops_equal_flop_counter(layers, size, batch):
    """The analytic FLOPs of a step equal FlopCounterMode's count of the
    CPU path's forward and backward (every conv, the link's plain chain and
    its backward's convolution_backward included: ResNet-50 runs the link
    at 64^2 too)."""
    model = bench_resnet_control.ResNetClassifier(layers,
                                                  torch.float32).train()
    imgs = torch.randn(batch, 3, size, size)
    labels = torch.randint(0, 1000, (batch,))
    with FlopCounterMode(display=False) as counter:
        bench_resnet_control.loss_fn(model, imgs, labels).backward()
    assert bench_resnet_control.analytic_flops(model, batch, size) == \
        counter.get_total_flops()


def test_control_flops_against_xla(control_case):
    """The analytic count against XLA's cost analysis of the JAX tool's
    whole step at the same shape: printed (PERF.md records the ratio), not
    held; XLA also counts BatchNorm, the optimizer and elementwise work."""
    model = _port_model(control_case["variables"])
    analytic = bench_resnet_control.analytic_flops(
        model, CONTROL["batch"], CONTROL["size"])
    ratio = analytic / control_case["xla_flops"]
    print(json.dumps({"control_flops_analytic": analytic,
                      "control_flops_xla": control_case["xla_flops"],
                      "ratio": ratio, **CONTROL}))
    assert analytic > 0 and control_case["xla_flops"] > 0


def test_control_tool_rows_on_cpu():
    """bench_resnet_control's CLI on the CPU: a finite loss, no MFU (no
    card, no peak) and no launch."""
    (row,) = bench_resnet_control.main([
        "--layers", "18", "--size", "32", "--batch", "2", "--iters", "1",
        "--warmup", "1", "--device", "cpu"])
    assert row["device"] == "cpu" and row["mfu_vs_bf16_peak"] is None
    assert np.isfinite(row["loss"]) and row["step_ms"] > 0
    assert row["flops_per_step"] == bench_resnet_control.analytic_flops(
        bench_resnet_control.ResNetClassifier(18), 2, 32)
    assert set(row["launches_per_step"].values()) == {0}


# ---------------------------------------------------------------- serving


def _serve_config(tmp_path):
    cfg = flagship_config(tiny=True)
    cfg["dataset_params"]["dataiter"] = {"mean": [0.0, 0.0, 0.0],
                                         "std": [255.0, 255.0, 255.0]}
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


def test_serve_rows_on_cpu(tmp_path):
    """bench_serve on the tiny flagship detector (ResNet-18 at 64^2, D = 8)
    with seeded weights at batches 1 and 2: one row each, positive times
    and rates, a finite checksum of the device forward's keypoints, no
    launch on the CPU."""
    _, path = _serve_config(tmp_path)
    rows = bench_serve.main(["--config", path, "--batches", "1,2",
                             "--iters", "2", "--device", "cpu"])
    assert [r["batch"] for r in rows] == [1, 2]
    for r in rows:
        assert r["device"] == "cpu" and np.isfinite(r["checksum"])
        assert r["device_ms"] > 0 and r["end_to_end_ms"] > 0
        assert r["img_s_device"] == pytest.approx(
            r["batch"] / r["device_ms"] * 1e3)
        assert set(r["launches_per_forward"].values()) == {0}


def test_serve_from_a_checkpoint(tmp_path):
    """--checkpoint serves the detector of a checkpoint of the port's
    trainer: its forward's checksum is that of PoseEstimator on the same
    checkpoint and images."""
    from x_as_supervision_tpu_torch.serve import PoseEstimator
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt
    from x_as_supervision_tpu_torch.train.factory import build_gan_spec
    from x_as_supervision_tpu_torch.train.state import TrainState

    cfg, path = _serve_config(tmp_path)
    spec = build_gan_spec(cfg, torch.float32)
    weights.init_weights(spec.detector, 5)
    saved = ckpt.save_checkpoint(str(tmp_path), 0,
                                 TrainState(spec, cfg["train_params"], 1))
    (row,) = bench_serve.main(["--config", path, "--checkpoint", saved,
                               "--batches", "2", "--iters", "1", "--device",
                               "cpu"])
    est = PoseEstimator(cfg, checkpoint_path=saved, batch_size=2,
                        device="cpu")
    imgs = np.random.default_rng(0).uniform(0, 255, size=(2, 64, 64, 3))
    want = est(imgs.astype(np.float32)).kps_patch.astype(np.float64).sum()
    assert row["checksum"] == pytest.approx(want, rel=1e-6, abs=1e-6)
