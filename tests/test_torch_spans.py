"""The port's named spans (x_as_supervision_tpu_torch/spans.py) on the CPU:
a tiny train step under torch.profiler records ``xas.train.step`` and
every phase, module, loss and kernel-op span inside it, and the remat
recompute's span exactly where a mode makes checkpoint regions; a
PoseEstimator call records its five stages inside ``xas.serve.request``;
the trainer's wait on the loader is a span; and with no profiler
recording, ``span`` returns one shared no-op context."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from x_as_supervision_tpu_torch import spans as X
from x_as_supervision_tpu_torch import weights
from x_as_supervision_tpu_torch.data.loader import BatchLoader
from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu_torch.models.detector import build_detector
from x_as_supervision_tpu_torch.serve import PoseEstimator
from x_as_supervision_tpu_torch.train import state as S
from x_as_supervision_tpu_torch.train.factory import (
    build_gan_spec,
    flagship_config,
)
from x_as_supervision_tpu_torch.train.trainer import (
    step_generator,
    to_device,
    waited,
)
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

LOSSES = (X.LOSS_SYMMETRY, X.LOSS_SMPL_GEN, X.LOSS_SMPL_PSEUDO_IMG,
          X.LOSS_PHYSIQUE_RECONS, X.LOSS_RECONSTRUCTION)
OPS = (X.CONV3X3, X.CONV3X3 + X.BACKWARD, X.INTEGRAL_MARGINALS,
       X.INTEGRAL_MARGINALS + X.BACKWARD)


def _recorded(fn):
    """fn() under torch.profiler: the xas.* ranges as (name, start, end)
    in microseconds, and fn's result."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith("xas.")]
    return ranges, out


def _inside(ranges, outer: str) -> bool:
    """Every range lies within one range named `outer`."""
    spans = [(a, b) for n, a, b in ranges if n == outer]
    return all(any(a <= s and e <= b for a, b in spans)
               for _, s, e in ranges)


@pytest.fixture(scope="module")
def steps():
    """{remat mode: the xas.* ranges of one traced tiny train step} (the
    tiny flagship config, two cameras of two 64^2 samples, fp32)."""
    ds = SyntheticPoseDataset(num_samples=8, cam_id_list=(0, 1),
                              patch_size=64)
    batch = to_device(ds.device_batch(0, 2), "cpu")
    out = {}
    for mode in ("full", "none"):
        cfg = flagship_config(tiny=True)
        cfg["model_params"]["remat"] = mode
        spec = build_gan_spec(cfg, torch.float32)
        for i, m in enumerate((spec.detector, spec.physique,
                               spec.discriminator)):
            weights.init_weights(m, 3 + i)
        state = S.TrainState(spec, cfg["train_params"], 10)
        S.train_step(state, batch, step_generator(0, 0, "cpu"))
        out[mode], _ = _recorded(lambda: S.train_step(
            state, batch, step_generator(0, 1, "cpu")))
    return out


@pytest.mark.parametrize("mode", ["full", "none"])
def test_train_step_records_every_phase(steps, mode):
    ranges = steps[mode]
    count = collections.Counter(n for n, _, _ in ranges)
    assert count[X.TRAIN_STEP] == 1
    for name in X.TRAIN_PHASES:
        assert count[name] >= 1, name
    assert _inside(ranges, X.TRAIN_STEP)


@pytest.mark.parametrize("mode", ["full", "none"])
def test_train_step_records_modules_losses_and_kernel_ops(steps, mode):
    count = collections.Counter(n for n, _, _ in steps[mode])
    for name in (X.DETECTOR, X.PHYSIQUE, X.DISCRIMINATOR, X.RENDER) \
            + LOSSES + OPS:
        assert count[name] >= 1, name
    # the camera and pseudo-image streams' forwards, each one decode
    assert count[X.DETECTOR] == 2


@pytest.mark.parametrize("mode,recomputes", [("full", 3), ("none", 0)])
def test_the_recompute_span_follows_the_remat_mode(steps, mode, recomputes):
    """``full`` makes three regions (both detector forwards and the line
    render), each recomputed once in the backward, inside
    ``xas.train.gen_backward``; ``none`` makes none."""
    ranges = steps[mode]
    rec = [r for r in ranges if r[0] == X.RECOMPUTE]
    assert len(rec) == recomputes
    assert _inside(rec + [r for r in ranges if r[0] == X.GEN_BACKWARD],
                   X.GEN_BACKWARD)


def test_serve_request_records_its_stages():
    det_params = dict(name="resnet_multi", num_kp=18, depth_dim=8,
                      num_hypo=2, neighbor_size=3, num_layers=18)
    det = build_detector(det_params, torch.float32)
    weights.init_weights(det, 1)
    config = {"dataset_params": {"dataiter": {"mean": [0.0, 0.0, 0.0],
                                              "std": [255.0] * 3}},
              "model_params": {"detector_params": det_params},
              "train_params": {"patch_width": 64}}
    est = PoseEstimator(config, det_state=det.state_dict(), batch_size=2,
                        dtype=torch.float32, device="cpu")
    images = np.random.default_rng(0).integers(
        0, 256, (3, 64, 64, 3), dtype=np.uint8)
    ranges, result = _recorded(lambda: est(images))
    assert result.kps_patch.shape[0] == 3
    count = collections.Counter(n for n, _, _ in ranges)
    assert count[X.SERVE_REQUEST] == 1
    # two chunks of at most two images: a copy, preprocess and forward each
    for name in (X.SERVE_COPY, X.SERVE_PREPROCESS, X.SERVE_FORWARD):
        assert count[name] == 2, name
    assert count[X.SERVE_FETCH] == count[X.SERVE_POSTPROCESS] == 1
    assert _inside(ranges, X.SERVE_REQUEST)


def test_the_trainers_wait_on_the_loader_is_a_span():
    """One wait a batch, and one more for the end of the epoch."""
    ds = SyntheticPoseDataset(num_samples=6, cam_id_list=(0,),
                              patch_size=16)
    loader = BatchLoader(ds, 2, num_workers=2, prefetch=1)
    ranges, n = _recorded(lambda: len(list(waited(loader.epoch(0)))))
    assert n == 3
    assert [r[0] for r in ranges] == [X.LOADER_WAIT] * 4


def test_without_a_profiler_a_span_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    off = X.span(X.TRAIN_STEP)
    assert off is X.span(X.SERVE_REQUEST) is X.span("xas.any")
    with off as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]):
        on = X.span(X.TRAIN_STEP)
        assert on is not off
        assert isinstance(on, torch.profiler.record_function)


def test_every_span_name_is_in_the_xas_namespace():
    names = [v for k, v in vars(X).items()
             if k.isupper() and isinstance(v, str) and k != "BACKWARD"]
    assert len(names) == len(set(names)) >= 29
    assert all(n.startswith("xas.") for n in names)
