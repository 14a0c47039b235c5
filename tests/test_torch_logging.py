"""TensorBoard logging of the port (x_as_supervision_tpu_torch/train/
logging.py, vis.py, profiling.py; the visualization outputs of the GAN
step; the evaluator's panels) against the JAX package's, on the CPU.

  * the event writer: CRC-32C against TensorBoard's, a round trip through
    TensorBoard's EventAccumulator (scalars equal as float32, images equal
    after decoding) and through checks.read_events (every CRC checked);
    it imports and writes with jax, tensorboardX, tensorboard, cv2 and
    matplotlib blocked;
  * the outputs of one tiny fp32 fused step, from the JAX train state
    carried into the port (dropout off on both sides, as in
    tests/test_torch_train.py): the JAX keys, values within 1e-4, and a
    state after the step bitwise equal to that of a step without outputs;
  * tb_vis on the same numpy metrics, outputs and batch as the JAX tb_vis
    (tensorboardX writer): the same tags at each step, scalars within 1e-6
    relative, image panels pixel-equal, figure panels of the same shape;
  * the trainer's cadence (log_interval 2 over 4 steps) and the StepTimer;
  * the evaluator's panels against the JAX _log_batch_images.
"""

import json
import os
import subprocess
import sys
import types

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)

from __graft_entry__ import _flagship_config
from torch_parity import carry_train_state
from torch_parity import jax_init_state
from x_as_supervision_tpu.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu.train.evaluator import Evaluator as JaxEvaluator
from x_as_supervision_tpu.train.factory import build_gan_spec as jax_spec
from x_as_supervision_tpu.train.logging import tb_vis as jax_tb_vis
from x_as_supervision_tpu.train.profiling import StepTimer as JaxStepTimer
from x_as_supervision_tpu.train.state import (
    make_optimizers,
    make_train_step,
)
from x_as_supervision_tpu_torch.checks import bitwise_diffs, events_in, flat
from x_as_supervision_tpu_torch.train import checkpoint as ckpt
from x_as_supervision_tpu_torch.train import logging as L
from x_as_supervision_tpu_torch.train import profiling, vis
from x_as_supervision_tpu_torch.train.evaluator import Evaluator
from x_as_supervision_tpu_torch.train.factory import (
    build_gan_spec,
    flagship_config,
)
from x_as_supervision_tpu_torch.train.state import TrainState, train_step
from x_as_supervision_tpu_torch.train.trainer import Trainer, to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2
LR = 1e-4
THREADS = 2
# image panels drawn by img_vis / pose_vis (compared pixel by pixel); the
# rest are matplotlib figures (compared by shape)
PIXEL_PAGES = ("training_img/", "training_mask/", "training_pose_2d/",
               "training_pseudo/pose_2d", "training_smpl/pose_smpl_2d",
               "testing_pred_pose/", "testing_gt_pose/")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(saved)


def _accumulate(log_dir):
    ea = EventAccumulator(log_dir, size_guidance={"images": 0,
                                                  "scalars": 0})
    ea.Reload()
    return ea


def _decode(png: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(png)))


def _by_step(ea) -> dict:
    """{step: {tag: ('scalar', value) | ('image', event)}}."""
    out: dict = {}
    for tag in ea.Tags()["scalars"]:
        for e in ea.Scalars(tag):
            out.setdefault(e.step, {})[tag] = ("scalar", e.value)
    for tag in ea.Tags()["images"]:
        for e in ea.Images(tag):
            out.setdefault(e.step, {})[tag] = ("image", e)
    return out


# ------------------------------------------------------------ the writer


def test_crc32c_is_tensorboards():
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import (
        masked_crc32c,
    )

    assert L.crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert L.masked_crc32c(data) == masked_crc32c(data), n


def test_writer_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    w = L.SummaryWriter(str(tmp_path))
    scalars = {("a/x", 0): 1.0 / 3.0, ("a/x", 7): -2.5e-9, ("b", 2**40): 7.0}
    for (tag, step), v in scalars.items():
        w.add_scalar(tag, v, step)
    images = {"rgb": rng.integers(0, 256, (3, 17, 23), dtype=np.uint8),
              "gray": rng.integers(0, 256, (1, 9, 5), dtype=np.uint8)}
    for tag, img in images.items():
        w.add_image(tag, img, 3)
    with pytest.raises(ValueError, match="uint8"):
        w.add_image("f", np.zeros((3, 4, 4), np.float32), 0)
    w.close()

    ea = _accumulate(str(tmp_path))
    for (tag, step), v in scalars.items():
        (e,) = [e for e in ea.Scalars(tag) if e.step == step]
        assert e.value == np.float32(v)
    for tag, img in images.items():
        (e,) = ea.Images(tag)
        assert (e.step, e.height, e.width) == (3, *img.shape[1:])
        got = _decode(e.encoded_image_string)
        np.testing.assert_array_equal(got.reshape(*img.shape[1:], -1),
                                      img.transpose(1, 2, 0))

    (events,) = events_in(str(tmp_path)).values()
    assert events[0]["file_version"] == "brain.Event:2"
    assert sum(e["file_version"] is not None for e in events) == 1
    got = {(t, e["step"]): v for e in events for t, v in e["scalars"].items()}
    assert got == {k: float(np.float32(v)) for k, v in scalars.items()}
    assert {t: s for e in events for t, s in e["images"].items()} == {
        "rgb": (17, 23, 3), "gray": (9, 5, 1)}

    # one flipped bit anywhere fails a CRC
    path = w.path
    data = bytearray(open(path, "rb").read())
    for pos in (3, 20, len(data) - 2):
        bad = bytearray(data)
        bad[pos] ^= 0x10
        open(path, "wb").write(bytes(bad))
        with pytest.raises(ValueError, match="CRC"):
            events_in(str(tmp_path))


def test_writers_in_one_second_get_their_own_files(tmp_path):
    a, b = L.SummaryWriter(str(tmp_path)), L.SummaryWriter(str(tmp_path))
    a.close(), b.close()
    assert a.path != b.path and len(events_in(str(tmp_path))) == 2


def test_writer_flushes_every_flush_secs(tmp_path, monkeypatch):
    import time

    now = {"t": 1000.0}
    monkeypatch.setattr(time, "monotonic", lambda: now["t"])
    w = L.SummaryWriter(str(tmp_path))
    size = os.path.getsize(w.path)
    w.add_scalar("a", 1.0, 1)
    assert os.path.getsize(w.path) == size  # buffered
    now["t"] += L.FLUSH_SECS
    w.add_scalar("a", 2.0, 2)
    assert os.path.getsize(w.path) > size
    w.close()
    (events,) = events_in(str(tmp_path)).values()
    assert [e["scalars"].get("a") for e in events] == [None, 1.0, 2.0]


def test_nothing_is_skipped_here():
    assert vis.missing() == ()


BLOCKED_RUN = r"""
import importlib.abc, json, sys
import numpy as np

BLOCKED = ("jax", "jaxlib", "flax", "tensorboardX", "tensorboard", "cv2",
           "matplotlib", "x_as_supervision_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Block())
from x_as_supervision_tpu_torch.checks import events_in
from x_as_supervision_tpu_torch.train.logging import create_writer, tb_vis

w = create_writer(sys.argv[1])
w.add_scalar("a/b", 0.25, 3)
k = np.zeros((1, 18, 3), np.float32)
tb_vis(w, 0, np.array([[1, 4]]), np.zeros(18, int), 1.0, {"x": 0.5}, None,
       {"pose_3d_depth_cam_0": k, "pose_2d_pred_cam_0_ori": k,
        "depth_map_cam_0": np.zeros((18, 8), np.float32)},
       {"cam_0_img": np.zeros((1, 16, 16, 3), np.float32),
        "cam_0_joints": k}, {}, detector_lr=1e-4)
w.close()
events = next(iter(events_in(sys.argv[1]).values()))
print(json.dumps({
    "skipped": dict(w.skipped),
    "scalars": sorted(t for e in events for t in e["scalars"]),
    "images": sorted(t for e in events for t in e["images"]),
    "loaded": sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED),
}))
"""


def test_writer_without_optional_packages(tmp_path):
    res = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    out = json.loads(lines[-1])
    assert out["loaded"] == []
    assert out["scalars"] == ["a/b", "meta/learning_rate/detector",
                              "training_loss/total_loss", "training_loss/x"]
    # the 2D panels are written (without skeletons), the figures are not
    assert out["images"] == ["training_img/cam_0_img",
                             "training_pose_2d/cam_0_gt_pose",
                             "training_pose_2d/pose_2d_pred_cam_0_ori"]
    assert out["skipped"] == {
        "training_pose_2d/cam_0_gt_pose skeleton": 1,
        "training_pose_2d/pose_2d_pred_cam_0_ori skeleton": 1,
        "training_pose_3d/pose_3d_depth_cam_0": 1,
        "training_depth/depth_map_cam_0": 1}
    said = [ln for ln in lines if ln.startswith("tensorboard:")]
    assert said == [f"tensorboard: {n} is not installed; not written: "
                    f"{L.PANELS_NEEDING[n]}" for n in ("cv2", "matplotlib")]


# ------------------------------------------------------------ the outputs


@pytest.fixture(scope="module")
def fused_step(tmp_path_factory):
    """One tiny fp32 fused step with outputs: JAX's, and the port's from
    the same carried state, with and without outputs."""
    cfg = _flagship_config(tiny=True)
    ds = SyntheticPoseDataset(num_samples=BATCH, cam_id_list=(0, 1),
                              patch_size=64)
    batch = ds.batch(0, BATCH)
    device_batch = {k: v for k, v in batch.items() if k != "act"}
    spec = jax_spec(cfg)
    opt_det, opt_disc = make_optimizers(cfg["train_params"], 10)
    js = jax_init_state(tmp_path_factory, cfg, device_batch, opt_det,
                        opt_disc, 10)
    step = make_train_step(spec, opt_det, opt_disc)
    ports = []
    for with_outputs in (False, True):
        pspec = build_gan_spec(flagship_config(tiny=True), torch.float32)
        pspec.discriminator.header.p_dropout = 0.0
        state = TrainState(pspec, cfg["train_params"], 10)
        carry_train_state(pspec, state, js)
        result = train_step(state, to_device(device_batch, "cpu"),
                            with_outputs=with_outputs)
        ports.append((state, result))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        _, jmetrics, jouts = step(js, device_batch, jax.random.PRNGKey(0),
                                  do_disc=True, do_gen=True,
                                  with_outputs=True)
    (plain, pmetrics), (vis_state, (vmetrics, vouts)) = ports
    return dict(
        cfg=cfg, batch=batch,
        jmetrics={k: np.asarray(v) for k, v in jmetrics.items()},
        jouts={k: np.asarray(v) for k, v in jouts.items()},
        plain=plain, pmetrics=pmetrics, vis_state=vis_state,
        vmetrics=vmetrics, vouts={k: v.numpy() for k, v in vouts.items()})


def test_outputs_match_jax(fused_step):
    want, got = fused_step["jouts"], fused_step["vouts"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k.startswith("pose_3d_depth_"):
            w = w[:1]  # the JAX package keeps the batch, the port sample 0
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k.startswith("mask_physique_"):
            # the physique net's sigmoid per pixel: its BatchNorms see a
            # nearly binary mask, where flax's one-pass variance and the
            # port's two-pass one part most (tests/test_torch_train.py);
            # measured over three runs: 1 to 5 pixels of 4096 above 1e-4,
            # the largest 1.6e-4
            d = np.abs(g - w)
            assert np.mean(d > 1e-4) <= 1e-2 and d.max() <= 1e-3, k
            continue
        # fp32 through the same step from the same state (the losses agree
        # to 1e-4 relative in tests/test_torch_train.py)
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=k)


def test_outputs_leave_the_step_as_it_was(fused_step):
    """The state after a step with outputs is bitwise the state after one
    without, and so are the metrics."""
    plain, vis_state = fused_step["plain"], fused_step["vis_state"]
    assert not bitwise_diffs(flat(ckpt.state_dict(vis_state)),
                             flat(ckpt.state_dict(plain)))
    pm, vm = fused_step["pmetrics"], fused_step["vmetrics"]
    assert sorted(pm) == sorted(vm)
    for k in pm:
        assert torch.equal(pm[k], vm[k]), k
    for v in fused_step["vouts"].values():
        assert np.isfinite(v).all()


def _events(tmp_path, name, fn):
    d = str(tmp_path / name)
    fn(d)
    return _by_step(_accumulate(d))


def test_tb_vis_matches_jax(fused_step, tmp_path):
    from tensorboardX import SummaryWriter as XWriter

    m = fused_step["jmetrics"]
    args = lambda step: (
        step, np.array(fused_step["cfg"]["model_params"]["flip_pairs"]),
        np.array(fused_step["cfg"]["model_params"]["parent_ids"]),
        m["loss_total"], {k[5:]: v for k, v in m.items()
                          if k.startswith("loss/")},
        m["loss_disc"], fused_step["jouts"], fused_step["batch"],
        fused_step["cfg"])

    def run(writer):
        def go(d):
            w = writer(d)
            for step in (0, 1):
                (jax_tb_vis if writer is XWriter else L.tb_vis)(
                    w, *args(step), detector_lr=LR)
            w.close()
            assert writer is XWriter or not w.skipped
        return go

    want = _events(tmp_path, "jax", run(XWriter))
    got = _events(tmp_path, "port", run(L.SummaryWriter))
    assert sorted(got) == sorted(want) == [0, 1]
    for step in (0, 1):
        assert sorted(got[step]) == sorted(want[step]), step
        for tag, (kind, w) in want[step].items():
            g = got[step][tag][1]
            if kind == "scalar":
                np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=tag)
                continue
            gi, wi = _decode(g.encoded_image_string), _decode(
                w.encoded_image_string)
            if tag.startswith(PIXEL_PAGES):
                np.testing.assert_array_equal(gi, wi, err_msg=tag)
            else:
                assert gi.shape == wi.shape, tag
    assert not any(kind == "image" for kind, _ in got[1].values())


# ------------------------------------------------------------ the cadence


def test_trainer_cadence(tmp_path):
    """log_interval 2 over 4 steps: scalars at steps 0 and 2, panels at step
    0 only (lcm(50, 2) = 50), no StepTimer tags (it logs at multiples of
    50 once it has an average, which step 0 has not), and the profiler's
    trace of step 1."""
    cfg = flagship_config(tiny=True)
    cfg["train_params"].update(batch_size=2, num_epochs=1, log_interval=2,
                               profile={"start_step": 1, "num_steps": 1})
    ds = SyntheticPoseDataset(num_samples=8, cam_id_list=(0, 1),
                              patch_size=64)
    run = tmp_path / "run"
    trainer = Trainer(cfg, ds, seed=0, dtype=torch.float32, device="cpu",
                      save_dir=str(run), num_workers=2)
    assert (trainer.log_interval, trainer.vis_interval) == (2, 50)
    writer = L.SummaryWriter(str(run / "tensorboard"))
    lines = []
    history = trainer.train(log=lines.append, tb_logger=writer)
    writer.close()
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == [
        "0", "2"]
    assert len(history) == 2 and all(len(h) == 7 for h in history)
    by_step = _by_step(_accumulate(str(run / "tensorboard")))
    assert sorted(by_step) == [0, 2]
    for step, tags in by_step.items():
        scalars = {t for t, (kind, _) in tags.items() if kind == "scalar"}
        images = {t for t, (kind, _) in tags.items() if kind == "image"}
        assert {"training_loss/total_loss", "training_loss/smpl_disc",
                "meta/learning_rate/detector"} <= scalars
        assert not any(t.startswith("meta/step") for t in scalars)
        assert bool(images) == (step == 0)
        assert history[step // 2]["loss_total"] == np.float32(
            tags["training_loss/total_loss"][1])
    assert os.listdir(run / "profile") == ["trace_1_2.json"]


def test_step_timer_matches_jax(monkeypatch):
    import time

    clock = iter(np.cumsum([0.0, 0.1, 0.3, 0.2, 0.25, 0.4, 0.15, 0.2]))
    now = {"t": 0.0}
    monkeypatch.setattr(time, "perf_counter", lambda: now["t"])

    class Rec:
        def __init__(self):
            self.calls = []

        def add_scalar(self, *a):
            self.calls.append(a)

    timers = (JaxStepTimer(), profiling.StepTimer())
    recs = (Rec(), Rec())
    for step, t in enumerate(clock):
        now["t"] = float(t)
        ticks = [timer.tick() for timer in timers]
        assert ticks[0] == ticks[1]
        for timer, rec in zip(timers, recs):
            timer.log(rec, step, 8)
    assert timers[0].avg_ms == timers[1].avg_ms is not None
    assert recs[0].calls == recs[1].calls
    assert [c[0] for c in recs[1].calls[:2]] == ["meta/step_time_ms",
                                                 "meta/images_per_sec"]


# ------------------------------------------------------------ eval panels


def test_eval_panels_match_jax(tmp_path):
    from tensorboardX import SummaryWriter as XWriter

    cfg = flagship_config(tiny=True)
    cams = cfg["dataset_params"]["cam_id_list"]
    rng = np.random.default_rng(3)
    batch = SyntheticPoseDataset(num_samples=2, cam_id_list=cams,
                                 patch_size=64).batch(0, 2)
    ck = [f"cam_{c}" for c in cams]
    out = {"kps_world_gt": rng.normal(0, 300, (2, 18, 3)),
           "tri": rng.normal(0, 300, (2, 18, 3)),
           "kp_pred_2d": {c: rng.uniform(-1, 1, (2, 18, 2)) for c in ck},
           "gts_2d": {c: rng.uniform(-1, 1, (2, 18, 3)) for c in ck},
           "per_cam_world": {c: rng.normal(0, 300, (2, 18, 3)) for c in ck}}
    pairs = np.array(cfg["model_params"]["flip_pairs"])
    parents = np.array(cfg["model_params"]["parent_ids"])
    me = types.SimpleNamespace(config=cfg, cam_id_list=cams)

    def run(writer, fn):
        def go(d):
            w = writer(d)
            for step in (0, 3):
                fn(me, w, step, batch, out, pairs, parents)
            w.close()
        return go

    want = _events(tmp_path, "jax",
                   run(XWriter, JaxEvaluator._log_batch_images))
    got = _events(tmp_path, "port",
                  run(L.SummaryWriter, Evaluator._log_batch_images))
    assert sorted(got) == sorted(want) == [0, 3]
    for step in (0, 3):
        assert sorted(got[step]) == sorted(want[step])
        assert {t.split("/")[0] for t in got[step]} == {
            "testing_pose_3D", "testing_pred_pose", "testing_gt_pose"}
        for tag, (_, w) in want[step].items():
            gi = _decode(got[step][tag][1].encoded_image_string)
            wi = _decode(w.encoded_image_string)
            if tag.startswith(PIXEL_PAGES):
                np.testing.assert_array_equal(gi, wi, err_msg=tag)
            else:
                assert gi.shape == wi.shape, tag
