"""The port's eval path (x_as_supervision_tpu_torch/train/{evaluator,
eval_utils,metrics}.py and the DLT in ops/geometry.py) against the JAX
package's, on the CPU, in fp32, from the same numpy inputs and the same
detector weights.

The detector weights start as flax-initialized JAX variables, go through the
port's weights.py, are conditioned in the port and go back through the JAX
package's convert_full_detector (tests/torch_parity.py:conditioned_pair), so
both evaluators run the same numbers.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_train_step import TINY_CONFIG
from torch_parity import conditioned_pair
from x_as_supervision_tpu.data.synthetic import (
    SyntheticPoseDataset as JaxDataset,
)
from x_as_supervision_tpu.ops import geometry as JG
from x_as_supervision_tpu.train import eval_utils as JEU
from x_as_supervision_tpu.train import metrics as JMET
from x_as_supervision_tpu.train.evaluator import Evaluator as JaxEvaluator
from x_as_supervision_tpu_torch.checks import (
    ANCHOR_SCALE,
    NOISE,
    AnchoredDataset,
    AnchoredDetector,
    result_lines,
)
from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
from x_as_supervision_tpu_torch.ops import geometry as G
from x_as_supervision_tpu_torch.train import eval_utils as EU
from x_as_supervision_tpu_torch.train import metrics as MET
from x_as_supervision_tpu_torch.train.evaluator import Evaluator, fetch

BATCH = 4
SAMPLES = 8
SIDE = 64
# intra-op threads of this module's torch work: the tests run beside other
# workers on a few cores, where torch's default of one thread per core
# oversubscribes them
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(saved)


def _perm(k=18):
    perm = list(range(k))
    for a, b in EU.DEFAULT_SWITCH_LIST:
        perm[a], perm[b] = b, a
    return perm


# ---------------------------------------------------------------- switch


@pytest.mark.parametrize("switch_all", [False, True])
@pytest.mark.parametrize("channels", [2, 3])
def test_switch_points_matches_jax(switch_all, channels):
    """Random points (no near ties), exact ties (points equal to their own
    L/R swap) and swaps that win by a margin, on the default 18-joint list:
    the same points and the same mask as the JAX function."""
    rng = np.random.default_rng(channels + 2 * switch_all)
    b, k = 16, 18
    pts = rng.uniform(-1, 1, (b, k, channels)).astype(np.float32)
    gt = rng.uniform(-1, 1, (b, k, 3)).astype(np.float32)
    # samples 0-3: symmetric points, so swapped == points (a tie: kept)
    pts[:4] = (pts[:4] + pts[:4][:, _perm()]) / 2
    # samples 4-7: the GT's own L/R swap (the swap wins)
    pts[4:8] = gt[4:8][:, _perm(), :channels]
    got, got_mask = EU.switch_points(torch.from_numpy(pts),
                                     torch.from_numpy(gt[..., :channels]),
                                     switch_all=switch_all)
    want, want_mask = JEU.switch_points(pts, gt[..., :channels],
                                        switch_all=switch_all)
    want_mask = np.asarray(want_mask)
    assert got_mask.shape == want_mask.shape
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not want_mask[:4].any()  # ties keep the points
    moved = [j for j in range(k) if _perm()[j] != j]
    assert want_mask[4:8][:, 0 if switch_all else moved].all()
    assert 0 < want_mask[8:].mean() < 1  # both outcomes among the random


def test_argmin_takes_the_first_of_tied_values():
    """Best mode relies on it: the 2D errors of all hypotheses are equal."""
    err = torch.tensor([[[1.0, 2.0, 0.5]], [[1.0, 2.0, 0.5]],
                        [[1.0, 3.0, 0.5]]]).permute(1, 0, 2)  # (1, H=3, K=3)
    np.testing.assert_array_equal(torch.argmin(err, dim=1).numpy(),
                                  [[0, 0, 0]])
    np.testing.assert_array_equal(
        torch.argmin(err, dim=1).numpy(),
        np.asarray(jnp.argmin(jnp.asarray(err.numpy()), axis=1)))


# ---------------------------------------------------------------- tables


def test_per_action_tables_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(-1, 1, (12, 18, 2))
    gt = rng.uniform(-1, 1, (12, 18, 2))
    np.testing.assert_array_equal(EU.per_act_mse(pred, gt),
                                  JEU.per_act_mse(pred, gt))
    tags = [f"act_{2 + i % 15:02d}_x" for i in range(0, 36, 3)]
    errs = {m: rng.uniform(0, 100, 12) for m in ("mpjpe", "p-mpjpe")}
    tables = []
    for mod in (EU, JEU):
        rec, cnt = mod.new_act_table(), mod.new_act_table()
        mod.update_dict(rec, cnt, mod.per_act_mse(pred, gt), tags)
        multi_rec = {m: mod.new_act_table() for m in errs}
        multi_cnt = {m: mod.new_act_table() for m in errs}
        for m, e in errs.items():
            mod.update_dict(multi_rec[m], multi_cnt[m], e, tags)
        tables.append((mod.cal_per_class_error(rec, cnt), rec,
                       mod.cal_per_class_error(multi_rec, multi_cnt,
                                               multi=True)))
    assert tables[0] == tables[1]
    assert EU.ACT_IDX_TO_NAME == JEU.ACT_IDX_TO_NAME
    assert EU.SELECT_ACTIONS == JEU.SELECT_ACTIONS


@pytest.mark.parametrize("alignment", ["none", "scale", "procrustes"])
def test_metrics_copy_matches_jax_module(alignment):
    rng = np.random.default_rng(1)
    gt = rng.normal(0, 300, (10, 18, 3))
    pred = gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0] * 1.1 + rng.normal(
        0, 40, gt.shape)
    mask = np.ones((10, 18), bool)
    mask[3, 4] = False
    for fn in ("keypoint_mpjpe", "keypoint_3d_pck", "keypoint_3d_auc"):
        np.testing.assert_array_equal(
            getattr(MET, fn)(pred / 1000, gt / 1000, mask, alignment),
            getattr(JMET, fn)(pred / 1000, gt / 1000, mask, alignment),
            err_msg=fn)
    head = rng.uniform(50, 150, 10)
    np.testing.assert_array_equal(MET.keypoint_pckh(pred, gt, head),
                                  JMET.keypoint_pckh(pred, gt, head))
    np.testing.assert_array_equal(
        MET.compute_similarity_transform_batch(pred, gt),
        JMET.compute_similarity_transform_batch(pred, gt))


# ---------------------------------------------------------------- DLT


def _tri_inputs(cams, seed):
    ds = JaxDataset(num_samples=BATCH, cam_id_list=cams, patch_size=SIDE)
    batch = ds.device_batch(0, BATCH)
    rng = np.random.default_rng(seed)
    kps = {}
    for c in cams:
        j = batch[f"cam_{c}_joints"]
        norm = np.concatenate([j[..., :2] / (SIDE - 1) * 2 - 1,
                               j[..., 2:] / (SIDE - 1)], axis=-1)
        kps[f"cam_{c}"] = (norm + rng.normal(0, 0.01, norm.shape)).astype(
            np.float32)
    return batch, kps


def _port_tri(batch, kps, cams, dtype=torch.float32):
    return G.triangulation(
        {k: torch.from_numpy(v).to(dtype) for k, v in kps.items()},
        {k: torch.from_numpy(v).to(dtype) for k, v in batch.items()}, cams,
        SIDE).numpy()


@pytest.mark.parametrize("cams", [(0, 1), (0, 1, 2, 3)])
def test_triangulation_matches_jax(cams):
    """World mm from noisy detections of 2 and 4 cameras. Both packages
    solve the DLT in fp32, whose own error against the float64 solution of
    the same system is up to 0.1 mm at these scales (the 4th column of the
    system is ~1e3 times the others); so each fp32 result is held to the
    port's float64 solve within 0.15 mm, and the two to each other within
    0.25 mm. The float64 solve agrees with the true world pose to the
    detections' noise."""
    batch, kps = _tri_inputs(cams, seed=len(cams))
    want = np.asarray(JG.triangulation(
        {k: jnp.asarray(v) for k, v in kps.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, list(cams)))
    got = _port_tri(batch, kps, cams)
    exact = _port_tri(batch, kps, cams, torch.float64)
    assert got.shape == want.shape == (BATCH, 18, 3)
    np.testing.assert_allclose(want, exact, rtol=0, atol=0.15)
    np.testing.assert_allclose(got, exact, rtol=0, atol=0.15)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.25)


def test_batch_triangulate_degenerate_camera():
    """A view with zero confidence contributes no rows: the 3-view result is
    the 2-view one, conf3d the mean over the views that see the joint, as
    in JAX; exact projections come back to their world points."""
    rng = np.random.default_rng(3)
    world = rng.normal(0, 500, (2, 5, 3))
    pmats, pts = [], []
    for v in range(3):
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        t = np.array([0.0, 0.0, 5000.0]) + rng.normal(0, 100, 3)
        k = np.array([[1100.0, 0, 500], [0, 1100.0, 500], [0, 0, 1]])
        p = k @ np.concatenate([rot, t[:, None]], axis=1)
        h = world @ p[:, :3].T + p[:, 3]
        uv = h[..., :2] / h[..., 2:]
        conf = np.full(uv.shape[:-1] + (1,), 0.0 if v == 2 else 5000.0)
        pts.append(np.concatenate([uv, conf], axis=-1))
        pmats.append(np.broadcast_to(p, (2, 3, 4)))
    kp = np.stack(pts, axis=1)  # (B, V, K, 3)
    pm = np.stack(pmats, axis=1)
    kp[:, 2, :, :2] += 1e3  # garbage where the view has no confidence
    got = G.batch_triangulate(torch.from_numpy(kp), torch.from_numpy(pm))
    two = G.batch_triangulate(torch.from_numpy(kp[:, :2].copy()),
                              torch.from_numpy(pm[:, :2].copy()))
    np.testing.assert_allclose(got[..., :3].numpy(), world, atol=1e-6)
    np.testing.assert_allclose(got[..., :3].numpy(), two[..., :3].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(got[..., 3].numpy(), 5000.0)
    want = np.asarray(JG.batch_triangulate(jnp.asarray(kp, jnp.float32),
                                           jnp.asarray(pm, jnp.float32)))
    got32 = G.batch_triangulate(torch.from_numpy(kp).float(),
                                torch.from_numpy(pm).float()).numpy()
    np.testing.assert_allclose(got32[..., 3], want[..., 3])
    np.testing.assert_allclose(got32[..., :3], want[..., :3], atol=0.25)


# ---------------------------------------------------------------- evaluator


def _config(dataset_name):
    cfg = {**TINY_CONFIG}
    cfg["dataset_params"] = {"cam_id_list": [0, 1],
                             "dataset": {"name": dataset_name}}
    cfg["train_params"] = dict(TINY_CONFIG["train_params"],
                               batch_size=BATCH)
    return cfg


def _anchor(img, kps):
    """checks.AnchoredDetector's sum in JAX (NHWC images)."""
    target = img[:, 0, :kps.shape[2], :].astype(kps.dtype)
    return target[:, None] + ANCHOR_SCALE * kps


class _JaxAnchored:
    """checks.AnchoredDetector for the JAX evaluator."""

    def __init__(self, detector):
        self.detector = detector

    def apply(self, variables, img, train=False):
        kps = self.detector.apply(variables, img, train=train).kps
        return types.SimpleNamespace(kps=_anchor(img, kps))


def _dataset(cls):
    return AnchoredDataset(cls(num_samples=SAMPLES, cam_id_list=(0, 1),
                               patch_size=SIDE), (0, 1), float(SIDE))


@pytest.fixture(scope="module")
def detectors():
    det_params = TINY_CONFIG["model_params"]["detector_params"]
    jdet, jvars, tdet, _ = conditioned_pair(det_params, SIDE, BATCH, seed=0)
    return jdet, jvars, tdet


@pytest.fixture(scope="module")
def jax_steps(detectors):
    """One jitted JAX step shared by every JAX evaluator (the protocol only
    changes the host-side tables): it compiles once per mode."""
    jdet, jvars, _ = detectors
    return JaxEvaluator(_config("hm36"), _JaxAnchored(jdet), jvars,
                        _dataset(JaxDataset), "unused",
                        img_size=float(SIDE))._device_step


def _evaluators(detectors, jax_steps, dataset_name, tmp_path):
    jdet, jvars, tdet = detectors
    jev = JaxEvaluator(_config(dataset_name), _JaxAnchored(jdet), jvars,
                       _dataset(JaxDataset), str(tmp_path / "jax"),
                       img_size=float(SIDE))
    jev._device_step = jax_steps
    pev = Evaluator(_config(dataset_name), AnchoredDetector(tdet),
                    _dataset(SyntheticPoseDataset), str(tmp_path / "port"),
                    img_size=float(SIDE), device="cpu")
    return jev, pev


@pytest.fixture(scope="module")
def jax_choice(detectors):
    """The JAX detector's raw hypotheses and the JAX evaluator's per-joint
    hypothesis choice in best mode (its step returns neither): the same
    switch and argmin in JAX, jitted."""
    jdet = detectors[0]

    @jax.jit
    def choice(jvars, img, kp_gt):
        raw = jdet.apply(jvars, img, train=False).kps
        sw3d, _ = jax.vmap(lambda p: JEU.switch_points(p, kp_gt,
                                                       switch_all=False),
                           in_axes=1, out_axes=1)(_anchor(img, raw))
        return raw, jnp.argmin(((sw3d - kp_gt[:, None]) ** 2).sum(-1), axis=1)

    return choice


# the thresholds of the MPI lines, meters (metrics.keypoint_3d_pck / _auc)
THRESHOLDS = {"pck": np.array([0.15]), "auc": np.linspace(0.0, 0.15, 31)}


def _straddles(got, want, got_gt, want_gt):
    """Per threshold metric: how many (joint, threshold) pairs the two
    packages' world poses put on either side of the threshold."""
    e_got = np.linalg.norm(got / 1000.0 - got_gt / 1000.0, axis=-1)[..., None]
    e_want = np.linalg.norm(want / 1000.0 - want_gt / 1000.0,
                            axis=-1)[..., None]
    return {m: int(((e_got < t) != (e_want < t)).sum())
            for m, t in THRESHOLDS.items()}


@pytest.mark.parametrize("mode", ["best", "confident"])
@pytest.mark.parametrize("dataset_name", ["hm36", "mpi_inf_3dhp"])
def test_evaluator_matches_jax(detectors, jax_steps, jax_choice,
                               dataset_name, mode, tmp_path):
    """Both evaluators on the anchored fixture (checks.AnchoredDataset: the
    detections lie near the GT, so the DLT is well posed). Per batch: the
    raw detector hypotheses within 1e-4, the swap masks and the hypothesis
    choices equal, the normalized 2D outputs within 1e-4, the world lifts
    within 1e-4 of their largest coordinate, the triangulation within
    0.25 mm per joint (the fp32 DLT's floor, test_triangulation_matches_jax).
    The whole run: eval_result.txt with the same keys in the same order,
    each number within 1e-4 relative, and the same ambiguity ratio. A PCK
    or AUC line counts joints under thresholds: where the two packages'
    poses (within their bounds above) put a joint on either side of one, the
    line may differ by that count times its step."""
    jvars, tdet = detectors[1], detectors[2]
    jev, pev = _evaluators(detectors, jax_steps, dataset_name, tmp_path)
    assert pev.num_batches == jev.num_batches == SAMPLES // BATCH

    swaps = choices = 0
    # per block of the MPI report: straddled (joint, threshold) pairs
    straddles = {"3D": {"pck": 0, "auc": 0}, "Tri3D": {"pck": 0, "auc": 0}}
    for b in range(pev.num_batches):
        batch = pev.dataset.batch(b * BATCH, BATCH)
        jbatch = jev.dataset.batch(b * BATCH, BATCH)
        jbatch.pop("act")
        want = jax.device_get(jev._device_step(
            jvars, {k: jnp.asarray(v) for k, v in jbatch.items()}, mode=mode))
        dev = pev.to_device(batch)
        got = fetch(pev.step(dev, mode))
        _, cams = pev.predict(dev, mode)
        for ck in ("cam_0", "cam_1"):
            np.testing.assert_array_equal(got["trans_masks"][ck],
                                          np.asarray(want["trans_masks"][ck]))
            swaps += int(got["trans_masks"][ck].sum())
            for key in ("kp_pred_2d", "gts_2d"):
                np.testing.assert_allclose(got[key][ck], want[key][ck],
                                           rtol=0, atol=1e-4, err_msg=key)
            # world mm of a few 1e3: 1e-4 of the largest
            w = np.asarray(want["per_cam_world"][ck])
            np.testing.assert_allclose(got["per_cam_world"][ck], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())
            for m, n in _straddles(got["per_cam_world"][ck], w,
                                   got["kps_world_gt"],
                                   want["kps_world_gt"]).items():
                straddles["3D"][m] += n
            img = jbatch[f"{ck}_img"]
            raw, jchoice = jax_choice(jvars, jnp.asarray(img),
                                      jnp.asarray(want["gts_2d"][ck]))
            with torch.no_grad():
                traw = tdet(torch.from_numpy(img).permute(0, 3, 1, 2)).kps
            np.testing.assert_allclose(traw.numpy(), np.asarray(raw),
                                       rtol=0, atol=1e-4)
            choice = cams[ck]["choice"].numpy()
            if mode == "best":
                np.testing.assert_array_equal(choice, np.asarray(jchoice))
                choices += int((choice > 0).sum())
            else:
                assert not choice.any()
        w = np.asarray(want["kps_world_gt"])
        np.testing.assert_allclose(got["kps_world_gt"], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
        np.testing.assert_allclose(got["tri"], np.asarray(want["tri"]),
                                   rtol=0, atol=0.25)
        for m, n in _straddles(got["tri"], want["tri"], got["kps_world_gt"],
                               want["kps_world_gt"]).items():
            straddles["Tri3D"][m] += n
    # the fixture exercises the switch and, in best mode, the choice
    assert swaps > 0
    assert choices > 0 or mode == "confident"

    want_path = jev.record(*jev.eval(mode=mode))
    got_path = pev.record(*pev.eval(mode=mode))
    want_lines, got_lines = result_lines(want_path), result_lines(got_path)
    assert [k for k, _ in got_lines] == [k for k, _ in want_lines]
    assert len(got_lines) == (15 if dataset_name == "hm36" else 13)
    cnt3d = pev._tables[3]
    block = None
    for (key, g), (_, w) in zip(got_lines, want_lines):
        if w is None:
            assert g is None
            block = key.strip("-")
            continue
        assert np.isfinite(g), key
        atol = 0.0
        if key in THRESHOLDS:
            # one straddle moves a batch's value by 100 / (pairs counted)
            step = 100.0 / (BATCH * 18 * len(THRESHOLDS[key]))
            atol = straddles[block][key] * step / cnt3d[key]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=key)
    assert pev.last_ambiguity_ratio == jev.last_ambiguity_ratio > 0


def test_anchored_fixture_puts_detections_near_the_gt():
    """checks.AnchoredDataset / AnchoredDetector: the targets ride in row 0
    of each image and the rest of the image is the dataset's; the same batch
    read twice is the same; the detector returns the targets plus
    ANCHOR_SCALE times the wrapped detector's hypotheses; the L/R switch
    finds swaps to undo and brings the joints within the noise of the
    normalized GT."""
    ds = _dataset(SyntheticPoseDataset)
    a, again = ds.batch(0, BATCH), ds.batch(0, BATCH)
    plain = SyntheticPoseDataset(num_samples=SAMPLES, cam_id_list=(0, 1),
                                 patch_size=SIDE).batch(0, BATCH)

    class Hypotheses(torch.nn.Module):
        """Three hypotheses: one x, y, three depths."""

        def forward(self, img):
            kps = torch.zeros(img.shape[0], 3, 18, 3)
            kps[..., :2] = 0.5
            kps[..., 2] = torch.arange(3.0)[:, None]
            return types.SimpleNamespace(kps=kps)

    det = AnchoredDetector(Hypotheses())
    swaps = 0
    for ck in ("cam_0", "cam_1"):
        img = a[f"{ck}_img"]
        np.testing.assert_array_equal(img, again[f"{ck}_img"])
        np.testing.assert_array_equal(img[:, 1:], plain[f"{ck}_img"][:, 1:])
        np.testing.assert_array_equal(img[:, 0, 18:],
                                      plain[f"{ck}_img"][:, 0, 18:])
        kps = det(torch.from_numpy(img).permute(0, 3, 1, 2)).kps
        target = torch.from_numpy(img[:, 0, :18])
        want = target[:, None] + ANCHOR_SCALE * Hypotheses()(img).kps
        np.testing.assert_array_equal(kps.numpy(), want.numpy())
        j = torch.from_numpy(a[f"{ck}_joints"])
        gt = torch.cat([j[..., :2] / (SIDE - 1) * 2 - 1,
                        j[..., 2:] / (SIDE - 1)], dim=-1)
        switched, mask = EU.switch_points(target, gt)
        swaps += int(mask.sum())
        err = (switched - gt).abs()
        # E|N(0, s)| = 0.8 s; an L/R pair closer than the noise may keep
        # its swap
        assert err.mean() < NOISE and err.max() < 10 * NOISE
    assert swaps > 0


def test_best_mode_keeps_the_first_of_tied_hypotheses(tmp_path):
    """A detector whose hypotheses are all equal: best mode picks
    hypothesis 0 for every joint (2D and 3D) and gives confident mode's
    result."""

    class Same(torch.nn.Module):
        def forward(self, img):
            b = img.shape[0]
            g = torch.Generator().manual_seed(int(img.sum().item()) % 1000)
            kps = torch.rand((b, 1, 18, 3), generator=g) * 2 - 1
            return type("Decode", (), {"kps": kps.expand(b, 3, 18, 3)})

    ev = Evaluator(_config("hm36"), Same(),
                   SyntheticPoseDataset(num_samples=BATCH, cam_id_list=(0, 1),
                                        patch_size=SIDE),
                   str(tmp_path), img_size=float(SIDE), device="cpu")
    batch = ev.to_device(ev.dataset.batch(0, BATCH))
    _, best = ev.predict(batch, "best")
    _, conf = ev.predict(batch, "confident")
    for ck in ("cam_0", "cam_1"):
        assert not best[ck]["choice"].any()
        for key in ("kp", "kp_2d"):
            np.testing.assert_array_equal(best[ck][key].numpy(),
                                          conf[ck][key].numpy())
    np.testing.assert_array_equal(fetch(ev.step(batch, "best"))["tri"],
                                  fetch(ev.step(batch, "confident"))["tri"])


def test_fetch_packs_one_transfer_and_keeps_types():
    out = {"a": {"x": torch.arange(6.0).reshape(2, 3),
                 "m": torch.tensor([[True, False]])},
           "i": torch.tensor([[3, 1]]), "z": torch.zeros(2, 1, 4)}
    got = fetch(out)
    np.testing.assert_array_equal(got["a"]["x"], out["a"]["x"].numpy())
    assert got["a"]["m"].dtype == bool and got["a"]["m"].tolist() == [
        [True, False]]
    assert got["i"].dtype == np.int64 and got["i"].tolist() == [[3, 1]]
    assert got["z"].shape == (2, 1, 4)


def test_evaluator_without_cuda_raises(detectors):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(_config("hm36"), detectors[2],
                  SyntheticPoseDataset(num_samples=BATCH, cam_id_list=(0, 1),
                                       patch_size=SIDE), "unused")
