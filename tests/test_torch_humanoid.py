"""The port's humanoid body model and SURREAL constructor
(x_as_supervision_tpu_torch/tools/{humanoid,surreal_constructor}.py)
against the JAX package's tools: the body's arrays, its H36M regressor and
radii bit-equal; the splat renders equal on the same inputs; its SMPL
forward within 1e-5 m; the constructor's numpy helpers equal (frame
sampling from numpy's global generator under the same seed) and its
per-frame joints within 1e-3 px, the crop box's integer corners within one
pixel (they land on integers, see checks.CAMPAIGN_BOUNDS).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x_as_supervision_tpu.models import smpl as JS
from x_as_supervision_tpu.tools import humanoid as JH
from x_as_supervision_tpu.tools import surreal_constructor as JSC
from x_as_supervision_tpu_torch.models import smpl as S
from x_as_supervision_tpu_torch.ops import geometry as G
from x_as_supervision_tpu_torch.tools import humanoid as H
from x_as_supervision_tpu_torch.tools import prng
from x_as_supervision_tpu_torch.tools import surreal_constructor as SC
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

ARRAYS = ("v_template", "shapedirs", "posedirs", "j_regressor", "weights",
          "betas_mean")


@pytest.fixture(scope="module")
def bodies():
    return JH.make_humanoid_smpl(), H.make_humanoid_smpl()


def test_humanoid_bit_equal(bodies):
    (jmodel, jreg, jradii), (model, reg, radii) = bodies
    assert isinstance(model, S.SmplModel)
    for name in ARRAYS:
        got = getattr(model, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jmodel, name)))
    assert model.kintree_parents == tuple(jmodel.kintree_parents)
    assert H.SMPL_PARENTS == JH.SMPL_PARENTS
    np.testing.assert_array_equal(H.REST_JOINTS, JH.REST_JOINTS)
    np.testing.assert_array_equal(model.faces, jmodel.faces)
    assert reg.dtype == jreg.dtype and radii.dtype == jradii.dtype
    np.testing.assert_array_equal(reg, jreg)
    np.testing.assert_array_equal(radii, jradii)


def test_humanoid_forward_matches_jax(bodies):
    (jmodel, _, _), (model, _, _) = bodies
    pose, beta = (v.numpy() for v in G.rule_transformation_from(
        prng.rule_draws_from_key(prng.prng_key(4), 8)))
    jv, jj = JS.smpl_forward(jmodel, jnp.asarray(pose), jnp.asarray(beta),
                             center_idx=None)
    v, j = S.smpl_forward(model, torch.from_numpy(pose),
                          torch.from_numpy(beta), center_idx=None)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=0, atol=1e-5)


def _posed(bodies, seed=5):
    """Camera-frame vertices of a posed humanoid, mm, 4 m in front."""
    (jmodel, _, jradii), _ = bodies
    rng = np.random.default_rng(seed)
    pose = (rng.normal(0, 0.3, (1, 72))).astype(np.float32)
    v, _ = JS.smpl_forward(jmodel, jnp.asarray(pose), None, center_idx=0)
    return np.asarray(v[0]) * 1000.0 + np.array([0.0, 0.0, 4000.0]), \
        jradii * 1000.0


def test_splats_equal(bodies):
    verts, radii = _posed(bodies)
    limb = np.asarray(bodies[0][0].weights).argmax(1)
    args = (360.0, 360.0, 192.0, 192.0, 384, 384)
    mask = H.splat_mask(verts, radii, *args)
    np.testing.assert_array_equal(mask, JH.splat_mask(verts, radii, *args))
    assert 0.02 < mask.mean() < 0.5
    palette = [(60, 70, 170), (150, 90, 60), (70, 140, 60)]
    for shade in (True, False):
        got = H.splat_shaded(verts, radii, limb, *args, palette, shade)
        np.testing.assert_array_equal(
            got, JH.splat_shaded(verts, radii, limb, *args, palette, shade))
    u, v, z = H.project_points(verts, 360.0, 360.0, 192.0, 192.0)
    for a, b in zip((u, v, z), JH.project_points(verts, 360.0, 360.0, 192.0,
                                                 192.0)):
        np.testing.assert_array_equal(a, b)


def test_camera_helpers_equal():
    np.testing.assert_array_equal(SC.get_intrinsic(320, 240),
                                  JSC.get_intrinsic(320, 240))
    loc = np.array([8.0, 0.0, 1.0])
    for a, b in zip(SC.get_extrinsic(loc), JSC.get_extrinsic(loc)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for v in [np.zeros(3)] + list(rng.normal(0, 1.2, (6, 3))):
        r = SC._axangle_to_mat(v)
        np.testing.assert_array_equal(r, JSC._axangle_to_mat(v))
        np.testing.assert_array_equal(SC._mat_to_axangle(r),
                                      JSC._mat_to_axangle(r))
        rz = SC._axangle_to_mat(np.array([0.0, 0.0, v[0]]))
        np.testing.assert_array_equal(SC.rotate_body(rz, v),
                                      JSC.rotate_body(rz, v))
    pts = rng.normal(0, 1, (18, 3)) + np.array([0.0, 0.0, 1.0])
    ext = SC.get_extrinsic(loc)[0]
    intr = SC.get_intrinsic(320, 240)
    for central in (False, True):
        np.testing.assert_array_equal(
            SC.project_vertices(pts, intr, ext, central),
            JSC.project_vertices(pts, intr, ext, central))


def _info(seed=0, n=24):
    """A SURREAL _info dict: joints2D with the pelvis near the centre in
    some frames and off it in others."""
    rng = np.random.default_rng(seed)
    j2d = np.stack([rng.uniform(40, 300, (24, n)),
                    rng.uniform(10, 230, (24, n))])
    j2d[:, 0, ::2] = np.array([160.0, 120.0])[:, None]
    return {"joints2D": j2d, "joints3D": rng.normal(0, 1, (3, 24, n))}


@pytest.mark.parametrize("ignore_center", [False, True])
def test_sample_time_idx_same_global_draws(ignore_center):
    info = _info()
    got, want = [], []
    for mod, out in ((SC, got), (JSC, want)):
        np.random.seed(3)
        for times in (4, 12):
            out.append(mod.sample_time_idx(info, 40, times,
                                           ignore_center=ignore_center))
        out.append(np.random.randint(0, 1 << 30))  # the state after
    assert got == want
    assert len(got[0]) == 4


def test_filter_and_crop_equal():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 255, (240, 320, 3)).astype(np.uint8)
    mask = (rng.uniform(size=(240, 320, 1)) < 0.6).astype(np.uint8)
    joints = np.concatenate([rng.uniform([60, 40], [260, 200], (18, 2)),
                             rng.normal(0, 0.3, (18, 1))], axis=1)
    box_lt = np.array([[85, 45, 0]], np.int16)
    box_rb = np.array([[235, 195, 0]], np.int16)
    got = SC.crop_and_resize(rgb, mask, joints, box_lt, box_rb, 256)
    want = JSC.crop_and_resize(rgb, mask, joints, box_lt, box_rb, 256)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    kps = np.clip(got[2][:, :2], 0, 255)  # as process_segment clips them
    for m in (got[1], np.zeros_like(got[1])):
        assert SC.filter_incorrect_cases(m, kps) == \
            JSC.filter_incorrect_cases(m, kps)


def test_build_frame_matches_jax(bodies, tmp_path):
    """One segment's frames through both constructors' SMPL forwards: the
    projected joints within 1e-3 px, the depths within 1e-6 m, the crop
    box's integer corners within one pixel."""
    import scipy.io as sio

    from x_as_supervision_tpu_torch.tools import render_campaign as R

    (_, jreg, _), (model, reg, radii) = bodies
    R.write_smpl_assets(str(tmp_path), model, reg, radii)
    surreal = tmp_path / "surreal"
    R.synthesize_segments(str(surreal), model, radii, 1, 6, seed=2)
    info = sio.loadmat(str(surreal / "train" / "run0" / "seq0" /
                           "seg0_info.mat"))
    port = SC.SurrealConstructor(str(tmp_path), str(tmp_path / "p"),
                                 h36m_regressor=reg)
    ref = JSC.SurrealConstructor(str(tmp_path), str(tmp_path / "j"),
                                 h36m_regressor=jreg)
    assert port.device.type == "cpu"
    for t in range(6):
        proj, lt, rb = port.build_frame(info, t)
        jproj, jlt, jrb = ref.build_frame(info, t)
        assert proj.shape == (18, 3) and lt.dtype == np.int16
        np.testing.assert_allclose(proj[:, :2], jproj[:, :2], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(proj[:, 2], jproj[:, 2], rtol=0,
                                   atol=1e-6)
        for a, b in ((lt, jlt), (rb, jrb)):
            assert np.abs(a.astype(int) - b).max() <= 1


def test_constructor_cli_matches_jax(bodies, tmp_path):
    """The standalone constructor CLI (one worker: with more, the segments
    race for numpy's global generator, in both packages) on the same
    segments and seed: the same frames kept, the joints within the campaign
    bounds (a crop may move by one pixel, see checks.CAMPAIGN_BOUNDS)."""
    import sys
    from unittest import mock

    from x_as_supervision_tpu_torch import checks
    from x_as_supervision_tpu_torch.tools import render_campaign as R

    _, (model, reg, radii) = bodies
    smpl = str(tmp_path / "smpl")
    R.write_smpl_assets(smpl, model, reg, radii)
    R.synthesize_segments(str(tmp_path / "surreal"), model, radii, 3, 8,
                          seed=4)
    args = ["--surreal_root", str(tmp_path / "surreal"), "--smpl_root",
            smpl, "--sample_times", "3", "--workers", "1", "--seed", "5"]
    with mock.patch.object(sys, "argv", ["sc", "--out", str(tmp_path / "j")]
                           + args):
        JSC.main()
    with mock.patch.object(sys, "argv", ["sc", "--out", str(tmp_path / "p"),
                                         "--device", "cpu"] + args):
        SC.main()
    want = np.load(tmp_path / "j" / "info.npy")
    got = np.load(tmp_path / "p" / "info.npy")
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0
    b = checks.CAMPAIGN_BOUNDS
    for idx in got:
        rel = f"joints/joint_{idx:06d}.npy"
        j, jj = np.load(tmp_path / "p" / rel), np.load(tmp_path / "j" / rel)
        assert np.abs(j[:, 2] - jj[:, 2]).max() <= b["pseudo_joints"]
        assert np.abs(j[:, :2] - jj[:, :2]).max() <= b["pseudo_moved_xy"]
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with mock.patch.object(sys, "argv", ["sc", "--out",
                                             str(tmp_path / "x")] + args):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                SC.main()
