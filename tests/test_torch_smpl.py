"""The port's SMPL body model (x_as_supervision_tpu_torch/models/smpl.py)
against the JAX package's models/smpl.py on the JAX package's seeded random
model carried across as arrays, fp32: batch_rodrigues, smpl_forward at
V = 128 and at SMPL's own V = 6890, the npz loader; and the port's
counterpart of the JAX package's tests/test_smpl_chain.py (rule prior ->
SMPL -> H36M -> world -> patch), held to JAX's values from JAX's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_geometry_rest import _j, _t, cam_batch, jax_rule_draws
from torch_parity import smpl_from_jax
from x_as_supervision_tpu.models import smpl as JS
from x_as_supervision_tpu.ops import geometry as JG
from x_as_supervision_tpu_torch.models import smpl as S
from x_as_supervision_tpu_torch.ops import geometry as G
from torch_parity import few_torch_threads  # noqa: F401 (autouse)


def test_rodrigues_matches_jax():
    rng = np.random.default_rng(0)
    aa = rng.normal(0, 1.2, (4, 24, 3)).astype(np.float32)
    aa[0, 0] = 0.0  # the zero rotation: the 1e-8 regularization
    got = S.batch_rodrigues(torch.from_numpy(aa)).numpy()
    np.testing.assert_allclose(got, np.asarray(JS.batch_rodrigues(
        jnp.asarray(aa))), rtol=0, atol=1e-6)
    # rotations: orthonormal with det +1
    eye = np.broadcast_to(np.eye(3), got.shape)
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2), eye,
                               atol=2e-6)


@pytest.mark.parametrize("num_verts,center,trans", [
    (128, 0, False), (128, None, True), (6890, 0, False)])
def test_smpl_forward_matches_jax(num_verts, center, trans):
    jmodel = JS.random_smpl_model(jax.random.PRNGKey(1), num_verts)
    model = smpl_from_jax(jmodel)
    rng = np.random.default_rng(2)
    b = 3
    pose = rng.normal(0, 0.4, (b, 72)).astype(np.float32)
    betas = rng.normal(0, 1.0, (b, 10)).astype(np.float32)
    tr = rng.normal(0, 1.0, (b, 3)).astype(np.float32) if trans else None
    jv, jj = JS.smpl_forward(jmodel, jnp.asarray(pose), jnp.asarray(betas),
                             None if tr is None else jnp.asarray(tr),
                             center_idx=center)
    v, j = S.smpl_forward(model, torch.from_numpy(pose),
                          torch.from_numpy(betas),
                          None if tr is None else torch.from_numpy(tr),
                          center_idx=center)
    assert v.shape == (b, num_verts, 3) and j.shape == (b, 24, 3)
    # metres, up to ~2: fp32 through 23 composed transforms and the skinning
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=2e-6)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=0, atol=2e-6)


def test_mean_betas_when_none():
    model = S.random_smpl_model(seed=3)
    pose = torch.zeros(2, 72)
    v0, _ = S.smpl_forward(model, pose)
    v1, _ = S.smpl_forward(model, pose, torch.zeros(2, 10))
    torch.testing.assert_close(v0, v1, rtol=0, atol=0)


def test_load_smpl_npz(tmp_path):
    jmodel = JS.random_smpl_model(jax.random.PRNGKey(4))
    arrays = {k: np.asarray(v) for k, v in jmodel._asdict().items()}
    arrays["kintree_parents"] = np.asarray(arrays["kintree_parents"])
    np.savez(tmp_path / "smpl_neutral.npz", **arrays)
    want = JS.load_smpl_npz(str(tmp_path / "smpl_neutral.npz"))
    got = S.load_smpl_npz(str(tmp_path / "smpl_neutral.npz"))
    assert got.kintree_parents == want.kintree_parents
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor",
                 "weights", "betas_mean"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.faces, want.faces)
    # an npz without betas_mean: zeros, as JAX's
    del arrays["betas_mean"]
    np.savez(tmp_path / "no_mean.npz", **arrays)
    assert not S.load_smpl_npz(str(tmp_path / "no_mean.npz")).betas_mean.any()


def test_random_model_is_seeded_and_valid():
    a, b = S.random_smpl_model(5), S.random_smpl_model(5)
    torch.testing.assert_close(a.posedirs, b.posedirs, rtol=0, atol=0)
    assert not torch.equal(a.v_template, S.random_smpl_model(6).v_template)
    torch.testing.assert_close(a.weights.sum(-1), torch.ones(128))
    assert a.kintree_parents == JS.random_smpl_model(
        jax.random.PRNGKey(0)).kintree_parents


def test_rule_prior_through_smpl_to_patch_matches_jax():
    """tests/test_smpl_chain.py of the JAX package, on the port, held to
    JAX's values: the draws are JAX's own."""
    b = 2
    jmodel = JS.random_smpl_model(jax.random.PRNGKey(0))
    model = smpl_from_jax(jmodel)
    reg = np.random.default_rng(1).uniform(0, 1, (17, 128)).astype(
        np.float32)
    key = jax.random.PRNGKey(2)
    jpose, jbeta = JG.rule_transformation(key, b)
    pose, beta = G.rule_transformation_from(jax_rule_draws(key, b))
    x = cam_batch(b)
    jrot = jnp.tile(jnp.eye(3), (b, 1, 1))
    rot = torch.eye(3).expand(b, 3, 3)
    for convert_verts in (False, True):
        want = JG.project_smpl_to_patch_kps(
            jrot, jpose[:, 3:], jbeta,
            lambda p, s: JS.smpl_forward(jmodel, p, s), jnp.asarray(reg),
            _j(x), "cam_0", convert_verts=convert_verts)
        got = G.project_smpl_to_patch_kps(
            rot, pose[:, 3:], beta, lambda p, s: S.smpl_forward(model, p, s),
            torch.from_numpy(reg), _t(x), "cam_0",
            convert_verts=convert_verts)
        assert got.shape == ((b, 128, 3) if convert_verts else (b, 18, 3))
        assert torch.isfinite(got).all()
        # patch pixels and depth in mm, or world mm ~5 m out; fp32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=2e-3)


def test_load_smpl_assets_as_the_jax_factory(tmp_path):
    from x_as_supervision_tpu.train.factory import (
        load_smpl_assets as jax_assets,
    )
    from x_as_supervision_tpu_torch.train.factory import load_smpl_assets

    cfg = {"model_params": {}}
    assert load_smpl_assets(cfg) == jax_assets(cfg) == (None, None)
    cfg["model_params"]["smpl_layer_params"] = {"model_path": str(tmp_path)}
    assert load_smpl_assets(cfg) == (None, None)  # the files are absent
    jmodel = JS.random_smpl_model(jax.random.PRNGKey(5))
    np.savez(tmp_path / "smpl_neutral.npz",
             **{k: np.asarray(v) for k, v in jmodel._asdict().items()})
    reg = np.random.default_rng(6).uniform(0, 1, (17, 128))
    np.save(tmp_path / "J_regressor_h36m.npy", reg)
    model, regressor = load_smpl_assets(cfg)
    jm, jreg = jax_assets(cfg)
    np.testing.assert_array_equal(regressor.numpy(), np.asarray(jreg))
    assert regressor.dtype == torch.float32
    np.testing.assert_array_equal(model.posedirs.numpy(),
                                  np.asarray(jm.posedirs))
