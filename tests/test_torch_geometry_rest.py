"""The rest of the port's ops/geometry.py against the JAX package's
ops/geometry.py, on the same seeded inputs, fp32: the coordinate grid, the
image <-> patch and world -> image -> patch conversions, the SMPL -> H36M
regression, the pelvis lift and project_smpl_to_patch_kps; and the random
ops' cores fed the JAX package's own draws (the same jax.random.split and
uniform / normal calls as the JAX functions make), so each is held to JAX
draw for draw. Then the torch wrappers' draws: their ranges and branches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import smpl_from_jax
from x_as_supervision_tpu.models import smpl as JS
from x_as_supervision_tpu.ops import geometry as JG
from x_as_supervision_tpu_torch.models import smpl as S
from x_as_supervision_tpu_torch.ops import geometry as G
from torch_parity import few_torch_threads  # noqa: F401 (autouse)


def _rot(rng, b):
    """b random rotations (QR of a normal matrix, det +1)."""
    q, r = np.linalg.qr(rng.normal(size=(b, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def cam_batch(b: int, side: int = 64, seed: int = 0) -> dict:
    """One camera's batch tensors as numpy: NHWC images, an image -> patch
    affine, a camera-frame pelvis about 5 m out, pinhole intrinsics and a
    random rotation with a translation."""
    rng = np.random.default_rng(seed)
    k_mat = np.zeros((b, 3, 3), np.float32)
    k_mat[:, 0, 0] = rng.uniform(900, 1200, b)
    k_mat[:, 1, 1] = rng.uniform(900, 1200, b)
    k_mat[:, 0, 2] = rng.uniform(450, 550, b)
    k_mat[:, 1, 2] = rng.uniform(450, 550, b)
    k_mat[:, 2, 2] = 1.0
    affine = np.zeros((b, 2, 3), np.float32)
    affine[:, 0, 0] = affine[:, 1, 1] = rng.uniform(0.2, 0.3, b)
    affine[:, 0, 1] = rng.uniform(-0.02, 0.02, b)
    affine[:, :, 2] = rng.uniform(-100, 0, (b, 2))
    pelvis = np.stack([rng.uniform(-300, 300, b), rng.uniform(-300, 300, b),
                       rng.uniform(4000, 6000, b)], -1).astype(np.float32)
    return {
        "cam_0_img": np.zeros((b, side, side, 3), np.float32),
        "cam_0_trans_image": affine, "cam_0_pelvis": pelvis,
        "cam_0_k_mat": k_mat, "cam_0_rot_world": _rot(rng, b),
        "cam_0_trans_world": rng.uniform(-500, 500, (b, 3)).astype(
            np.float32),
    }


def _t(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


def _j(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def _args(x):
    return [torch.from_numpy(x[f"cam_0_{k}"]) for k in
            ("trans_image", "pelvis", "k_mat", "trans_world", "rot_world")]


@pytest.mark.parametrize("hw", [(4, 5), (64, 64), (1, 3)])
def test_coordinate_grid_matches_jax(hw):
    got = G.make_coordinate_grid(*hw).numpy()
    # two fp32 steps at 1: the two linspaces round their points apart
    np.testing.assert_allclose(got, np.asarray(JG.make_coordinate_grid(*hw)),
                               rtol=0, atol=2.4e-7)


@pytest.mark.parametrize("is_norm", [True, False])
def test_world_to_patch_chain_matches_jax(is_norm):
    x = cam_batch(4)
    rng = np.random.default_rng(1)
    world = (rng.normal(0, 400, (4, 18, 3))
             + np.asarray(JG.convert_pelvis_to_world(_j(x), "cam_0"))
             ).astype(np.float32)
    want = np.asarray(JG.convert_world_to_patch(jnp.asarray(world), _j(x),
                                                "cam_0", is_norm=is_norm))
    got = G.convert_world_to_patch(torch.from_numpy(world), *_args(x),
                                   image_width=64, image_height=64,
                                   is_norm=is_norm).numpy()
    # fp32 through a rotation, a division by depth and the affine: patch
    # pixels up to ~100, normalized values up to ~3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # and back: patch -> world recovers the points (fp32, ~5 m away)
    back = G.convert_patch_to_world(torch.from_numpy(got), *_args(x),
                                    image_width=64, image_height=64,
                                    is_norm=is_norm).numpy()
    np.testing.assert_allclose(back, world, rtol=0, atol=5e-2)


def test_image_conversions_match_jax():
    x = cam_batch(3, seed=2)
    rng = np.random.default_rng(3)
    kps = rng.uniform(0, 1000, (3, 18, 3)).astype(np.float32)
    kps[..., 2] += 4000
    k = x["cam_0_k_mat"]
    intr = [k[:, 0, [0]], k[:, 1, [1]], k[:, 0, [2]], k[:, 1, [2]]]
    want = JG.convert_world_to_image(
        jnp.asarray(kps), *map(jnp.asarray, intr),
        jnp.asarray(x["cam_0_trans_world"]), jnp.asarray(x["cam_0_rot_world"]))
    got = G.convert_world_to_image(
        torch.from_numpy(kps), *map(torch.from_numpy, intr),
        torch.from_numpy(x["cam_0_trans_world"]),
        torch.from_numpy(x["cam_0_rot_world"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)
    for is_norm in (True, False):
        args = (64, 48, 64, 2000.0 / 64)
        want = JG.convert_image_to_patch(
            jnp.asarray(kps), jnp.asarray(x["cam_0_trans_image"]), *args,
            jnp.asarray(x["cam_0_pelvis"]), is_norm=is_norm)
        got = G.convert_image_to_patch(
            torch.from_numpy(kps), torch.from_numpy(x["cam_0_trans_image"]),
            *args, torch.from_numpy(x["cam_0_pelvis"]), is_norm=is_norm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)


def test_image_side_reads_nhwc_and_nchw():
    for shape in ((2, 48, 64, 3), (2, 3, 48, 64), (2, 48, 64, 1)):
        assert G.image_side(shape) == JG._img_side(shape) == 64
        assert G.image_height(shape) == JG._img_height(shape) == 48


def test_smpl_to_h36m_and_pelvis_match_jax():
    rng = np.random.default_rng(4)
    verts = rng.normal(0, 0.4, (3, 200, 3)).astype(np.float32)
    reg = rng.uniform(0, 1, (17, 200)).astype(np.float32)
    reg /= reg.sum(axis=1, keepdims=True)
    want = JG.smpl_to_h36m(jnp.asarray(verts), jnp.asarray(reg))
    got = G.smpl_to_h36m(torch.from_numpy(verts), torch.from_numpy(reg))
    assert got.shape == (3, 18, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    x = cam_batch(3)
    np.testing.assert_allclose(
        G.convert_pelvis_to_world(_t(x), "cam_0").numpy(),
        np.asarray(JG.convert_pelvis_to_world(_j(x), "cam_0")), rtol=1e-6,
        atol=2e-3)


@pytest.mark.parametrize("convert_verts", [False, True])
def test_project_smpl_to_patch_kps_matches_jax(convert_verts):
    b = 3
    jmodel = JS.random_smpl_model(jax.random.PRNGKey(0))
    model = smpl_from_jax(jmodel)
    reg = np.random.default_rng(1).uniform(0, 1, (17, 128)).astype(
        np.float32)
    pose, beta = JG.rule_transformation(jax.random.PRNGKey(2), b)
    rot = _rot(np.random.default_rng(5), b)
    x = cam_batch(b)
    want = JG.project_smpl_to_patch_kps(
        jnp.asarray(rot), pose[:, 3:], beta,
        lambda p, s: JS.smpl_forward(jmodel, p, s), jnp.asarray(reg), _j(x),
        "cam_0", convert_verts=convert_verts)
    got = G.project_smpl_to_patch_kps(
        torch.from_numpy(rot), torch.from_numpy(np.array(pose[:, 3:])),
        torch.from_numpy(np.array(beta)),
        lambda p, s: S.smpl_forward(model, p, s), torch.from_numpy(reg),
        _t(x), "cam_0", convert_verts=convert_verts)
    assert got.shape == ((b, 128, 3) if convert_verts else (b, 18, 3))
    # world mm about 5 m out (convert_verts), or patch pixels (up to ~100)
    # with depth in mm relative to the pelvis: fp32 through the SMPL chain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-3)


# ------------------------------------------------------------ random ops


def _keys(n, seed=0):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def test_rotation_core_on_jax_draws():
    kps = np.random.default_rng(6).normal(size=(5, 18, 3)).astype(np.float32)
    for key in _keys(3):
        want = JG.random_rotation_3d(key, jnp.asarray(kps))
        u = np.asarray(jax.random.uniform(key, (5,)))
        got = G.rotate_z(torch.from_numpy(kps), torch.from_numpy(u))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6)


def test_flip_core_on_jax_draws():
    kps = np.random.default_rng(7).normal(size=(2, 18, 3)).astype(np.float32)
    branches = set()
    for key in _keys(8, seed=1):
        u = float(jax.random.uniform(key, ()))
        branches.add(u < 0.5)
        want = JG.flip_3d(key, jnp.asarray(kps))
        got = G.flip_3d_from(torch.from_numpy(kps), torch.tensor(u))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert branches == {True, False}  # both legs and arms were taken


def _tn_draws(key, size):
    k_ig, k_sign, k_n = jax.random.split(key, 3)
    return (torch.tensor(float(jax.random.uniform(k_ig, ()))),
            torch.tensor(float(jax.random.uniform(k_sign, ()))),
            torch.from_numpy(np.array(jax.random.normal(k_n, size))))


@pytest.mark.parametrize("pos,neg,mean,ignore", [
    (0.5, 0.2, 0.0, 0.4), (0.3, 0.3, 0.1, 0.0), (0.0, 0.7, 0.0, 0.4),
    (1.5, 1.5, 0.0, 0.0)])
def test_truncated_normal_core_on_jax_draws(pos, neg, mean, ignore):
    for key in _keys(12, seed=2):
        want = JG.my_truncated_normal(key, pos, neg, size=(6, 4),
                                      ignore=ignore, mean=mean)
        got = G.truncated_normal_from(pos, neg, mean, ignore,
                                      *_tn_draws(key, (6, 4)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7)


def jax_rule_draws(key, batch: int) -> dict:
    """The draws JAX's rule_transformation makes from `key`, in the layout
    of the port's rule_draws."""
    n = len(JG.RULE_RANGES) + 1
    keys = jax.random.split(key, n)
    draws = [_tn_draws(k, (batch,)) for k in keys[:-1]]
    beta = _tn_draws(keys[-1], (batch, 10))
    return dict(
        u_ignore=torch.stack([d[0] for d in draws] + [beta[0]]),
        u_sign=torch.stack([d[1] for d in draws] + [beta[1]]),
        normal=torch.stack([d[2] for d in draws]),
        beta_normal=beta[2])


@pytest.mark.parametrize("gen_negative", [False, True])
def test_rule_transformation_core_on_jax_draws(gen_negative):
    key = jax.random.PRNGKey(3)
    want_pose, want_beta = JG.rule_transformation(key, 5, gen_negative)
    pose, beta = G.rule_transformation_from(jax_rule_draws(key, 5),
                                            gen_negative)
    assert G.RULE_RANGES == JG.RULE_RANGES
    assert G.RULE_RANGES_NEGATIVE == JG.RULE_RANGES_NEGATIVE
    np.testing.assert_allclose(pose.numpy(), np.asarray(want_pose), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(beta.numpy(), np.asarray(want_beta), rtol=0,
                               atol=1e-6)


def test_wrappers_draw_in_range():
    gen = torch.Generator().manual_seed(0)
    # rotation: each pose turned by an angle in [-pi/4, pi/4] about z
    kps = torch.zeros(4000, 1, 3)
    kps[..., 0] = 1.0
    rot = G.random_rotation_3d(kps, gen)
    angle = torch.atan2(-rot[:, 0, 1], rot[:, 0, 0])
    assert angle.abs().max() <= np.pi / 4 + 1e-6
    assert angle.min() < -0.7 and angle.max() > 0.7  # the range is covered
    torch.testing.assert_close(rot[:, 0, 2], torch.zeros(4000))
    # flip: legs or arms, both over a few draws
    joints = torch.arange(18.0).view(1, 18, 1)
    flips = {tuple(G.flip_3d(joints, gen).flatten().int().tolist())
             for _ in range(16)}
    legs = tuple(G._FLIP_LEGS)
    arms = tuple(G._FLIP_ARMS)
    assert flips == {legs, arms}
    # truncated normal: the ignore share, clipping at the width, the sign
    outs = torch.stack([G.my_truncated_normal(0.5, 0.2, (64,), 0.4,
                                              generator=gen)
                        for _ in range(2000)])
    ignored = (outs == 0).all(dim=1).float().mean().item()
    assert 0.36 < ignored < 0.44
    kept = outs[(outs != 0).any(dim=1)]
    assert kept.max() <= 0.5 and kept.min() >= -0.2
    # each draw takes one branch: all of a sample has one sign
    assert ((kept >= 0).all(dim=1) | (kept <= 0).all(dim=1)).all()
    assert (kept.abs() == 0.5).any()  # clipped at the positive width
    # the branch whose width equals the mean gives 0
    deg = torch.stack([G.my_truncated_normal(0.0, 0.3, (8,), 0.0,
                                             generator=gen)
                       for _ in range(200)])
    assert (deg >= -0.3).all() and (deg <= 0).all()
    assert ((deg == 0).all(dim=1)).float().mean() > 0.3
    # the prior: pose (B, 72), betas (B, 10) within 1.5; zero channels
    pose, beta = G.rule_transformation(16, gen)
    assert pose.shape == (16, 72) and beta.shape == (16, 10)
    assert beta.abs().max() <= 1.5
    assert (pose[:, 21:45] == 0).all()  # the (0, 0) ranges
