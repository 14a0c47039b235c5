"""The port's real datasets (x_as_supervision_tpu_torch/data/: the index
builders, the patch pipeline, the dataset classes and the factory) against
the JAX package's, on the CPU, on miniature on-disk datasets in the real
layouts (x_as_supervision_tpu_torch/checks.py writes them).

Both packages read the same files with the same numpy and cv2 calls, so
every comparison is exact (np.array_equal, dtypes equal). Image paths are
compared relative to their tree: each package builds its index, and so its
cache, in a tree of its own.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")
pytest.importorskip("scipy.io")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import fixture_helpers as FH  # noqa: E402

from x_as_supervision_tpu.data import factory as JF  # noqa: E402
from x_as_supervision_tpu.data import hm36 as JH  # noqa: E402
from x_as_supervision_tpu.data import mpi_inf_3dhp as JM  # noqa: E402
from x_as_supervision_tpu_torch import checks  # noqa: E402
from x_as_supervision_tpu_torch.data import factory as PF  # noqa: E402
from x_as_supervision_tpu_torch.data import hm36 as PH  # noqa: E402
from x_as_supervision_tpu_torch.data import imdb as PI  # noqa: E402
from x_as_supervision_tpu_torch.data import mpi_inf_3dhp as PM  # noqa: E402
from x_as_supervision_tpu_torch.models.composed import (  # noqa: E402
    preprocess_batch,
)
from x_as_supervision_tpu_torch.train.factory import (  # noqa: E402
    build_gan_spec,
    flagship_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 160
FRAMES = 8
PATCH = 64
BATCH = 4
AUG_ON = {"scale_factor": 0.25, "rot_factor": 30, "color_factor": 0.2,
          "do_flip_aug": True, "rot_aug_rate": 0.6, "flip_aug_rate": 0.5}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two identical trees, "jax" and "port": the JAX package's writer and
    the port's write the mini H36M; the port writes both pseudo streams and
    the mini MPI-INF-3DHP, copied into the other tree."""
    out = {}
    for side in ("jax", "port"):
        out[side] = str(tmp_path_factory.mktemp(f"tree_{side}"))
    FH.make_mini_h36m(out["jax"], img_size=IMG, n_frames=FRAMES, seed=0)
    checks.write_mini_h36m(out["port"], img_size=IMG, n_frames=FRAMES,
                           seed=0)
    root = out["port"]
    checks.write_surreal_pseudo(os.path.join(root, "surreal_h36m_pose"), 12,
                                seed=1)
    checks.write_surreal_pseudo(os.path.join(root, "smpl_pseudo_img"), 3,
                                seed=2, fmt="no_texture")
    checks.write_mini_mpi(root, img_size=256, n_frames=1, seed=4)
    for sub in ("surreal_h36m_pose", "smpl_pseudo_img", "mpi_inf_3dhp",
                os.path.join("sam_masks", "mpi_inf_3dhp")):
        shutil.copytree(os.path.join(root, sub),
                        os.path.join(out["jax"], sub))
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_fixture_writers_write_the_same_files(trees):
    names = _files(os.path.join(trees["jax"], "hm36"))
    assert names == _files(os.path.join(trees["port"], "hm36"))
    assert len(names) == 4 * (1 + FRAMES)
    for rel in names + _files(os.path.join(trees["jax"], "sam_masks")):
        for sub in ("hm36", "sam_masks"):
            a = os.path.join(trees["jax"], sub, rel)
            if os.path.exists(a):
                with open(a, "rb") as fa, open(os.path.join(
                        trees["port"], sub, rel), "rb") as fb:
                    assert fa.read() == fb.read(), rel


def _same(a, b, roots, where=""):
    """Exact equality of two records, samples or batches (nested dicts,
    lists, arrays, numbers); strings that are paths of the two trees are
    compared relative to them."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], roots, f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, roots, f"{where}[{i}]")
    elif isinstance(a, str):
        assert a.replace(roots[0], "<root>") == b.replace(roots[1],
                                                          "<root>"), where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where


def _drop_cache(imdb):
    shutil.rmtree(imdb.cache_path)


def test_hm36_mini_gt_db(trees):
    args = ("mini", None, PATCH, PATCH, 2000, 2000, "")
    dbs = []
    for mod, side in ((JH, "jax"), (PH, "port")):
        imdb = mod.hm36(args[0], os.path.join(trees[side], "hm36"), *args[2:])
        _drop_cache(imdb)
        dbs.append(imdb.gt_db())
    assert len(dbs[0]) == FRAMES
    _same(dbs[0], dbs[1], (trees["jax"], trees["port"]))
    # the records keep the cached schema, attribute access included
    smp = dbs[1][0]["cam_0"]
    assert type(smp).__module__ == "x_as_supervision_tpu_torch.data.samples"
    assert smp.image == smp["image"] and smp.joints_3d.shape == (18, 3)


@pytest.fixture(scope="module")
def valid_trees(tmp_path_factory):
    """Meta files only, every folder of subjects 9 and 11 (the ``valid``
    policy's), 50 frames each, one tree per package."""
    out = {}
    for side in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(f"valid_{side}"))
        checks.write_mini_h36m(root, img_size=IMG, n_frames=50, seed=5,
                               folders=JH.all_folders([5, 6]), images=False)
        out[side] = root
    return out


@pytest.mark.parametrize("policy", ["valid", "train_selected"])
@pytest.mark.parametrize("seed", [0, 11])
def test_hm36_sampled_policies_draw_the_same_frames(valid_trees, seed,
                                                    policy, monkeypatch):
    """``valid`` and ``train_selected`` draw np.random.choice from the global
    state: the same seed gives the same frames in both packages, and leaves
    the state at the same point. ``train_selected`` (its actions dropped)
    reads subjects 9 and 11 here."""
    for mod in (JH, PH):
        if policy == "train_selected":
            monkeypatch.setitem(mod.SUBSET_POLICIES, policy,
                                mod.SUBSET_POLICIES[policy][:4] + ([5, 6],))
    dbs, nexts = [], []
    for mod, side in ((JH, "jax"), (PH, "port")):
        imdb = mod.hm36(policy, os.path.join(valid_trees[side], "hm36"),
                        PATCH, PATCH, 2000, 2000, "")
        _drop_cache(imdb)
        np.random.seed(seed)
        dbs.append(imdb.gt_db())
        nexts.append(np.random.random())
    assert nexts[0] == nexts[1]
    # valid: 40 of 50 frames in each of 60 folders; train_selected: all 50
    # (200 asked), the 4 dropped actions' 16 folders left out
    want = 40 * 60 if policy == "valid" else 50 * (60 - 16)
    assert len(dbs[0]) == want
    _same(dbs[0], dbs[1], (valid_trees["jax"], valid_trees["port"]))


def test_mpi_gt_db(trees):
    dbs = []
    for mod, side in ((JM, "jax"), (PM, "port")):
        imdb = mod.mpi_inf_3dhp("valid", os.path.join(trees[side],
                                                      "mpi_inf_3dhp"),
                                PATCH, PATCH, 2000, 2000, "")
        _drop_cache(imdb)
        dbs.append(imdb.gt_db())
    assert len(dbs[0]) == 2 * 2  # subjects x sequences x frames
    assert sorted(dbs[0][0]) == [f"cam_{v}" for v in (0, 2, 4, 7, 8)]
    _same(dbs[0], dbs[1], (trees["jax"], trees["port"]))


def test_mpi_filters_drop_the_same_frames(tmp_path):
    """The chair-occlusion and over-exposure filters drop a frame (for all
    its cameras) in both packages: one chair mask blacked out, one exposure
    mask all red."""
    root = str(tmp_path / "port")
    mpi = checks.write_mini_mpi(root, img_size=256, n_frames=3, seed=9)
    name = "frame_%06d.jpg"
    chair = os.path.join(mpi, "S7", "Seq1", "chair_masks", "video_4",
                         name % 2)
    cv2.imwrite(chair, np.zeros((256, 256, 3), np.uint8))
    exposure = os.path.join(mpi, "S8", "Seq2", "masks", "video_0", name % 3)
    red = np.zeros((256, 256, 3), np.uint8)
    red[..., 2] = 255
    cv2.imwrite(exposure, red)
    shutil.copytree(root, str(tmp_path / "jax"))
    dbs = []
    for mod, side in ((JM, "jax"), (PM, "port")):
        dbs.append(mod.mpi_inf_3dhp(
            "valid", str(tmp_path / side / "mpi_inf_3dhp"), PATCH, PATCH,
            2000, 2000, "").gt_db())
    assert len(dbs[0]) == 2 * 2 * 3 - 2
    kept = {os.path.relpath(r["cam_0"]["image"], str(tmp_path / "port"))
            for r in dbs[1]}
    assert os.path.relpath(chair, root).replace(
        "chair_masks", "images").replace("video_4", "video_0") not in kept
    _same(dbs[0], dbs[1], (str(tmp_path / "jax"), root))


def test_mpi_remap_to_hm36(trees):
    """from_mpi_inf_3dhp_to_hm36: 28 -> 18 joints in place, and the cameras
    renumbered for the mixed dataset."""
    dbs = []
    for mod, side in ((JM, "jax"), (PM, "port")):
        db = mod.mpi_inf_3dhp("valid", os.path.join(trees[side],
                                                    "mpi_inf_3dhp"),
                              PATCH, PATCH, 2000, 2000, "").gt_db()
        mod.from_mpi_inf_3dhp_to_hm36(db, use_hm_video_list=True)
        dbs.append(db)
    assert sorted(dbs[1][0]) == ["cam_0", "cam_1", "cam_2", "cam_3"]
    assert dbs[1][0]["cam_1"].joints_3d.shape == (18, 3)
    _same(dbs[0], dbs[1], (trees["jax"], trees["port"]))


# ------------------------------------------------------ samples and batches


def _config(root, name="hm36", pseudo="surreal_h36m_pose", **dataset_params):
    dp = checks.hm36_dataset_params(root)
    dp["cam_id_list"] = [0, 1]
    if pseudo is None:
        dp["smpl_pseudo_img"] = None
    else:
        dp["smpl_pseudo_img"]["data_path"] = os.path.join(root, pseudo)
    if name == "mpi_inf_3dhp":
        dp["dataset"] = {"name": name,
                         "path": os.path.join(root, "mpi_inf_3dhp"),
                         "train_image_set": "valid",
                         "test_image_set": "valid"}
        dp["cam_id_list"] = [0, 2, 4, 7, 8]
    elif name == "mpi_inf_3dhp+hm36":
        dp["dataset"] = {
            "name": name,
            "mpi_inf_3dhp": {"path": os.path.join(root, "mpi_inf_3dhp"),
                             "train_image_set": "valid"},
            "hm36": dict(dp["dataset"])}
        dp["cam_id_list"] = [0, 1, 2, 3]
    dp.update(dataset_params)
    return {
        "dataset_params": dp,
        "train_params": {"patch_width": PATCH, "patch_height": PATCH,
                         "rect_3d_width": 2000, "rect_3d_height": 2000,
                         "batch_size": BATCH, "aug": dict(checks.NO_AUG)},
        "model_params": {"loss_config": {
            "recons_loss": {"use_dis_map": False, "weight": 0.02},
            "physique_recons_loss": {"use_dis_map": False, "weight": 0.02}}},
    }


CASES = {
    # name: (config overrides, train_params.aug, eval_only, seed)
    "hm36_train": (dict(), None, False, 0),
    "hm36_train_aug": (dict(), AUG_ON, False, 3),
    "hm36_train_aug_no_rm_bg": (dict(rm_bg=False), AUG_ON, False, 5),
    "hm36_train_no_texture": (dict(pseudo="smpl_pseudo_img"), None, False,
                              1),
    "hm36_train_unmasked_pseudo": (dict(pseudo_mask=False), None, False, 2),
    "hm36_train_uint8": (dict(uint8_feed=True), None, False, 0),
    "hm36_train_geodesic_joints": (
        dict(compute_geodesic=True, geodesic_pt_list=[0, 7]), AUG_ON, False,
        4),
    "hm36_train_geodesic_centroid": (
        dict(compute_geodesic=True, geodesic_pt_list=[]), None, False, 0),
    "hm36_eval": (dict(), None, True, 0),
    "mpi_eval": (dict(name="mpi_inf_3dhp"), None, True, 0),
    # no flip: the MPI records keep MPI_FLIP_PAIRS (28 joints) after the
    # 28 -> 18 remap, so a flip indexes past the joints in both packages
    "mpi_train": (dict(name="mpi_inf_3dhp", compute_geodesic=True),
                  dict(AUG_ON, do_flip_aug=False), False, 6),
    "mix_train": (dict(name="mpi_inf_3dhp+hm36"), None, False, 7),
}


def _datasets(trees, case):
    over, aug, eval_only, seed = CASES[case]
    over = dict(over)
    name = over.pop("name", "hm36")
    pseudo = over.pop("pseudo", "surreal_h36m_pose")
    pseudo_mask = over.pop("pseudo_mask", True)
    out = []
    for fac, side in ((JF, "jax"), (PF, "port")):
        cfg = _config(trees[side], name, pseudo, **over)
        if cfg["dataset_params"]["smpl_pseudo_img"]:
            cfg["dataset_params"]["smpl_pseudo_img"]["use_mask"] = pseudo_mask
        if aug is not None:
            cfg["train_params"]["aug"] = dict(aug)
        out.append(fac.basic_data(cfg, eval_only=eval_only, seed=seed))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_samples_and_batches_equal(trees, case):
    jds, pds = _datasets(trees, case)
    roots = (trees["jax"], trees["port"])
    assert type(pds).__name__ == type(jds).__name__
    assert len(pds) == len(jds) and len(pds) % BATCH == 0
    for i in range(len(pds)):
        _same(jds.sample(i), pds.sample(i), roots, f"sample {i}")
    for start in (0, BATCH + 1):
        _same(jds.batch(start, BATCH), pds.batch(start, BATCH), roots,
              f"batch {start}")
        _same(jds.device_batch(start, BATCH), pds.device_batch(start, BATCH),
              roots)
    _same(jds.batch_from_indices([2, 0, 1]), pds.batch_from_indices([2, 0, 1]),
          roots)
    item = pds.sample(0)
    uint8 = CASES[case][0].get("uint8_feed", False)
    assert item["cam_0_img"].dtype == (np.uint8 if uint8 else np.float32)
    assert ("cam_0_pseudo_img" in item) == (not CASES[case][2])
    assert ("cam_0_geodesic_dis" in item) == bool(
        CASES[case][0].get("compute_geodesic"))


def test_mixed_dataset_over_two_epochs(trees):
    """The H36M half of the mix is reshuffled per epoch (set_epoch), the same
    way in both packages, and the loader sets the epoch."""
    from x_as_supervision_tpu.data.loader import BatchLoader as JL
    from x_as_supervision_tpu_torch.data.loader import BatchLoader as PL

    jds, pds = _datasets(trees, "mix_train")
    roots = (trees["jax"], trees["port"])
    orders = []
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        for i in range(len(pds)):
            _same(jds.sample(i), pds.sample(i), roots, f"{epoch}/{i}")
        orders.append([pds._select(i)["cam_0"]["image"]
                       for i in range(len(pds))])
    half = len(pds) // 2
    assert orders[0][:half] == orders[1][:half]
    assert orders[0][half:] != orders[1][half:]
    got = {}
    for loader, ds, side in ((JL, jds, "jax"), (PL, pds, "port")):
        ld = loader(ds, batch_size=BATCH, shuffle=True, num_workers=2,
                    prefetch=1, seed=3)
        got[side] = [b for e in (0, 1) for b in ld.epoch(e)]
    assert len(got["port"]) == 2 * (len(pds) // BATCH)
    _same(got["jax"], got["port"], roots)


def test_uint8_feed_preprocessed_equals_the_float_feed(trees):
    """The uint8 batch, normalized by the port's preprocess_batch (the
    trainer's and evaluator's feed), equals the float batch exactly, as the
    JAX package's tests/test_uint8_feed.py holds its own."""
    cfg_f = _config(trees["port"], compute_geodesic=True,
                    geodesic_pt_list=[0])
    cfg_u = _config(trees["port"], uint8_feed=True, compute_geodesic=True,
                    geodesic_pt_list=[0])
    bf = PF.basic_data(cfg_f, seed=3).device_batch(0, BATCH)
    bu = PF.basic_data(cfg_u, seed=3).device_batch(0, BATCH)
    cfg = flagship_config(tiny=True)
    cfg["dataset_params"] = cfg_u["dataset_params"]
    pre = preprocess_batch({k: torch.as_tensor(v) for k, v in bu.items()},
                           build_gan_spec(cfg))
    for ck in ("cam_0", "cam_1"):
        assert bu[f"{ck}_img"].dtype == np.uint8
        assert bu[f"{ck}_mask"].dtype == np.uint8
        assert bu[f"{ck}_pseudo_img"].dtype == np.uint8
        for suffix in ("img", "mask", "pseudo_img", "joints",
                       "geodesic_dis"):
            np.testing.assert_array_equal(pre[f"{ck}_{suffix}"].numpy(),
                                          bf[f"{ck}_{suffix}"],
                                          err_msg=f"{ck}_{suffix}")


# ------------------------------------------------------------------ factory


def test_registries_match_the_jax_package():
    assert set(PF.IMDB_REGISTRY) == set(JF.IMDB_REGISTRY)
    assert "mpii" in PF.IMDB_REGISTRY
    for name, cls in PF.IMDB_REGISTRY.items():
        assert cls.__name__ == JF.IMDB_REGISTRY[name].__name__
    assert set(PF.DATASET_REGISTRY) == set(JF.DATASET_REGISTRY)
    for name, cls in PF.DATASET_REGISTRY.items():
        assert cls.__name__ == JF.DATASET_REGISTRY[name].__name__
    assert PH.SUBSET_POLICIES == JH.SUBSET_POLICIES
    assert PM.SUBSET_POLICIES == JM.SUBSET_POLICIES
    assert PH.TRAIN_SELECTED_DROP == JH.TRAIN_SELECTED_DROP


def test_mpii_is_not_ported(trees):
    """Both packages' basic_data refuse mpii: MPII is read only by the 2D
    eval CLI (the JAX package's raises a TypeError, its mpii taking no
    init_mode)."""
    for fac, side, err in ((JF, "jax", TypeError), (PF, "port", ValueError)):
        cfg = _config(trees[side])
        cfg["dataset_params"]["dataset"]["name"] = "mpii"
        for eval_only in (False, True):
            with pytest.raises(err):
                fac.basic_data(cfg, eval_only=eval_only)
    with pytest.raises(ValueError, match="eval2d"):
        PF.basic_data(cfg)


GATES = {
    # name: (loss_config overrides, eval_only, dataset_params overrides)
    "s1_weight_zero": ({"recons_loss": {"use_dis_map": True, "weight": 0.0},
                        "physique_recons_loss": {"use_dis_map": True,
                                                 "weight": 0.0}}, False, {}),
    "dis_map_weighted": ({"recons_loss": {"use_dis_map": True,
                                          "weight": 0.02}}, False, {}),
    "physique_dis_map": ({"physique_recons_loss": {"use_dis_map": True,
                                                   "weight": 0.02}}, False,
                         {}),
    "eval_never": ({"recons_loss": {"use_dis_map": True, "weight": 0.02}},
                   True, {}),
    "override_on": ({"recons_loss": {"use_dis_map": True, "weight": 0.0}},
                    False, {"compute_geodesic": True}),
    "override_off": ({"recons_loss": {"use_dis_map": True, "weight": 0.02}},
                     False, {"compute_geodesic": False}),
    "uint8_feed": ({}, False, {"uint8_feed": True}),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_factory_gates_match_the_jax_package(trees, gate):
    """need_geodesic / compute_geodesic and uint8_feed, as basic_data derives
    them (data/factory.py:74-86)."""
    losses, eval_only, over = GATES[gate]
    got = []
    for fac, side in ((JF, "jax"), (PF, "port")):
        cfg = _config(trees[side], **over)
        cfg["model_params"]["loss_config"].update(losses)
        ds = fac.basic_data(cfg, eval_only=eval_only, seed=0)
        got.append((ds.compute_geodesic, ds.uint8_feed, ds.is_train,
                    ds.use_smpl_pseudo_img, ds.rm_bg, ds.cam_id_list,
                    ds.geodesic_param_list, len(ds)))
    assert got[0] == got[1]


# ------------------------------------------------------------------- caches


def test_a_jax_written_cache_is_read_without_the_jax_package(tmp_path):
    """The JAX package writes the index cache; the port reads it in a
    process that never imports x_as_supervision_tpu, into its own
    PatchSample, equal record by record."""
    root = str(tmp_path / "tree")
    checks.write_mini_h36m(root, img_size=IMG, n_frames=3, seed=8,
                           images=False)
    path = os.path.join(root, "hm36")
    want = JH.hm36("mini", path, PATCH, PATCH, 2000, 2000, "").gt_db()
    dump = str(tmp_path / "port.pkl")
    code = (
        "import pickle, sys\n"
        "from x_as_supervision_tpu_torch.data.hm36 import hm36\n"
        f"db = hm36('mini', {path!r}, {PATCH}, {PATCH}, 2000, 2000, '')"
        ".gt_db()\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'x_as_supervision_tpu')]\n"
        "assert not bad, bad\n"
        "assert type(db[0]['cam_0']).__module__ == "
        "'x_as_supervision_tpu_torch.data.samples'\n"
        f"pickle.dump([{{c: dict(r) for c, r in s.items()}} for s in db], "
        f"open({dump!r}, 'wb'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "gt db loaded from" in res.stdout
    with open(dump, "rb") as f:
        got = pickle.load(f)
    _same([{c: dict(r) for c, r in s.items()} for s in want], got,
          (root, root))


def test_the_jax_package_reads_a_cache_the_port_wrote(tmp_path):
    """Both packages write the same cache bytes for the same tree; the JAX
    package reads the port's cache in a process that never imports the
    port or torch, into its own PatchSample, equal record by record."""
    root = str(tmp_path / "tree")
    checks.write_mini_h36m(root, img_size=IMG, n_frames=3, seed=8,
                           images=False)
    path = os.path.join(root, "hm36")
    raw, dbs = {}, {}
    # the port writes last: its cache is the one the JAX package reads
    for side, mod in (("jax", JH), ("port", PH)):
        imdb = mod.hm36("mini", path, PATCH, PATCH, 2000, 2000, "")
        _drop_cache(imdb)
        dbs[side] = imdb.gt_db()
        (name,) = os.listdir(imdb.cache_path)
        with open(os.path.join(imdb.cache_path, name), "rb") as f:
            raw[side] = f.read()
    assert raw["port"] == raw["jax"]
    want = dbs["jax"]
    dump = str(tmp_path / "jax.pkl")
    code = (
        "import pickle, sys\n"
        "from x_as_supervision_tpu.data.hm36 import hm36\n"
        f"db = hm36('mini', {path!r}, {PATCH}, {PATCH}, 2000, 2000, '')"
        ".gt_db()\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('torch', 'x_as_supervision_tpu_torch')]\n"
        "assert not bad, bad\n"
        "assert type(db[0]['cam_0']).__module__ == "
        "'x_as_supervision_tpu.data.samples'\n"
        f"pickle.dump([{{c: dict(r) for c, r in s.items()}} for s in db], "
        f"open({dump!r}, 'wb'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "gt db loaded from" in res.stdout
    with open(dump, "rb") as f:
        got = pickle.load(f)
    _same([{c: dict(r) for c, r in s.items()} for s in want], got,
          (root, root))


def test_the_cache_reader_refuses_other_classes(tmp_path):
    """Only PatchSample records are mapped; another class of either package
    is refused, not imported. The port's own records round-trip, whether
    the cache names the JAX package's class (as save_cache writes it) or
    the port's (a plain pickle.dump)."""
    path = str(tmp_path / "db.pkl")
    db = [{"cam_0": PI.PatchSample(image="a.jpg", rot=0)}]
    PI.save_cache(path, db)
    back = PI.load_cache(path)
    assert back == db and type(back[0]["cam_0"]) is PI.PatchSample
    with open(path, "rb") as f:
        raw = f.read()
    mod = b"x_as_supervision_tpu.data.samples"
    assert mod in raw and b"x_as_supervision_tpu_torch" not in raw
    # names of the same length keep the pickle well formed
    for old, new in ((b"PatchSample", b"PatchSampl2"),
                     (mod, b"x_as_supervision_tpu.data.sampleX")):
        assert len(old) == len(new)
        with open(path, "wb") as f:
            f.write(raw.replace(old, new))
        with pytest.raises(pickle.UnpicklingError, match="only PatchSample"):
            PI.load_cache(path)
    with open(path, "wb") as f:
        pickle.dump(db, f, pickle.HIGHEST_PROTOCOL)
    with open(path, "rb") as f:
        assert b"x_as_supervision_tpu_torch.data.samples" in f.read()
    back = PI.load_cache(path)
    assert back == db and type(back[0]["cam_0"]) is PI.PatchSample


# --------------------------------------------------------------------- CLIs


def test_hm36_dataset_params_match_the_shipped_config(tmp_path):
    with open(os.path.join(REPO, "config", "HM36_Multi_SurS2.yaml")) as f:
        want = yaml.safe_load(f)
    dp = want["dataset_params"]
    root = str(tmp_path)
    dp["dataset"].update(path=os.path.join(root, "hm36"),
                         train_image_set="mini", test_image_set="mini")
    dp["smpl_pseudo_img"]["data_path"] = os.path.join(root,
                                                      "surreal_h36m_pose")
    assert checks.hm36_dataset_params(root) == dp
    assert checks.NO_AUG == want["train_params"]["aug"]


def test_train_cli_builds_the_dataset_after_seeding(trees, monkeypatch):
    """train/__main__.py builds the dataset where train.py does: after
    setup_seed, so the subset policies see the seeded global state."""
    from x_as_supervision_tpu_torch.data import factory
    from x_as_supervision_tpu_torch.train import __main__ as cli

    seen = {}

    class Stop(Exception):
        pass

    def build(config, synthetic, eval_only=False):
        seen["state"] = np.random.get_state()[1].copy()
        seen["args"] = (synthetic, eval_only)
        raise Stop

    monkeypatch.setattr(factory, "build_dataset", build)
    cfg = flagship_config(tiny=True)
    cfg["dataset_params"] = _config(trees["port"])["dataset_params"]
    cfg_path = os.path.join(trees["port"], "cli_seed.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(Stop):
        cli.main(["--config", cfg_path, "--seed", "13", "--device", "cpu",
                  "--log_dir", os.path.join(trees["port"], "log_seed")])
    np.random.seed(13)
    assert np.array_equal(seen["state"], np.random.get_state()[1])
    assert seen["args"] == (False, False)


def test_train_and_eval_clis_on_the_ondisk_fixture(tmp_path):
    """The tiny flagship config on the on-disk H36M fixture (with its
    SURREAL pseudo stream) through both port CLIs on the CPU without
    --synthetic: one epoch to 00000_ckpt, then eval_result.txt."""
    from x_as_supervision_tpu_torch.data.pipeline import hm36_Dataset
    from x_as_supervision_tpu_torch.eval.__main__ import main as eval_main
    from x_as_supervision_tpu_torch.train.__main__ import main as train_main

    root = str(tmp_path / "tree")
    checks.write_mini_h36m(root, img_size=IMG, n_frames=4, seed=0)
    checks.write_surreal_pseudo(os.path.join(root, "surreal_h36m_pose"), 8,
                                seed=1, size=PATCH)
    cfg = flagship_config(tiny=True)
    cfg["dataset_params"] = checks.hm36_dataset_params(root)
    cfg["dataset_params"]["cam_id_list"] = [0, 1]
    cfg["train_params"].update(batch_size=2, num_epochs=1, checkpoint_freq=1,
                               aug=dict(checks.NO_AUG))
    cfg["model_params"]["smpl_disc_params"].update(
        input_dim=8, hidden_dim=8, output_dim=8)
    path = tmp_path / "tiny_real.json"
    path.write_text(json.dumps(cfg))
    log = tmp_path / "log"
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        trainer = train_main(["--config", str(path), "--seed", "0",
                              "--device", "cpu", "--fp32", "--log_dir",
                              str(log)])
        assert isinstance(trainer.dataset, hm36_Dataset)
        # 4 frames at batch 2: padded by a whole batch, 6 samples, 3 steps
        assert len(trainer.dataset) == 6
        assert trainer.state.step == 3 and len(trainer.history) == 3
        assert all(np.isfinite(h["loss_total"]) for h in trainer.history)
        (run,) = os.listdir(log)
        ckpt_dir = str(log / run / "00000_ckpt")
        assert os.path.isdir(ckpt_dir)
        ev = eval_main(["--config", str(path), "--checkpoint", ckpt_dir,
                        "--multi_hypo", "best", "--device", "cpu"])
    finally:
        torch.set_num_threads(saved)
    assert isinstance(ev.dataset, hm36_Dataset) and not ev.dataset.is_train
    assert ev.num_batches == 3
    lines = checks.result_lines(ev.result_path)
    assert len(lines) == 15
    assert all(v is None or np.isfinite(v) for _, v in lines)
    # every frame is act_02 (Directions): its bucket holds them all
    rec2d, cnt2d = ev.tables[0], ev.tables[1]
    assert cnt2d["Directions"] == 3 * 2 * 2
    assert sum(cnt2d.values()) == cnt2d["Directions"]
    assert np.isfinite(rec2d["Directions"]) and rec2d["Directions"] > 0
