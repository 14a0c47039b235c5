"""The port's MPII index and dataset (x_as_supervision_tpu_torch/data/mpii.py,
data/dataloader_2d.py:mpii_dataset) against the JAX package's, on the CPU,
on a miniature on-disk MPII in the real layout
(x_as_supervision_tpu_torch/checks.py:write_mini_mpii).

Both packages read the same files with the same numpy, scipy and cv2 calls,
so every comparison is exact. Each package builds its index, and so its
cache, in a tree of its own; image paths are compared relative to it.
"""

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("scipy.io")

from x_as_supervision_tpu.data import dataloader_2d as JD  # noqa: E402
from x_as_supervision_tpu.data import hm36 as JH  # noqa: E402
from x_as_supervision_tpu.data import mpii as JP  # noqa: E402
from x_as_supervision_tpu_torch import checks  # noqa: E402
from x_as_supervision_tpu_torch.data import dataloader_2d as PD  # noqa: E402
from x_as_supervision_tpu_torch.data import hm36 as PH  # noqa: E402
from x_as_supervision_tpu_torch.data import mpii as PP  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = 6
OVEREXPOSED = (2,)
HW = (180, 320)
PATCH = 64


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two identical MPII trees, "jax" and "port" (the port's writer, one
    frame with an all-white mask that the over-exposure filter drops)."""
    out = {}
    for side in ("jax", "port"):
        out[side] = str(tmp_path_factory.mktemp(f"mpii_{side}"))
        checks.write_mini_mpii(out[side], n_images=IMAGES, size_hw=HW,
                               seed=5, overexposed=OVEREXPOSED)
    return out


def _imdb(mod, root, patch=PATCH):
    return mod.mpii("valid", os.path.join(root, "mpii"),
                    os.path.join(root, "sam_masks", "mpii"), patch, patch, "")


def _fresh(imdb):
    shutil.rmtree(imdb.cache_path)
    return imdb.gt_db()


def _same(a, b, roots, where=""):
    """Exact equality of records, samples or batches (nested dicts, lists,
    arrays, numbers); path strings compared relative to their trees."""
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


def test_constants_match_the_jax_package():
    assert PH.S_HM36_2_MPII_JT == JH.S_HM36_2_MPII_JT
    for name in ("MPII_FLIP_PAIRS", "MPII_PARENT_IDS"):
        np.testing.assert_array_equal(getattr(PP, name), getattr(JP, name))
        assert getattr(PP, name).dtype == getattr(JP, name).dtype
    assert (PP.PIXEL_STD, PP.SC_BIAS, PP.MPII_JOINT_NUM) == (
        JP.PIXEL_STD, JP.SC_BIAS, JP.MPII_JOINT_NUM)


def test_fixture_is_the_same_in_both_trees(trees):
    for sub in ("mpii", "sam_masks"):
        a, b = (os.path.join(trees[s], sub) for s in ("jax", "port"))
        names = sorted(os.path.relpath(os.path.join(d, f), a)
                       for d, _, fs in os.walk(a) for f in fs)
        assert len(names) > 2
        for rel in names:
            with open(os.path.join(a, rel), "rb") as fa, \
                    open(os.path.join(b, rel), "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("patch", [64, 256])
def test_gt_db_matches_jax(trees, patch):
    """Every record equal, the over-exposed frame dropped by both, the head
    sizes ||headbox|| * SC_BIAS."""
    want = _fresh(_imdb(JP, trees["jax"], patch))
    got = _fresh(_imdb(PP, trees["port"], patch))
    assert len(want) == IMAGES - len(OVEREXPOSED)
    _same([dict(r["cam_mono"]) for r in want],
          [dict(r["cam_mono"]) for r in got],
          (trees["jax"], trees["port"]))
    kept = {os.path.basename(r["cam_mono"].image) for r in got}
    assert {f"im{i:04d}.jpg" for i in OVEREXPOSED}.isdisjoint(kept)
    assert type(got[0]["cam_mono"]).__module__ == \
        "x_as_supervision_tpu_torch.data.samples"
    from scipy.io import loadmat

    boxes = loadmat(os.path.join(trees["port"], "mpii", "annot",
                                 "mpii_gt_valid.mat"))["headboxes_src"]
    sizes = np.linalg.norm(boxes[1] - boxes[0], axis=0) * PP.SC_BIAS
    for r in got:
        i = int(os.path.basename(r["cam_mono"].image)[2:6])
        assert r["cam_mono"].head_size == sizes[i]


@pytest.mark.parametrize("index", range(IMAGES - len(OVEREXPOSED)))
def test_mpii_dataset_samples_match_jax(trees, index):
    want = JD.mpii_dataset(_imdb(JP, trees["jax"]), patch_size=PATCH)
    got = PD.mpii_dataset(_imdb(PP, trees["port"]), patch_size=PATCH)
    assert len(got) == len(want)
    _same(want.sample(index), got.sample(index),
          (trees["jax"], trees["port"]))


def test_mpii_dataset_batches_match_jax(trees):
    want = JD.mpii_dataset(_imdb(JP, trees["jax"]), patch_size=PATCH)
    got = PD.mpii_dataset(_imdb(PP, trees["port"]), patch_size=PATCH)
    _same(want.batch(1, 3), got.batch(1, 3), (trees["jax"], trees["port"]))
    _same(want.device_batch(0, 4), got.device_batch(0, 4),
          (trees["jax"], trees["port"]))


def _db_in_process(module: str, root: str, dump: str, banned) -> str:
    """The gt_db of the tree at `root` read in a fresh process by
    `module`'s mpii, pickled to `dump` as plain dicts; fails if the
    process imported any of `banned`."""
    code = (
        "import pickle, sys\n"
        f"from {module} import mpii\n"
        f"db = mpii('valid', {os.path.join(root, 'mpii')!r}, "
        f"{os.path.join(root, 'sam_masks', 'mpii')!r}, {PATCH}, {PATCH}, "
        "'').gt_db()\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        f"{tuple(banned)!r}]\n"
        "assert not bad, bad\n"
        f"pickle.dump([dict(r['cam_mono']) for r in db], open({dump!r}, "
        "'wb'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_a_jax_written_cache_is_read_without_the_jax_package(trees,
                                                             tmp_path):
    root = trees["jax"]
    want = _fresh(_imdb(JP, root))
    dump = str(tmp_path / "port.pkl")
    out = _db_in_process("x_as_supervision_tpu_torch.data.mpii", root, dump,
                         ("jax", "jaxlib", "flax", "x_as_supervision_tpu"))
    assert "gt db loaded from" in out
    with open(dump, "rb") as f:
        got = pickle.load(f)
    _same([dict(r["cam_mono"]) for r in want], got, (root, root))


def test_the_jax_package_reads_a_cache_the_port_wrote(trees, tmp_path):
    """Both packages write the same cache bytes for the same tree; the JAX
    package reads the port's in a process without torch or the port."""
    root = trees["port"]
    raw = {}
    # the port writes last: its cache is the one the JAX package reads
    for side, mod in (("jax", JP), ("port", PP)):
        imdb = _imdb(mod, root)
        db = _fresh(imdb)
        (name,) = os.listdir(imdb.cache_path)
        with open(os.path.join(imdb.cache_path, name), "rb") as f:
            raw[side] = f.read()
    assert raw["port"] == raw["jax"]
    dump = str(tmp_path / "jax.pkl")
    out = _db_in_process("x_as_supervision_tpu.data.mpii", root, dump,
                         ("torch", "x_as_supervision_tpu_torch"))
    assert "gt db loaded from" in out
    with open(dump, "rb") as f:
        got = pickle.load(f)
    _same([dict(r["cam_mono"]) for r in db], got, (root, root))


def test_basic_data_refuses_mpii_in_both_packages(trees):
    """MPII is read only by the 2D eval CLI: both factories refuse it (the
    JAX package's with a TypeError, mpii taking no init_mode)."""
    from x_as_supervision_tpu.data import factory as JF
    from x_as_supervision_tpu_torch.data import factory as PF

    root = trees["port"]
    cfg = {
        "dataset_params": {
            "dataset": {"name": "mpii", "path": os.path.join(root, "mpii"),
                        "train_image_set": "valid",
                        "test_image_set": "valid"},
            "dataiter": {"mean": [0.0] * 3, "std": [1.0] * 3},
            "cam_id_list": ["mono"]},
        "model_params": {"loss_config": {}},
        "train_params": {"patch_width": PATCH, "patch_height": PATCH,
                         "rect_3d_width": 2000, "rect_3d_height": 2000,
                         "batch_size": 2},
    }
    for eval_only in (False, True):
        with pytest.raises(TypeError):
            JF.basic_data(cfg, eval_only=eval_only)
        with pytest.raises(ValueError, match="eval2d"):
            PF.basic_data(cfg, eval_only=eval_only)
