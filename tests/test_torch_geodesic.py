"""The port's geodesic weight maps (x_as_supervision_tpu_torch/data/
geodesic.py) against the JAX package's, on the CPU.

The port builds its own copy of the fast-marching solver
(x_as_supervision_tpu_torch/csrc/host/fastmarch.cpp) with the host compiler
and native/Makefile's flags; the JAX package loads native/build/
libfastmarch.so. The same solver with the same flags gives the same
doubles: the maps are compared exactly.
"""

import os

import numpy as np
import pytest

from x_as_supervision_tpu.data import geodesic as JG
from x_as_supervision_tpu_torch.data import geodesic as PG
from x_as_supervision_tpu_torch.ops import _build
from torch_parity import few_torch_threads  # noqa: F401 (autouse)

PARAMS = [2, 1, 3, 20, 0.0]  # the shipped configs' geodesic_param_list


def _body(h, w, seed):
    """A (1, H, W) 0/1 mask: a torso, two limbs and a detached blob."""
    rng = np.random.default_rng(seed)
    m = np.zeros((1, h, w), np.float32)
    m[0, h // 4: 3 * h // 4, w // 3: 2 * w // 3] = 1
    m[0, h // 2 - 2: h // 2 + 2, 2: w // 3] = 1
    m[0, 3 * h // 4:, w // 2 - 2: w // 2 + 2] = 1
    y, x = rng.integers(2, h - 6), rng.integers(2 * w // 3 + 2, w - 6)
    m[0, y: y + 4, x: x + 4] = 1
    return m


@pytest.fixture(scope="module")
def jax_native():
    if JG._load_lib() is None:
        pytest.fail("the JAX package's native/build/libfastmarch.so is "
                    "missing: its maps would come from its Dijkstra fallback")
    return JG


# centers as fractions of (W, H): on the torso, on the limbs, off the mask
CASES = {
    "centroid": dict(centers=None),
    "one_joint": dict(centers=[[0.51, 0.48]]),
    "several_joints": dict(centers=[[0.5, 0.47], [0.19, 0.5], [0.52, 0.86]]),
    "unnormalized": dict(centers=None, is_norm=False),
    "nonzero_bg_fill": dict(centers=None, params=[2, 1, 3, 20, 0.5]),
    "off_mask": dict(centers=[[0.02, 0.02]]),
    "one_of_several_off_mask": dict(centers=[[0.5, 0.47], [0.94, 0.03]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
def test_maps_equal_the_jax_package(jax_native, case, shape):
    kw = dict(CASES[case])
    params = kw.pop("params", PARAMS)
    mask = _body(*shape, seed=len(case))
    if kw["centers"] is not None:
        kw["centers"] = (np.array(kw["centers"]) * [shape[1], shape[0]]
                         ).astype(np.float32)
    got, got_c = PG.compute_geodesic_dis(mask, "m.png", params, **kw)
    want, want_c = jax_native.compute_geodesic_dis(mask, "m.png", params,
                                                   **kw)
    assert got.dtype == want.dtype and got.shape == want.shape == mask.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_c, want_c)
    if case.endswith("off_mask"):
        # a seed off the mask: the degenerate all-ones map
        assert got.dtype == np.float16 and (got == 1).all()
    else:
        assert got.dtype == np.float64 and np.isfinite(got).all()


def test_fmm_distance_equals_the_jax_package(jax_native):
    rng = np.random.default_rng(3)
    for _ in range(4):
        valid = (rng.random((40, 56)) > 0.2).astype(np.uint8)
        seeds = np.zeros_like(valid)
        seeds[rng.integers(0, 40, 3), rng.integers(0, 56, 3)] = 1
        np.testing.assert_array_equal(PG.fmm_distance(seeds, valid),
                                      jax_native.fmm_distance(seeds, valid))


def test_fmm_distance_is_exact_along_the_axes():
    """First-order FMM from one seed on an open grid: along its row and its
    column the distance is the number of steps; elsewhere it lies between
    the Euclidean and the 8-neighbour graph distance."""
    seeds = np.zeros((21, 31), np.uint8)
    seeds[10, 15] = 1
    d = PG.fmm_distance(seeds, np.ones_like(seeds))
    np.testing.assert_array_equal(d[10], np.abs(np.arange(31) - 15))
    np.testing.assert_array_equal(d[:, 15], np.abs(np.arange(21) - 10))
    yy, xx = np.mgrid[0:21, 0:31]
    euclid = np.hypot(yy - 10, xx - 15)
    assert (d >= euclid - 1e-9).all()
    graph = JG._dijkstra_fallback(seeds, np.ones_like(seeds))
    assert (d <= graph + 1).all()


def test_fmm_distance_checks_its_shapes():
    with pytest.raises(ValueError, match="one"):
        PG.fmm_distance(np.zeros((4, 5), np.uint8), np.zeros((5, 4), np.uint8))


def test_the_library_is_the_ports_own_build():
    lib = PG.fmm_library()
    src, path = _build.host_library_path("fastmarch")
    assert lib._name == str(path) and path.parent == _build.HOST_BUILD_DIR
    assert src == _build.HOST_CSRC / "fastmarch.cpp"
    assert "native" not in os.path.relpath(lib._name, _build.BUILD_DIR.parent)
    # the name hashes the source and the flags, as the kernels' do
    assert path.name.startswith("fastmarch-") and path.suffix == ".so"


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a source that does not compile, or no compiler, raises
    where the pipeline asks for the library."""
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_CSRC", tmp_path / "src")
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="host library build failed"):
        _build.load_host("broken")
    assert not list((tmp_path / "build").glob("*.so"))

    (tmp_path / "src" / "fastmarch.cpp").write_bytes(
        (_build.CSRC / "host" / "fastmarch.cpp").read_bytes())
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        PG.fmm_distance(np.ones((4, 4), np.uint8), np.ones((4, 4), np.uint8))
