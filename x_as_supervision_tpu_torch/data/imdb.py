"""Dataset index (IMDB) base: naming and the pickle cache, the port's own
copy of the JAX package's data/imdb.py (reference:
human_utils/dataset/imdb.py:104-135).

Both packages cache an index at the same path,
``<path>/<name>_cache/<name>_...pkl``, and each reads the other's. A cache
names the JAX package's ``PatchSample`` class
(``x_as_supervision_tpu.data.samples``), whichever package wrote it:
``save_cache`` writes the port's records under that name, so the JAX
package's plain ``pickle.load`` gets its own class back, and ``load_cache``
maps that name (and the port's own) to the port's ``PatchSample``, so
reading imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import pickle

from .samples import PatchSample

# the module whose PatchSample a cache names, the JAX package's
_CACHE_MODULE = "x_as_supervision_tpu.data.samples"
# the modules whose PatchSample a cache may name: the JAX package's, the port's
_SAMPLE_MODULES = (_CACHE_MODULE, PatchSample.__module__)


class _CacheUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "PatchSample" and module in _SAMPLE_MODULES:
            return PatchSample
        if module.split(".")[0] in ("x_as_supervision_tpu",
                                    "x_as_supervision_tpu_torch"):
            raise pickle.UnpicklingError(
                f"index cache names {module}.{name}; only PatchSample "
                f"records are read")
        return super().find_class(module, name)


def load_cache(path: str):
    """The index db pickled at `path` (by either package)."""
    with open(path, "rb") as fid:
        return _CacheUnpickler(fid).load()


class _CachePickler(pickle._Pickler):
    """pickle's own Python pickler, naming the port's PatchSample as the JAX
    package's class without importing it (the C pickler imports a class's
    module to check its name). It writes about 3x slower than the C one;
    a cache is written once per index."""

    def save_global(self, obj, name=None):
        if obj is not PatchSample:
            return super().save_global(obj, name)
        self.save(_CACHE_MODULE)
        self.save("PatchSample")
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def save_cache(path: str, db) -> None:
    """Pickle `db` to `path` as the JAX package writes it (its protocol, its
    class name), so either package reads it."""
    with open(path, "wb") as fid:
        _CachePickler(fid, pickle.HIGHEST_PROTOCOL).dump(db)


class IMDB:
    def __init__(self, benchmark_name, image_set_name, dataset_path,
                 patch_width, patch_height, cache_path_root, extra_param):
        self.benchmark_name = benchmark_name
        self.image_set_name = image_set_name
        self.dataset_path = dataset_path
        self.patch_width = patch_width
        self.patch_height = patch_height
        self.cache_path_root = cache_path_root
        self.name = (
            f"{benchmark_name}_{image_set_name}"
            f"_w{patch_width}xh{patch_height}{extra_param}"
        )

    @property
    def cache_path(self) -> str:
        path = os.path.join(self.cache_path_root, f"{self.name}_cache")
        os.makedirs(path, exist_ok=True)
        return path

    def gt_db(self):
        raise NotImplementedError
