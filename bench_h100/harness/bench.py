"""What the command needs besides a cell's kind: the manifest
(``BENCHMARK.json``) and the files it names, found by name, the metric
readers, the device record and the check that no JAX module was loaded.

A cell is the manifest's workload entry; its configuration is the file the
manifest names for it, its traffic ``traffic/<traffic>.json`` and its
limits ``workloads/<cell>.json``. The traffic's ``kind`` names the module
that drives it (``harness/<kind>_cell.py``). Each metric is read by
``metrics/<name>.py``, whose ``read(run)`` returns its value, or None where
the run has nothing for it to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "x_as_supervision_tpu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SHORT = {torch.bfloat16: "bf16", torch.float32: "fp32"}


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    dtype: torch.dtype

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def load_cell(name: str, root: str = ROOT, here: str = HERE) -> Cell:
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    config = _json(os.path.join(root, conf["file"]))
    # the program's config loader gives the model the data's cameras
    config["model_params"]["cam_id_list"] = \
        config["dataset_params"]["cam_id_list"]
    return Cell(name=name, entry=entry, config=config,
                traffic=_json(os.path.join(here, "traffic",
                                           entry["traffic"] + ".json")),
                limits=_json(os.path.join(here, "workloads",
                                          name + ".json"))["limits"],
                dtype=DTYPES[config["dtype"]])


def driver(cell: Cell):
    return importlib.import_module(f"harness.{cell.kind}_cell")


def metric_entries(name: str, trace: bool, root: str = ROOT) -> list[dict]:
    """The metrics a run of cell `name` reports: its end-to-end ones, or
    with `trace` its per-layer ones. An entry without ``workloads`` holds
    in every cell."""
    m = manifest(root)
    group = m["per_layer"] if trace else m["end_to_end"]
    return [e for e in group if name in e.get("workloads", [name])]


def read_metric(name: str, run: dict, here: str = HERE):
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({k.split(".")[0] for k in list(sys.modules)
                   if k.split(".")[0] in FORBIDDEN})
