"""Config loading: the port's own copy of the JAX package's config.py (same
schema: dataset_params / model_params / train_params, the same checks, and
cam_id_list copied into model_params). A ``.json`` file is read with the
``json`` module, anything else as YAML; ``yaml`` is imported on use, so the
package imports, and reads JSON configs, on a machine without it."""

from __future__ import annotations

import copy
import json
from pathlib import Path

REQUIRED_SECTIONS = ("dataset_params", "model_params", "train_params")


def load_config(path: str | Path) -> dict:
    with open(path) as f:
        if str(path).endswith(".json"):
            cfg = json.load(f)
        else:
            import yaml

            cfg = yaml.safe_load(f)
    for section in REQUIRED_SECTIONS:
        if section not in cfg:
            raise ValueError(f"config {path} missing section '{section}'")
    cfg = copy.deepcopy(cfg)
    cfg["model_params"]["cam_id_list"] = cfg["dataset_params"]["cam_id_list"]
    _validate(cfg)
    return cfg


def _validate(cfg: dict) -> None:
    mp = cfg["model_params"]
    tp = cfg["train_params"]
    det = mp.get("detector_params", {})
    for key in ("name", "num_kp", "depth_dim"):
        if key not in det:
            raise ValueError(f"detector_params missing '{key}'")
    if det["name"] == "resnet_multi":
        for key in ("num_hypo", "neighbor_size"):
            if key not in det:
                raise ValueError(f"resnet_multi requires '{key}'")
    if "smpl_disc_params" in mp:
        disc = mp["smpl_disc_params"]
        if disc.get("num_node") != det["num_kp"]:
            raise ValueError(
                "smpl_disc_params.num_node must equal detector num_kp "
                f"({disc.get('num_node')} != {det['num_kp']})"
            )
    if "loss_config" not in mp:
        raise ValueError("model_params.loss_config is required")
    for key in ("num_epochs", "batch_size", "lr_kp_detector"):
        if key not in tp:
            raise ValueError(f"train_params missing '{key}'")
