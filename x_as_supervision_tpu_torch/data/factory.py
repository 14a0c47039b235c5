"""Dataset factory: config -> dataset instance, the port's own copy of the
JAX package's data/factory.py, and the CLIs' ``build_dataset`` (a copy of
train.py:build_dataset).

Mirrors the reference's basic_data (reference: train_util.py:16-106) with
two deliberate fixes noted in SURVEY.md §7.5:
  * dataset classes resolve through an explicit registry instead of
    eval(name + "_Dataset");
  * index builders resolve through a registry instead of getattr on a
    module (the reference's __all__ dict was vestigial).
The registry holds the 2D MPII index (``mpii``) as the JAX package's does,
but ``basic_data`` refuses it, as the JAX package's does (there a TypeError:
``mpii`` takes no ``init_mode``): MPII is read only by the 2D eval CLI
(eval2d.py, through data/dataloader_2d.py:mpii_dataset). The
TikTok mono dataset is built by the train2d3d CLI, not here.
"""

from __future__ import annotations

from . import hm36 as hm36_mod
from . import mpi_inf_3dhp as mpi_mod
from . import mpii as mpii_mod
from .pipeline import (
    hm36_Dataset,
    mpi_inf_3dhp_Dataset,
    mpi_inf_3dhp_hm36_Dataset,
)

IMDB_REGISTRY = {
    "hm36": hm36_mod.hm36,
    "human36": hm36_mod.hm36,
    "mpi_inf_3dhp": mpi_mod.mpi_inf_3dhp,
    "mpii": mpii_mod.mpii,
}

DATASET_REGISTRY = {
    "hm36": hm36_Dataset,
    "mpi_inf_3dhp": mpi_inf_3dhp_Dataset,
    "mpi_inf_3dhp_hm36": mpi_inf_3dhp_hm36_Dataset,
}


def _build_imdb(name: str, ds_cfg: dict, train_param: dict, image_set: str,
                use_full_kp: bool):
    if name not in IMDB_REGISTRY:
        raise NotImplementedError(
            f"dataset {name!r}: the port has the index builders "
            f"{sorted(IMDB_REGISTRY)}")
    if name == "mpii":
        raise ValueError(
            "dataset 'mpii' is read only by the 2D eval CLI "
            "(python -m x_as_supervision_tpu_torch.eval2d), not by "
            "basic_data")
    cls = IMDB_REGISTRY[name]
    return cls(
        image_set,
        ds_cfg["path"],
        train_param["patch_width"],
        train_param["patch_height"],
        train_param["rect_3d_width"],
        train_param["rect_3d_height"],
        ds_cfg.get("extra_param", ""),
        init_mode=use_full_kp,
    )


def basic_data(config: dict, eval_only: bool = False, seed: int = 0):
    dataset_param = config["dataset_params"]
    train_param = config["train_params"]

    use_full_kp = dataset_param.get("use_full_kp", False)
    cam_id_list = dataset_param["cam_id_list"]
    geodesic_pt_list = dataset_param.get("geodesic_pt_list", [0])
    geodesic_param_list = dataset_param.get(
        "geodesic_param_list", [2.0, 1.0, 2.0, 1.0, 0.0]
    )
    rm_bg = dataset_param.get("rm_bg", False)
    smpl_pseudo_img = dataset_param.get("smpl_pseudo_img")
    name = dataset_param["dataset"]["name"]
    convert_to_17kps = name == "mpi_inf_3dhp"

    # uint8_feed: ship uint8 image/mask tensors and normalize on device
    # (4x less host->device bandwidth; exact with color aug off — see
    # data/pipeline.py). Geodesic maps are skipped when no configured loss
    # can observe them (use_dis_map with weight != 0) — the FMM solve is
    # the host pipeline's most expensive transform and eval never reads it.
    uint8_feed = bool(dataset_param.get("uint8_feed", False))
    lc = config.get("model_params", {}).get("loss_config", {})
    need_geodesic = any(
        lc.get(k, {}).get("use_dis_map")
        and lc.get(k, {}).get("weight", 0) != 0
        for k in ("recons_loss", "physique_recons_loss")
    )
    compute_geodesic = bool(
        dataset_param.get(
            "compute_geodesic", need_geodesic and not eval_only
        )
    )

    common = dict(
        patch_width=train_param["patch_width"],
        patch_height=train_param["patch_height"],
        rect_3d_width=train_param["rect_3d_width"],
        rect_3d_height=train_param["rect_3d_height"],
        batch_size=train_param["batch_size"],
        mean=dataset_param["dataiter"]["mean"],
        std=dataset_param["dataiter"]["std"],
        aug_config=train_param.get("aug", {}),
        label_func=None,
        cam_id_list=cam_id_list,
        geodesic_pt_list=geodesic_pt_list,
        geodesic_param_list=geodesic_param_list,
        rm_bg=rm_bg,
        seed=seed,
        uint8_feed=uint8_feed,
        compute_geodesic=compute_geodesic,
    )

    if not eval_only:
        if "+" in name:
            # multi-dataset mix, e.g. 'mpi_inf_3dhp+hm36'
            parts = name.split("+")
            imdbs = [
                _build_imdb(
                    p, dataset_param["dataset"][p], train_param,
                    dataset_param["dataset"][p]["train_image_set"],
                    use_full_kp,
                )
                for p in parts
            ]
            cls = DATASET_REGISTRY[name.replace("+", "_")]
            return cls(imdbs, True, smpl_pseudo_img=smpl_pseudo_img, **common)
        imdb = _build_imdb(
            name, dataset_param["dataset"], train_param,
            dataset_param["dataset"]["train_image_set"], use_full_kp,
        )
        cls = DATASET_REGISTRY[name]
        return cls([imdb], True, smpl_pseudo_img=smpl_pseudo_img, **common)

    imdb = _build_imdb(
        name, dataset_param["dataset"], train_param,
        dataset_param["dataset"]["test_image_set"], use_full_kp,
    )
    cls = DATASET_REGISTRY[name]
    return cls(
        [imdb], False, smpl_pseudo_img=None,
        convert_to_17kps=convert_to_17kps, **common,
    )


def build_dataset(config: dict, synthetic: bool, eval_only: bool = False):
    """The CLIs' dataset: the synthetic fixture, or the configured on-disk
    dataset (its ``test_image_set`` with `eval_only`). The per-sample seed
    is 0, as train.py:build_dataset leaves it whatever ``--seed`` is."""
    if synthetic:
        from .synthetic import synthetic_dataset

        return synthetic_dataset(config)
    return basic_data(config, eval_only=eval_only)
