"""Model factory: config -> GanSpec (detector, discriminator, physique net),
ported from the JAX package's train/factory.py, with its load_smpl_assets;
and the flagship configuration, the port's own copy of
``__graft_entry__._flagship_config``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..models.composed import GanSpec, cal_links
from ..models.detector import build_detector
from ..models.discriminator import build_discriminator
from ..models.physique import PhysiqueMaskGenerator
from ..models.smpl import load_smpl_npz


def flagship_config(tiny: bool = False) -> dict:
    """The flagship fused GAN step: multi-hypothesis integral detector on
    ResNet-50 at 256^2 (K = 18, D = 64, 3 hypotheses), 4 cameras, physique
    [32, 64, 128], the decoupled SAGE discriminator at 128 dims, every loss
    on. ``tiny``: ResNet-18 at 64^2, D = 8, 2 cameras, physique [4, 8],
    16 dims, the parity tests' shape."""
    patch = 64 if tiny else 256
    dims = 16 if tiny else 128
    cams = [0, 1] if tiny else [0, 1, 2, 3]
    return {
        "dataset_params": {"cam_id_list": cams},
        "model_params": {
            "cam_id_list": cams,
            "detector_params": {
                "name": "resnet_multi", "num_kp": 18,
                "depth_dim": 8 if tiny else 64, "num_hypo": 3,
                "neighbor_size": 3 if tiny else 15,
                "num_layers": 18 if tiny else 50, "fp32_logits": False,
            },
            "smpl_disc_params": {
                "name": "res_sage_gcn_decouple", "input_dim": dims,
                "hidden_dim": dims, "output_dim": dims, "num_node": 18,
                "disc_sup_dim": 3, "num_layers": 2, "use_self_loop": True,
                "use_pe": True,
            },
            "physique_mask_generator_params": {
                "layers": [4, 8] if tiny else [32, 64, 128]},
            "parent_ids": [0, 0, 1, 2, 0, 4, 5, 0, 17, 8, 9, 17, 11, 12, 17,
                           14, 15, 7],
            "child_ids": list(range(18)),
            "flip_pairs": [[1, 4], [2, 5], [3, 6], [14, 11], [15, 12],
                           [16, 13]],
            "line_select_ids": list(range(17)),
            "body_width": 3.0,
            "remat": tiny,
            "loss_config": {
                "recons_loss": {"use_dis_map": False, "weight": 0.02},
                "physique_recons_loss": {"use_dis_map": False,
                                         "weight": 0.02},
                "smpl_pseudo_img_loss": {"weight": 3.0},
                "symmetry_loss": {
                    "weight": {"bone": 0.1, "kp": 0.1, "kp_2d": 0.0}},
                "smpl_disc_loss": {"weight": 0.5, "update_interval": 1},
                "smpl_gen_loss": {"weight": 0.5},
            },
        },
        "train_params": {
            "num_epochs": 15, "batch_size": 32, "epoch_milestones": [40],
            "lr_kp_detector": 1.0e-4, "lr_discriminator": 1.0e-4,
            "checkpoint_freq": 2, "patch_width": patch,
            "patch_height": patch, "rect_3d_width": 2000,
            "rect_3d_height": 2000,
        },
    }


def build_gan_spec(config: dict, dtype=torch.float32) -> GanSpec:
    """The GAN's modules (on the CPU, in train mode, fp32 parameters; the
    detector and physique net compute in `dtype`, the discriminator in
    fp32) and its static settings. ``remat`` is read as the JAX package
    reads it (absent: True, ``full``; models/composed.py:_remat_mode): its
    mode goes into the spec, and ``decode`` recomputes the detector's
    decode. The physique ``pallas`` flag selects nothing here: the port
    always runs its kernels on the card. ``per_camera_bn`` gives the
    detector's and the physique net's BatchNorms one group of train
    statistics per camera."""
    mp = config["model_params"]
    remat_cfg = mp.get("remat", True)
    bn_groups = (len(mp.get("cam_id_list", [0]))
                 if mp.get("per_camera_bn", False) else 1)
    det_params = dict(mp["detector_params"])
    if bn_groups > 1:
        det_params["bn_groups"] = bn_groups
    detector = build_detector(det_params, dtype, train=True,
                              remat_decode=remat_cfg == "decode")

    discriminator = None
    if "smpl_disc_params" in mp:
        # the discriminator graph uses the un-extended skeleton edges
        parents, children = cal_links(
            mp["parent_ids"], line_select_ids=mp.get("line_select_ids"),
            use_root=False, extension=False)
        discriminator = build_discriminator(mp["smpl_disc_params"], parents,
                                            children).train()

    physique = None
    if "physique_mask_generator_params" in mp:
        physique = PhysiqueMaskGenerator(
            mp["physique_mask_generator_params"]["layers"], dtype,
            bn_groups).train()

    spec = GanSpec.from_config(mp, detector, discriminator, physique)
    dp = config.get("dataset_params", {})
    di = dp.get("dataiter", {})
    updates: dict = {"feed_rm_bg": bool(dp.get("rm_bg", False))}
    if di.get("mean") is not None and di.get("std") is not None:
        updates.update(feed_mean=tuple(float(v) for v in di["mean"]),
                       feed_std=tuple(float(v) for v in di["std"]))
    return dataclasses.replace(spec, **updates)


def load_smpl_assets(config: dict, device=None):
    """(SmplModel, h36m_regressor (17, V) fp32 tensor) when
    ``model_params.smpl_layer_params`` is set and its files
    (``smpl_neutral.npz``, ``J_regressor_h36m.npy`` under ``model_path``)
    exist, each None where absent: training reads SMPL only through the
    pre-rendered pseudo stream, so it runs without them."""
    mp = config["model_params"]
    if "smpl_layer_params" not in mp:
        return None, None
    root = mp["smpl_layer_params"]["model_path"]
    npz = os.path.join(root, "smpl_neutral.npz")
    reg = os.path.join(root, "J_regressor_h36m.npy")
    model = load_smpl_npz(npz, device) if os.path.exists(npz) else None
    regressor = (torch.as_tensor(np.load(reg).astype(np.float32),
                                 device=device)
                 if os.path.exists(reg) else None)
    return model, regressor
