"""Composed generator / discriminator losses of the GAN step, ported from
the JAX package's models/composed.py.

As there, the camera axis is folded into the batch camera-major: each phase
runs ONE detector forward over (num_cams * B) images, and BatchNorm pools
its statistics over all cameras. The pseudo-image stream has its own
forward. The batch is a dict of tensors in the data pipeline's layout
(images and masks (B, S, S, C), keypoints (B, K, 3)); the modules take NCHW.

Given an ``outputs`` dict, both phases fill it with the JAX package's
visualization outputs (the trainer's image panels): first sample only,
detached slices of values the phase computes anyway, plus the world lifts
of a few keypoints; no extra forward, and no loss, gradient or parameter
changes. Left out of this slice: the mono-camera path, ``use_aug`` rotation
augmentation (and so the ``_rot`` outputs) and the remat modes (the port
keeps every activation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..ops import geometry as G
from ..ops import losses as L


def cal_links(parent_ids, line_select_ids=None, use_root=False,
              extension=True):
    """Bone (parent, child) lists for the line renderer and the
    discriminator graph, with the 8 synthetic "body" edges appended for
    rendering."""
    parent_ids = list(parent_ids)
    if not use_root:
        child_ids = list(range(1, len(parent_ids)))
        parent_ids = parent_ids[1:]
    else:
        child_ids = list(range(len(parent_ids)))
    if line_select_ids is not None:
        parent_ids = [parent_ids[i] for i in line_select_ids]
        child_ids = [child_ids[i] for i in line_select_ids]
    if extension:
        parent_ids = parent_ids + [7, 7, 7, 7, 0, 0, 1, 4]
        child_ids = child_ids + [1, 4, 11, 14, 2, 5, 14, 11]
    return parent_ids, child_ids


@dataclass
class GanSpec:
    """The modules and static settings the generator and discriminator
    phases share (derived from model_params)."""

    detector: Any
    discriminator: Any | None
    physique: Any | None
    cam_id_list: tuple
    loss_config: dict
    render_parent_ids: tuple
    render_child_ids: tuple
    body_width: float
    disc_sup_dim: int = 3
    feed_mean: tuple | None = None
    feed_std: tuple | None = None
    feed_rm_bg: bool = False

    @staticmethod
    def from_config(model_params, detector, discriminator, physique):
        disc_params = model_params.get("smpl_disc_params", {})
        if disc_params.get("use_aug", False):
            raise NotImplementedError("smpl_disc_params.use_aug is not ported")
        rp, rc = cal_links(model_params["parent_ids"],
                           line_select_ids=model_params.get("line_select_ids"),
                           use_root=False, extension=True)
        return GanSpec(
            detector=detector, discriminator=discriminator, physique=physique,
            cam_id_list=tuple(model_params["cam_id_list"]),
            loss_config=model_params["loss_config"],
            render_parent_ids=tuple(rp), render_child_ids=tuple(rc),
            body_width=float(model_params.get("body_width", 3.0)) * 1e-3,
            disc_sup_dim=disc_params.get("disc_sup_dim", 3),
        )


def preprocess_batch(batch: dict, spec: GanSpec) -> dict:
    """Feed normalization of uint8 tensors: images (x - mean) / std, masks
    / 255, then rm_bg's img *= mask; float tensors pass through untouched."""
    out = dict(batch)
    was_u8 = set()
    for k, v in batch.items():
        if not torch.is_tensor(v) or v.dtype != torch.uint8:
            continue
        if k.endswith("_img") or k.endswith("_pseudo_img"):
            x = v.float()
            if spec.feed_mean is not None and spec.feed_std is not None:
                x = ((x - torch.tensor(spec.feed_mean, device=x.device))
                     / torch.tensor(spec.feed_std, device=x.device))
            out[k] = x
            if not k.endswith("_pseudo_img"):
                was_u8.add(k)
        elif k.endswith("_mask"):
            out[k] = v.float() / 255.0
    if spec.feed_rm_bg:
        for k in was_u8:
            mk = k[: -len("_img")] + "_mask"
            if mk in out:
                out[k] = out[k] * out[mk]
    return out


def _cams(spec: GanSpec, batch: dict):
    if "cam_mono_img" in batch:
        raise NotImplementedError("the mono-camera path is not ported")
    return spec.cam_id_list


def _stack(batch: dict, cams, suffix: str) -> torch.Tensor:
    """Camera-major concatenation of the per-camera tensors."""
    return torch.cat([batch[f"cam_{c}_{suffix}"] for c in cams])


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _lift(kps, batch: dict, ck: str, side: int, rep: int = 1):
    """Patch -> world mm for (N, K, 3) normalized keypoints of camera ck,
    each camera row repeated `rep` times (hypotheses folded sample-major)."""
    def r(key):
        return batch[f"{ck}_{key}"].repeat_interleave(rep, dim=0)

    return G.convert_patch_to_world(
        kps, r("trans_image"), r("pelvis"), r("k_mat"), r("trans_world"),
        r("rot_world"), image_width=side, image_height=side, is_norm=True)


def _disc(spec: GanSpec, poses, generator):
    return spec.discriminator(poses[..., : spec.disc_sup_dim], generator)


def _mono_world(kps):
    """The reference's visualization-only world of normalized patch
    keypoints (JAX: convert_patch_to_world(mono=True, patch=False))."""
    return G.convert_patch_to_world(kps, None, None, None, None, None, 0, 0,
                                    rect_width=256.0, mono=True, patch=False)


def _first_nhwc(x, i: int, b: int):
    """Camera i's first sample of a camera-major NCHW batch, as (1, H, W,
    C): the JAX package's layout of the mask outputs."""
    return x[i * b:i * b + 1].permute(0, 2, 3, 1).detach()


def generator_forward(spec: GanSpec, batch: dict, generator=None,
                      outputs: dict | None = None):
    """The generator-side loss menu, gated by the keys of loss_config as in
    the JAX package. Returns (losses {name: scalar}, the camera stream's
    decode); fills `outputs`, when given, with the visualization outputs.
    The modules' train/eval modes are the caller's."""
    cams = _cams(spec, batch)
    nc = len(cams)
    cfg = spec.loss_config
    losses: dict[str, torch.Tensor] = {}

    imgs = _nchw(_stack(batch, cams, "img"))
    side = imgs.shape[-1]
    b = imgs.shape[0] // nc
    decode = spec.detector(imgs)
    kps_all = decode.kps.reshape(nc, b, *decode.kps.shape[1:])  # (C,B,H,K,3)
    nh = kps_all.shape[2]
    kps_world = {}
    for i, cam in enumerate(cams):
        kps_bh = kps_all[i].reshape(b * nh, *kps_all.shape[3:])
        world = _lift(kps_bh, batch, f"cam_{cam}", side, rep=nh)
        kps_world[cam] = world.reshape(b, nh, *world.shape[1:])
    if outputs is not None:
        for i, cam in enumerate(cams):
            ck = f"cam_{cam}"
            outputs[f"pose_2d_pred_{ck}_ori"] = kps_all[i, :1, 0].detach()
            if i == 0:
                outputs[f"depth_map_{ck}"] = decode.depth_prob_map.detach()
            outputs[f"pose_3d_depth_{ck}"] = kps_world[cam][:1, 0].detach()
        with torch.no_grad():
            first = {k: v[:1] for k, v in batch.items()
                     if k.startswith("cam_0_")}
            outputs["kp_gt_world"] = G.convert_patch_to_world(
                first["cam_0_joints"], first["cam_0_trans_image"],
                first["cam_0_pelvis"], first["cam_0_k_mat"],
                first["cam_0_trans_world"], first["cam_0_rot_world"],
                image_width=side, image_height=side, is_norm=False)

    # one line render over all cameras, hypothesis 0's x, y
    kps2d = kps_all[:, :, 0, :, :2].reshape(nc * b, -1, 2)
    masks_all = G.draw_lines(kps2d, side, spec.render_parent_ids,
                             spec.render_child_ids, spec.body_width
                             ).amax(dim=1, keepdim=True)  # (CB, 1, S, S)
    if outputs is not None:
        for i, cam in enumerate(cams):
            outputs[f"mask_heatmap_line_cam_{cam}"] = _first_nhwc(masks_all,
                                                                  i, b)

    if "symmetry_loss" in cfg:
        w = cfg["symmetry_loss"]["weight"]
        loss_sym = 0.0
        for i, cam in enumerate(cams):
            per_hypo = []
            for h in range(nh):
                kw = kps_world[cam][:, h]
                val = (L.compute_bone_sym_loss(kw) * w["bone"]
                       + L.compute_kp_sym_loss(kw) * w["kp"])
                if "kp_2d" in w:
                    val = val + (L.compute_kp_sym_loss(
                        kps_all[i, :, h, :, :2], is_3d=False) * 1e2
                        * w["kp_2d"])
                per_hypo.append(val)
            loss_sym = loss_sym + torch.amin(torch.stack(per_hypo))
        losses["symmetry"] = loss_sym

    if "smpl_gen_loss" in cfg and spec.discriminator is not None:
        # root-centered world poses in m, all cams x hypos in one forward,
        # detached: the gradient reaches only the discriminator
        pw = torch.stack([kps_world[c] for c in cams])  # (C, B, H, K, 3)
        pw = (pw - pw[:, :, :, :1, :]) / 1000.0
        flat = pw.reshape(nc * b * nh, *pw.shape[3:]).detach()
        logits = _disc(spec, flat, generator).reshape(nc * b, nh, 1)
        losses["smpl_gen"] = (L.compute_disc_loss(logits, None) * nc
                              * cfg["smpl_gen_loss"]["weight"])

    if "smpl_pseudo_img_loss" in cfg:
        decode_p = spec.detector(_nchw(_stack(batch, cams, "pseudo_img")))
        pred_all = decode_p.kps.reshape(nc, b, nh, *decode_p.kps.shape[2:])
        h0w = cfg["smpl_pseudo_img_loss"].get("hypo0_weight", 0.0)
        loss_pseudo = 0.0
        for i, cam in enumerate(cams):
            gt = batch[f"cam_{cam}_pseudo_joints"]
            if outputs is not None:
                ck = f"cam_{cam}"
                with torch.no_grad():
                    pred0 = pred_all[i, :1, 0].detach()
                    outputs[f"pose_2d_pred_{ck}_pseudo"] = pred0
                    outputs[f"pose_3d_pred_{ck}_pseudo"] = _mono_world(pred0)
                    outputs[f"pose_3d_gt_{ck}_pseudo"] = _mono_world(gt[:1])
            per_hypo = torch.stack([L.compute_supervision(pred_all[i, :, h], gt)
                                    for h in range(nh)])
            loss_pseudo = loss_pseudo + torch.amin(per_hypo)
            if h0w:
                loss_pseudo = loss_pseudo + h0w * per_hypo[0]
        losses["smpl_pseudo_img"] = (loss_pseudo
                                     * cfg["smpl_pseudo_img_loss"]["weight"])

    gt_masks = _nchw(_stack(batch, cams, "mask"))

    def dis_map(key):
        # weight 0 makes the distance-map weighting unobservable
        use = cfg[key]["use_dis_map"] and cfg[key].get("weight", 0) != 0
        return _nchw(_stack(batch, cams, "geodesic_dis")) if use else None

    if "physique_recons_loss" in cfg and spec.physique is not None:
        phy_all = spec.physique(masks_all)
        if outputs is not None:
            for i, cam in enumerate(cams):
                outputs[f"mask_physique_cam_{cam}"] = _first_nhwc(phy_all, i,
                                                                  b)
        loss_phy = L.compute_mask_reconstruction_loss(
            phy_all, gt_masks, weight=dis_map("physique_recons_loss")) * nc
        losses["physique_recons"] = (loss_phy
                                     * cfg["physique_recons_loss"]["weight"])

    if "recons_loss" in cfg:
        # per-camera scalars, then the sum: with use_clip the loss is a
        # product of two per-camera means, so cameras cannot be folded
        weight = dis_map("recons_loss")
        loss_rec = 0.0
        for i in range(nc):
            sl = slice(i * b, (i + 1) * b)
            loss_rec = loss_rec + L.compute_mask_reconstruction_loss(
                masks_all[sl], gt_masks[sl],
                weight=None if weight is None else weight[sl], use_clip=True)
        losses["reconstruction"] = loss_rec * cfg["recons_loss"]["weight"]

    return losses, decode


def discriminator_forward(spec: GanSpec, batch: dict, generator=None,
                          precomputed_decode=None,
                          outputs: dict | None = None):
    """Discriminator-side LSGAN loss: real = the pseudo SMPL joints of the
    data stream, fake = the detector's predictions (no gradient). With
    ``precomputed_decode`` (the fused step) the generator phase's camera
    forward is reused; else the detector runs once more without gradient.
    Fills `outputs`, when given, with the visualization outputs."""
    cams = _cams(spec, batch)
    nc = len(cams)
    decode = precomputed_decode
    if decode is None:
        with torch.no_grad():
            decode = spec.detector(_nchw(_stack(batch, cams, "img")))
    pred = decode.kps.detach()  # (CB, H, K, 3)
    cb, nh = pred.shape[:2]
    smpl = _stack(batch, cams, "pseudo_joints")  # (CB, K, 3)
    pred_logits = _disc(spec, pred.reshape(cb * nh, *pred.shape[2:]),
                        generator).reshape(cb, nh, 1)
    smpl_logits = _disc(spec, smpl, generator)
    if outputs is not None:
        b = cb // nc
        for i, cam in enumerate(cams):
            ck = f"cam_{cam}"
            outputs[f"pose_smpl_2d_{ck}"] = smpl[i * b:i * b + 1].detach()
            outputs[f"smpl_logits_{ck}"] = smpl_logits[i * b:i * b + 1
                                                       ].detach()
            outputs[f"pred_logits_{ck}"] = pred_logits[i * b:i * b + 1, 0
                                                       ].detach()
        with torch.no_grad():
            for cam in cams:
                outputs[f"pose_smpl_3d_cam_{cam}"] = _mono_world(
                    batch[f"cam_{cam}_pseudo_joints"][:1])
    loss = L.compute_disc_loss(pred_logits, smpl_logits) * nc
    return loss * spec.loss_config["smpl_disc_loss"]["weight"]
