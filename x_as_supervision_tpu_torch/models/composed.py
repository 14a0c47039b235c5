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
changes.

``smpl_disc_params.use_aug`` adds the rotation augmentation: each pose
turned about z by an angle uniform in [-pi/4, pi/4] (ops/geometry.py:
rotate_z). Its uniforms are drawn from the phase's generator, or passed in
as ``rot_u`` (the tests feed the JAX package's draws).

A batch that carries ``cam_mono_img`` (the TikTok and MPII datasets, the
2D path) takes the mono branch, as in the JAX package: one ``mono`` camera
whatever the config's cam_id_list, its world lift the reference's
camera-free one (``_mono_world``), no ``kp_gt_world`` output, and no
symmetry loss (a zero tensor where symmetry is configured).

Rematerialization (``model_params.remat``, ``GanSpec.remat_mode``; the JAX
package's five modes, mapped by ``_remat_mode``, an absent key ``full``):
the train-mode detector forwards of the generator phase run through
``_detector_apply``, which makes checkpoint regions (models/remat.py) that
keep their inputs and recompute the rest in the backward:

  * ``none``: no region;
  * ``full``: each detector forward (cameras and pseudo images), and the
    line renderer;
  * ``pseudo``: the pseudo-image stream's detector forward only;
  * ``head_decode``: the head's 1x1 projection and the decode of each
    forward (the detector's "features" / "tail" stages): the saved value
    is the num_filters-channel feature map, not the K*D-channel logits;
  * ``decode``: the decode alone, inside the detector (its
    ``remat_decode``, set by train/factory.py).

Every mode computes what ``none`` computes; a recompute leaves the
BatchNorm running statistics alone. The discriminator phase's no-grad
forward, eval and serving make no region.

Data parallelism (parallel/): in a process group each rank holds its rows
of every camera's global batch, and each loss term is this rank's share of
the global term, so that the shares sum to it (``C.data_share``: a mean
over the global batch is the local mean over P). The minimum over
hypotheses of batch means (symmetry, the pseudo stream) is chosen from the
global means (ops/losses.py:share_of_min). The discriminator's dropout
and use_aug's rotations draw at the global shape from the step's generator
and take this rank's rows (``_rows``; they are camera-major, so not one
block). Without a process group every term is the one-process value.
Under tensor parallelism "the ranks" are the data ranks: the model ranks
of one data index hold the same rows and compute every loss alike on the
whole tensors that the modules gather (parallel/tp.py), so nothing here
is split over channels.

Under a profiler each module call is a span (spans.py:
``xas.model.detector``, ``.physique``, ``.discriminator``), as are the
line render (``xas.loss.render``) and each loss block of the generator
(``xas.loss.<name>``, its key in the loss dict).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import torch

from .. import spans as X
from ..ops import geometry as G
from ..ops import losses as L
from ..parallel import collectives as C
from ..parallel import mesh
from ..spans import span
from .remat import checkpoint


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
    use_aug: bool = False
    # 'none' | 'full' | 'pseudo' | 'head_decode' | 'decode' (module
    # docstring)
    remat_mode: str = "full"
    fuse_gan_step: bool = True
    feed_mean: tuple | None = None
    feed_std: tuple | None = None
    feed_rm_bg: bool = False

    @staticmethod
    def from_config(model_params, detector, discriminator, physique):
        disc_params = model_params.get("smpl_disc_params", {})
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
            use_aug=bool(disc_params.get("use_aug", False)),
            remat_mode=_remat_mode(model_params.get("remat", True)),
            fuse_gan_step=bool(model_params.get("fuse_gan_step", True)),
        )


def _remat_mode(cfg) -> str:
    """A config's ``remat`` value (bool, None or a mode's name) -> the
    mode: True is ``full``, False and None ``none``."""
    if cfg is True:
        return "full"
    if cfg is False or cfg is None:
        return "none"
    if cfg in ("none", "full", "decode", "head_decode", "pseudo"):
        return cfg
    raise ValueError(f"unknown remat mode {cfg!r}")


def _detector_apply(spec: GanSpec, imgs, force_remat: bool = False):
    """One (camera-batched) detector forward, in the checkpoint regions of
    spec.remat_mode (module docstring) where the detector is in train mode
    and a gradient is being recorded; `force_remat` (the pseudo stream
    under ``pseudo``) makes the whole forward one region."""
    det = spec.detector
    with span(X.DETECTOR):
        if not (det.training and torch.is_grad_enabled()):
            return det(imgs)
        if spec.remat_mode == "head_decode":
            return checkpoint(functools.partial(det, stage="tail"),
                              det(imgs, stage="features"))
        if spec.remat_mode == "full" or force_remat:
            return checkpoint(det, imgs)
        return det(imgs)


def _render(spec: GanSpec, kps2d, side: int):
    """The line masks (CB, 1, S, S) of hypothesis 0's (CB, K, 2) keypoints:
    one render over all cameras."""
    return G.draw_lines(kps2d, side, spec.render_parent_ids,
                        spec.render_child_ids, spec.body_width
                        ).amax(dim=1, keepdim=True)


@functools.lru_cache(maxsize=None)
def _feed_constant(values: tuple, device: torch.device) -> torch.Tensor:
    """`values` as an fp32 tensor on `device`, copied there once: a host
    tensor copied at every step would make the host wait on the card."""
    return torch.tensor(values, dtype=torch.float32, device=device)


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
                x = ((x - _feed_constant(spec.feed_mean, x.device))
                     / _feed_constant(spec.feed_std, x.device))
            out[k] = x
            if not k.endswith("_pseudo_img"):
                was_u8.add(k)
        elif k.endswith("_mask"):
            # a tensor divisor: PyTorch's CUDA division by a Python scalar
            # multiplies by its reciprocal, which is not x / 255 in every
            # last bit (the host's fp32 feed divides)
            out[k] = v.float() / torch.full((), 255.0, device=v.device)
    if spec.feed_rm_bg:
        for k in was_u8:
            mk = k[: -len("_img")] + "_mask"
            if mk in out:
                out[k] = out[k] * out[mk]
    return out


def _cams(spec: GanSpec, batch: dict):
    """The batch's cameras: the single mono view of a mono dataset
    (reference: modules/model.py:51-55), else the config's."""
    if "cam_mono_img" in batch:
        return ("mono",)
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


def _rows(nc: int, b: int, rep: int, device):
    """None without a process group; else ``(n, index)``: this rank's rows
    of the camera-major global batch of n = nc x (P b) x rep rows (each
    camera's samples, each repeated `rep` times; P data ranks), b samples
    per camera here, in this rank's order."""
    if not C.is_distributed():
        return None
    p, r = mesh.data_size(), mesh.data_index()
    # made on the device: a copy from the host would make it wait
    index = torch.cat([torch.arange((c * p + r) * b * rep,
                                    (c * p + r + 1) * b * rep, device=device)
                       for c in range(nc)])
    return nc * p * b * rep, index


def _disc(spec: GanSpec, poses, generator, rows=None):
    with span(X.DISCRIMINATOR):
        return spec.discriminator(poses[..., : spec.disc_sup_dim], generator,
                                  rows)


def _rotated(poses, generator, rot_u, rows=None):
    """The poses (N, K, 3) turned about z by the uniforms `rot_u` (N,), or
    by uniforms drawn from `generator` (for the global batch's n rows and
    this rank's taken, given `rows`)."""
    if rot_u is None:
        n = poses.shape[0] if rows is None else rows[0]
        rot_u = torch.rand(n, generator=generator, device=poses.device)
        if rows is not None:
            rot_u = rot_u[rows[1]]
    return G.rotate_z(poses, rot_u)


def _min_over_hypos(per_hypo):
    """min over hypotheses (H,) of batch means (or, in a process group,
    this rank's share of it: per_hypo are its shares)."""
    if not C.is_distributed():
        return torch.amin(per_hypo)
    return L.share_of_min(per_hypo)


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
                      outputs: dict | None = None, rot_u=None):
    """The generator-side loss menu, gated by the keys of loss_config as in
    the JAX package. Returns (losses {name: scalar}, the camera stream's
    decode); fills `outputs`, when given, with the visualization outputs.
    The modules' train/eval modes are the caller's. `rot_u`: use_aug's
    uniforms, one per camera, sample and hypothesis (camera-major)."""
    cams = _cams(spec, batch)
    nc = len(cams)
    cfg = spec.loss_config
    losses: dict[str, torch.Tensor] = {}

    imgs = _nchw(_stack(batch, cams, "img"))
    side = imgs.shape[-1]
    b = imgs.shape[0] // nc
    decode = _detector_apply(spec, imgs)
    kps_all = decode.kps.reshape(nc, b, *decode.kps.shape[1:])  # (C,B,H,K,3)
    nh = kps_all.shape[2]
    kps_world = {}
    for i, cam in enumerate(cams):
        kps_bh = kps_all[i].reshape(b * nh, *kps_all.shape[3:])
        world = (_mono_world(kps_bh) if cam == "mono"
                 else _lift(kps_bh, batch, f"cam_{cam}", side, rep=nh))
        kps_world[cam] = world.reshape(b, nh, *world.shape[1:])
    if outputs is not None:
        for i, cam in enumerate(cams):
            ck = f"cam_{cam}"
            outputs[f"pose_2d_pred_{ck}_ori"] = kps_all[i, :1, 0].detach()
            if i == 0:
                outputs[f"depth_map_{ck}"] = decode.depth_prob_map.detach()
            outputs[f"pose_3d_depth_{ck}"] = kps_world[cam][:1, 0].detach()
        # no GT world probe in mono (reference modules/model.py:83-84)
        if "mono" not in cams:
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
    with span(X.RENDER):
        if spec.remat_mode == "full" and torch.is_grad_enabled():
            masks_all = checkpoint(functools.partial(_render, spec,
                                                     side=side), kps2d)
        else:
            masks_all = _render(spec, kps2d, side)
    if outputs is not None:
        for i, cam in enumerate(cams):
            outputs[f"mask_heatmap_line_cam_{cam}"] = _first_nhwc(masks_all,
                                                                  i, b)

    if "symmetry_loss" in cfg:
        with span(X.LOSS_SYMMETRY):
            w = cfg["symmetry_loss"]["weight"]
            loss_sym = 0.0
            for i, cam in enumerate(cams):
                if cam == "mono":
                    # the mono camera has no symmetry loss (reference
                    # modules/model.py:100-102)
                    continue
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
                loss_sym = loss_sym + _min_over_hypos(
                    C.data_share(torch.stack(per_hypo)))
            if not torch.is_tensor(loss_sym):
                # a sum over no camera: a tensor on the step's device, for
                # the trainer's one packed fetch of the metrics
                loss_sym = torch.zeros((), device=imgs.device)
            losses["symmetry"] = loss_sym

    if "smpl_gen_loss" in cfg and spec.discriminator is not None:
        with span(X.LOSS_SMPL_GEN):
            # root-centered world poses in m, all cams x hypos in one
            # forward, detached: the gradient reaches only the discriminator
            pw = torch.stack([kps_world[c] for c in cams])  # (C, B, H, K, 3)
            pw = (pw - pw[:, :, :, :1, :]) / 1000.0
            flat = pw.reshape(nc * b * nh, *pw.shape[3:])
            rows = _rows(nc, b, nh, flat.device)
            logits = _disc(spec, flat.detach(), generator, rows).reshape(
                nc * b, nh, 1)
            if not spec.use_aug:
                loss_gen = L.compute_disc_loss(logits, None) * nc
            else:
                # the rotated branch is not detached, as in the JAX package:
                # it alone carries a gradient into the detector
                rot = _rotated(flat, generator, rot_u, rows)
                logits_rot = _disc(spec, rot, generator, rows).reshape(
                    nc * b, nh, 1)
                loss_gen = (L.compute_disc_loss(logits, None) * nc * 0.7
                            + L.compute_disc_loss(logits_rot, None) * nc
                            * 0.3)
            losses["smpl_gen"] = (C.data_share(loss_gen)
                                  * cfg["smpl_gen_loss"]["weight"])

    if "smpl_pseudo_img_loss" in cfg:
        with span(X.LOSS_SMPL_PSEUDO_IMG):
            decode_p = _detector_apply(
                spec, _nchw(_stack(batch, cams, "pseudo_img")),
                force_remat=spec.remat_mode == "pseudo")
            pred_all = decode_p.kps.reshape(nc, b, nh,
                                            *decode_p.kps.shape[2:])
            h0w = cfg["smpl_pseudo_img_loss"].get("hypo0_weight", 0.0)
            loss_pseudo = 0.0
            for i, cam in enumerate(cams):
                gt = batch[f"cam_{cam}_pseudo_joints"]
                if outputs is not None:
                    ck = f"cam_{cam}"
                    with torch.no_grad():
                        pred0 = pred_all[i, :1, 0].detach()
                        outputs[f"pose_2d_pred_{ck}_pseudo"] = pred0
                        outputs[f"pose_3d_pred_{ck}_pseudo"] = \
                            _mono_world(pred0)
                        outputs[f"pose_3d_gt_{ck}_pseudo"] = \
                            _mono_world(gt[:1])
                per_hypo = C.data_share(torch.stack([
                    L.compute_supervision(pred_all[i, :, h], gt)
                    for h in range(nh)]))
                loss_pseudo = loss_pseudo + _min_over_hypos(per_hypo)
                if h0w:
                    loss_pseudo = loss_pseudo + h0w * per_hypo[0]
            losses["smpl_pseudo_img"] = (
                loss_pseudo * cfg["smpl_pseudo_img_loss"]["weight"])

    gt_masks = _nchw(_stack(batch, cams, "mask"))

    def dis_map(key):
        # weight 0 makes the distance-map weighting unobservable
        use = cfg[key]["use_dis_map"] and cfg[key].get("weight", 0) != 0
        return _nchw(_stack(batch, cams, "geodesic_dis")) if use else None

    if "physique_recons_loss" in cfg and spec.physique is not None:
        with span(X.LOSS_PHYSIQUE_RECONS):
            with span(X.PHYSIQUE):
                phy_all = spec.physique(masks_all)
            if outputs is not None:
                for i, cam in enumerate(cams):
                    outputs[f"mask_physique_cam_{cam}"] = _first_nhwc(
                        phy_all, i, b)
            loss_phy = C.data_share(L.compute_mask_reconstruction_loss(
                phy_all, gt_masks,
                weight=dis_map("physique_recons_loss"))) * nc
            losses["physique_recons"] = (
                loss_phy * cfg["physique_recons_loss"]["weight"])

    if "recons_loss" in cfg:
        with span(X.LOSS_RECONSTRUCTION):
            # per-camera scalars, then the sum: with use_clip the loss is a
            # product of two per-camera means, so cameras cannot be folded
            weight = dis_map("recons_loss")
            loss_rec = 0.0
            for i in range(nc):
                sl = slice(i * b, (i + 1) * b)
                loss_rec = loss_rec + C.data_share(
                    L.compute_mask_reconstruction_loss(
                        masks_all[sl], gt_masks[sl],
                        weight=None if weight is None else weight[sl],
                        use_clip=True))
            losses["reconstruction"] = loss_rec * cfg["recons_loss"]["weight"]

    return losses, decode


def discriminator_forward(spec: GanSpec, batch: dict, generator=None,
                          precomputed_decode=None,
                          outputs: dict | None = None, rot_u=None):
    """Discriminator-side LSGAN loss: real = the pseudo SMPL joints of the
    data stream, fake = the detector's predictions (no gradient), and under
    use_aug also fake = the pseudo joints' (visualization) world lift
    rotated (`rot_u`: its uniforms, one per camera and sample). With
    ``precomputed_decode`` (the fused step) the generator phase's camera
    forward is reused; else the detector runs once more without gradient.
    Fills `outputs`, when given, with the visualization outputs."""
    cams = _cams(spec, batch)
    nc = len(cams)
    decode = precomputed_decode
    if decode is None:
        with torch.no_grad(), span(X.DETECTOR):
            decode = spec.detector(_nchw(_stack(batch, cams, "img")))
    pred = decode.kps.detach()  # (CB, H, K, 3)
    cb, nh = pred.shape[:2]
    smpl = _stack(batch, cams, "pseudo_joints")  # (CB, K, 3)
    rows_pred = _rows(nc, cb // nc, nh, pred.device)
    rows_smpl = _rows(nc, cb // nc, 1, pred.device)
    pred_logits = _disc(spec, pred.reshape(cb * nh, *pred.shape[2:]),
                        generator, rows_pred).reshape(cb, nh, 1)
    smpl_logits = _disc(spec, smpl, generator, rows_smpl)
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
    if not spec.use_aug:
        loss = L.compute_disc_loss(pred_logits, smpl_logits) * nc
    else:
        rot = _rotated(_mono_world(smpl), generator, rot_u, rows_smpl)
        if outputs is not None:
            b = cb // nc
            for i, cam in enumerate(cams):
                outputs[f"pose_smpl_3d_cam_{cam}_rot"] = rot[i * b:i * b + 1
                                                             ].detach()
        rot_logits = _disc(spec, rot, generator, rows_smpl)
        loss = (L.compute_disc_loss(pred_logits, smpl_logits) * nc * 0.6
                + L.compute_disc_loss(rot_logits, None) * nc * 0.4)
    return C.data_share(loss) * spec.loss_config["smpl_disc_loss"]["weight"]
