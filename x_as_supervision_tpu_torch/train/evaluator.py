"""Evaluation harness, ported from the JAX package's train/evaluator.py:
multi-hypothesis selection, 2D / 3D / triangulated metrics, per-action H36M
tables, the ambiguity ratio and the eval_result.txt writer.

The device side of a batch (feed normalization, one detector forward per
camera, the L/R switch per hypothesis, best or confident selection, the
world lifts and the DLT triangulation) runs on the evaluator's device, and
its outputs come back to the host in one transfer per batch. The metric
accumulation stays on the host in numpy float64, as there.

Kept from the JAX package (and its reference, eval.py:65-298):
  * the LAST hypothesis's swap mask feeds the ambiguity ratio;
  * the MPI 'Tri3D' block divides pck / auc by the 3D count table;
  * eval_result.txt has the same lines, in the same order, with the same
    text.
Given a writer, ``eval`` logs each batch's pose panels as the JAX package
does (``_log_batch_images``).

In a process group (parallel/) the batches are sharded as the JAX
package's default ``shard_across_processes=True`` shards them: process p
of P walks batches p, p + P, ... (the reference's DistributedSampler).
``record(..., reduce_hosts=True)`` sums the tables, the ambiguity sum and
the batch count over the processes before it writes (the JAX package
averages them, which gives the same ratios up to the count tables' 1e-8
guard; the sum gives the one-process tables themselves), so every process
holds the one-process result and process 0 writes eval_result.txt.
"""

from __future__ import annotations

import copy
import os
import time
import types

import numpy as np
import torch

from ..models.composed import preprocess_batch
from ..ops import geometry as G
from ..parallel import collectives as C
from ..parallel import mesh
from ..serve import resolve_device
from . import eval_utils as EU
from . import metrics as MET
from . import vis
from .logging import figure, pose_panel

# the per-camera batch fields the device step reads
_CAM_FIELDS = ("img", "joints", "mask", "trans_image", "pelvis", "k_mat",
               "trans_world", "rot_world")


def _new_tables(cal_per_act: bool):
    if cal_per_act:
        act = EU.new_act_table()
        mk = lambda: {
            "mpjpe": copy.deepcopy(act),
            "n-mpjpe": copy.deepcopy(act),
            "p-mpjpe": copy.deepcopy(act),
        }
        return (
            copy.deepcopy(act), copy.deepcopy(act), mk(), mk(), mk(), mk()
        )
    zeros = lambda: {
        "mpjpe": 0.0, "n-mpjpe": 0.0, "p-mpjpe": 0.0, "pck": 0.0, "auc": 0.0
    }
    return 0.0, 0.0, zeros(), zeros(), zeros(), zeros()


def fetch(out: dict) -> dict:
    """A nested dict of device tensors -> the same dict of numpy arrays, in
    one device-to-host copy (every leaf packed into one fp32 buffer; bool
    and integer leaves come back as such, exact below 2^24)."""
    leaves = []

    def walk(tree, path):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], path + (k,))
            else:
                leaves.append((path + (k,), tree[k]))

    walk(out, ())
    flat = torch.cat([t.reshape(-1).float() for _, t in leaves]).cpu().numpy()
    result: dict = {}
    offset = 0
    for path, t in leaves:
        n = t.numel()
        a = flat[offset:offset + n].reshape(tuple(t.shape))
        offset += n
        if t.dtype == torch.bool:
            a = a.astype(bool)
        elif not t.dtype.is_floating_point:
            a = a.astype(np.int64)
        node = result
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return result


class Evaluator:
    def __init__(
        self,
        config: dict,
        detector,
        dataset,
        log_dir: str,
        img_size: float = 256.0,
        batch_size: int | None = None,
        device=None,
    ):
        """detector: the port's detector (models/detector.py) with its
        weights, moved to `device` and put in eval mode; dataset: batches
        with the cam_<id>_* schema (data/synthetic.py). Runs on the CUDA
        card (this rank's, in a process group) unless `device` names
        another. In a process group, process p walks batches p, p + P,
        ... (``my_batches``)."""
        self.config = config
        self.device = resolve_device(mesh.rank_device(device))
        self.detector = detector.to(self.device).eval()
        self.dataset = dataset
        self.log_dir = log_dir
        self.img_size = img_size
        self.cam_id_list = config["model_params"]["cam_id_list"]
        self.cal_per_act = (
            config["dataset_params"]["dataset"]["name"] != "mpi_inf_3dhp"
            if "dataset" in config.get("dataset_params", {})
            else True
        )
        # dataset_params.eval_protocol: 'mpi' forces the MPI-style report
        # (PCK@0.15m + AUC, no per-action tables) on any dataset; 'hm36'
        # forces per-action tables.
        proto = config.get("dataset_params", {}).get("eval_protocol")
        if proto is not None:
            self.cal_per_act = proto != "mpi"
        # device-side normalization of uint8-shipped eval batches
        # (dataset_params.uint8_feed; models/composed.preprocess_batch)
        di = config.get("dataset_params", {}).get("dataiter", {})
        self._feed_spec = types.SimpleNamespace(
            feed_mean=tuple(di["mean"]) if di.get("mean") is not None
            else None,
            feed_std=tuple(di["std"]) if di.get("std") is not None else None,
            feed_rm_bg=bool(
                config.get("dataset_params", {}).get("rm_bg", False)
            ),
        )
        self.batch_size = batch_size or config["train_params"]["batch_size"]
        self.num_batches = max(1, len(dataset) // self.batch_size)
        self.my_batches = list(range(mesh.process_index(), self.num_batches,
                                     mesh.process_count()))
        # per batch of the last eval(): the device step's ms between two
        # CUDA events (on the card only), and the eval's wall seconds
        self.step_ms: list[float] = []
        self.wall_s = 0.0

    # ---------------- device side ----------------

    def _norm_gt(self, kp_gt):
        """Patch pixels -> x, y in [-1, 1], z / (img_size - 1)."""
        s = self.img_size - 1
        return torch.cat([kp_gt[..., :2] / s * 2 - 1, kp_gt[..., 2:] / s],
                         dim=-1)

    def to_device(self, batch: dict) -> dict:
        """The fields of a numpy batch that the device step reads, as
        tensors on the evaluator's device."""
        out = {}
        for c in self.cam_id_list:
            for field in _CAM_FIELDS:
                key = f"cam_{c}_{field}"
                if key in batch:
                    out[key] = torch.as_tensor(np.asarray(batch[key])).to(
                        self.device)
        return out

    @torch.inference_mode()
    def predict(self, batch: dict, mode: str) -> tuple[dict, dict]:
        """Feed normalization, one detector forward per camera, the L/R
        switch per hypothesis and the best or confident choice. Returns the
        normalized batch and, per "cam_<id>", a dict of the raw hypotheses
        ``kps`` (B, H, K, 3), the normalized GT ``gt`` (B, K, 3), the
        selected 3D ``kp`` (B, K, 3) and 2D ``kp_2d`` (B, K, 2) points, the
        per-joint hypothesis of the 3D choice ``choice`` (B, K; 0 in
        confident mode) and the last hypothesis's swap mask ``swap``
        (B, K, 1)."""
        batch = preprocess_batch(batch, self._feed_spec)
        cams = {}
        for cam_id in self.cam_id_list:
            ck = f"cam_{cam_id}"
            pred = self.detector(
                batch[f"{ck}_img"].permute(0, 3, 1, 2)).kps  # (B, H, K, 3)
            b, nh, k, _ = pred.shape
            kp_gt = self._norm_gt(batch[f"{ck}_joints"])
            gt_h = kp_gt[:, None].expand(b, nh, k, 3).reshape(b * nh, k, 3)

            # L/R disambiguation per hypothesis and joint (reference
            # eval.py:130-136); it reads only x, y, so the 2D switch of the
            # JAX package is this one's x, y
            sw3d, tmask = EU.switch_points(pred.reshape(b * nh, k, 3), gt_h,
                                           switch_all=False)
            sw3d = sw3d.reshape(b, nh, k, 3)
            sw2d = sw3d[..., :2]

            if mode == "best" and nh > 1:
                # argmin keeps the first of equal errors: the 2D errors of
                # the hypotheses are always equal (decode_multi shares x, y)
                err3 = ((sw3d - kp_gt[:, None]) ** 2).sum(-1)  # (B, H, K)
                best = torch.argmin(err3, dim=1)  # (B, K)
                sel3 = torch.gather(
                    sw3d, 1, best[:, None, :, None].expand(b, 1, k, 3))[:, 0]
                err2 = ((sw2d - kp_gt[:, None, :, :2]) ** 2).sum(-1)
                best2 = torch.argmin(err2, dim=1)
                sel2 = torch.gather(
                    sw2d, 1, best2[:, None, :, None].expand(b, 1, k, 2))[:, 0]
            else:
                best = torch.zeros((b, k), dtype=torch.int64,
                                   device=pred.device)
                sel3 = sw3d[:, 0]
                sel2 = sw2d[:, 0]
            # the reference's per-hypothesis loop overwrites trans_dict each
            # iteration, so the LAST hypothesis's swap mask feeds the
            # ambiguity ratio (reference eval.py:135-136)
            cams[ck] = dict(kps=pred, gt=kp_gt, kp=sel3, kp_2d=sel2,
                            choice=best,
                            swap=tmask.reshape(b, nh, k, 1)[:, -1])
        return batch, cams

    @torch.inference_mode()
    def step(self, batch: dict, mode: str) -> dict:
        """One batch on the device (predict, then the world lifts and the
        triangulation). Returns what the JAX package's step returns: the
        per-camera selected 2D predictions and normalized GT, the swap
        masks, each camera's world lift, and the GT and triangulated world
        poses."""
        batch, cams = self.predict(batch, mode)
        side = batch[f"cam_{self.cam_id_list[0]}_img"].shape[-2]
        kp_pred = {ck: c["kp"] for ck, c in cams.items()}
        return {
            "kp_pred_2d": {ck: c["kp_2d"] for ck, c in cams.items()},
            "gts_2d": {ck: c["gt"] for ck, c in cams.items()},
            "trans_masks": {ck: c["swap"] for ck, c in cams.items()},
            "per_cam_world": {
                ck: self._lift(kp, batch, ck, side, is_norm=True)
                for ck, kp in kp_pred.items()},
            "kps_world_gt": self._lift(batch["cam_0_joints"], batch, "cam_0",
                                       side, is_norm=False),
            "tri": G.triangulation(kp_pred, batch, self.cam_id_list, side),
        }

    @staticmethod
    def _lift(kps, batch, ck: str, side: int, is_norm: bool):
        return G.convert_patch_to_world(
            kps, batch[f"{ck}_trans_image"], batch[f"{ck}_pelvis"],
            batch[f"{ck}_k_mat"], batch[f"{ck}_trans_world"],
            batch[f"{ck}_rot_world"], image_width=side, image_height=side,
            is_norm=is_norm)

    # ---------------- host side ----------------

    def _update_3d(self, preds_list, gt, tables, counts, act_tags):
        vis = np.ones(gt.shape[:2], dtype=bool)
        for pred in preds_list:
            for metric, alignment in zip(
                ["mpjpe", "n-mpjpe", "p-mpjpe"], ["none", "scale", "procrustes"]
            ):
                err = MET.keypoint_mpjpe(pred, gt, vis, alignment).mean(axis=1)
                if self.cal_per_act:
                    EU.update_dict(tables[metric], counts[metric], err, act_tags)
                else:
                    tables[metric] += err.mean()
                    counts[metric] += 1
            if not self.cal_per_act:
                tables["pck"] += MET.keypoint_3d_pck(
                    pred / 1000.0, gt / 1000.0, vis
                ).mean()
                tables["auc"] += MET.keypoint_3d_auc(
                    pred / 1000.0, gt / 1000.0, vis
                )
                counts["pck"] += 1
                counts["auc"] += 1

    def eval(self, mode: str = "best", tb_log=None, tb_pair_ids=None,
             tb_parent_ids=None):
        """Walks the batches; returns the tables (rec2d, cnt2d, rec3d, cnt3d,
        rec3dt, cnt3dt, ambiguity) of this process's batches
        (``my_batches``) that record() writes. With `tb_log` each batch's
        panels go there, at the batch's index."""
        (rec2d, cnt2d, rec3d, cnt3d, rec3dt, cnt3dt) = _new_tables(
            self.cal_per_act
        )
        ambiguity = 0.0
        if tb_pair_ids is None:
            tb_pair_ids = np.array(
                self.config["model_params"].get("flip_pairs", [])
            )
        if tb_parent_ids is None:
            tb_parent_ids = np.array(
                self.config["model_params"].get("parent_ids", [])
            )
        timed = self.device.type == "cuda"
        self.step_ms = []
        t0 = time.perf_counter()
        for b in self.my_batches:
            batch = self.dataset.batch(b * self.batch_size, self.batch_size)
            act_tags = batch.pop("act", ["act_02"] * self.batch_size)
            dev = self.to_device(batch)
            if timed:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            out = self.step(dev, mode)
            if timed:
                ev1.record()
            out = fetch(out)
            if timed:
                self.step_ms.append(ev0.elapsed_time(ev1))

            if tb_log is not None:
                self._log_batch_images(
                    tb_log, b, batch, out, tb_pair_ids, tb_parent_ids
                )

            # 2D error per camera (reference eval.py:161-166)
            for cam_id in self.cam_id_list:
                ck = f"cam_{cam_id}"
                err2d = EU.per_act_mse(
                    out["kp_pred_2d"][ck], out["gts_2d"][ck][..., :2]
                )
                if self.cal_per_act:
                    EU.update_dict(rec2d, cnt2d, err2d, act_tags)
                else:
                    rec2d += err2d.mean()
                    cnt2d += 1

            # ambiguity ratio (reference eval.py:168-173)
            trans_val = sum(
                np.asarray(out["trans_masks"][f"cam_{c}"], dtype=np.float64)
                for c in self.cam_id_list
            )
            ambiguity += np.minimum(
                trans_val, len(self.cam_id_list) - trans_val
            ).mean()

            gt_world = np.asarray(out["kps_world_gt"])
            self._update_3d([np.asarray(out["tri"])], gt_world, rec3dt,
                            cnt3dt, act_tags)
            per_cam = [
                np.asarray(out["per_cam_world"][f"cam_{c}"])
                for c in self.cam_id_list
            ]
            self._update_3d(per_cam, gt_world, rec3d, cnt3d, act_tags)

        self.wall_s = time.perf_counter() - t0
        self._tables = (rec2d, cnt2d, rec3d, cnt3d, rec3dt, cnt3dt, ambiguity)
        return self._tables

    def _log_batch_images(self, tb_log, step, batch, out, pair_ids,
                          parent_ids):
        """Per-batch pred/GT pose panels + 3D plots, first sample only
        (reference: eval.py:152-158,178-199)."""
        mean = self.config["dataset_params"].get("dataiter", {}).get("mean")
        std = self.config["dataset_params"].get("dataiter", {}).get("std")
        if np.asarray(batch[f"cam_{self.cam_id_list[0]}_img"]).dtype == \
                np.uint8:
            mean, std = None, None  # uint8 feed is already display-ready
        gt_world = np.asarray(out["kps_world_gt"])
        figure(tb_log, "testing_pose_3D/gt", step,
               lambda: vis.pose_vis_3d(gt_world[0], pair_ids, parent_ids))
        figure(tb_log, "testing_pose_3D/pred_tri", step,
               lambda: vis.pose_vis_3d(np.asarray(out["tri"])[0], pair_ids,
                                       parent_ids,
                                       ref_keypoints=gt_world[0]))
        for cam_id in self.cam_id_list:
            ck = f"cam_{cam_id}"
            img = np.asarray(batch[f"{ck}_img"][0])
            pred2d = np.asarray(out["kp_pred_2d"][ck])[0]
            gt2d = np.asarray(out["gts_2d"][ck])[0][:, :2]
            size = img.shape[:2]
            pose_panel(tb_log, f"testing_pred_pose/{ck}_pred_pose_v2", step,
                       vis.pose_vis(pred2d, size, pair_ids, parent_ids,
                                    img=img, mean=mean, std=std))
            pose_panel(tb_log, f"testing_gt_pose/{ck}_gt_pose_v2", step,
                       vis.pose_vis(gt2d, size, pair_ids, parent_ids,
                                    img=img, mean=mean, std=std))
            figure(tb_log, f"testing_pose_3D/pred_{ck}", step,
                   lambda ck=ck: vis.pose_vis_3d(
                       np.asarray(out["per_cam_world"][ck])[0], pair_ids,
                       parent_ids, ref_keypoints=gt_world[0]))

    # ---------------- reporting ----------------

    def record(self, rec2d, cnt2d, rec3d, cnt3d, rec3dt, cnt3dt, ambiguity,
               reduce_hosts: bool = False):
        """Print and write eval/eval_result.txt in the reference's format
        (reference: eval.py:206-298); returns its path. reduce_hosts: the
        tables, the ambiguity sum and the batch count summed over the
        processes first (together, so the ratio is the global one even
        where the shards are unequal), every process calling; process 0
        prints and writes."""
        batch_count = float(len(self.my_batches))
        if reduce_hosts:
            (rec2d, cnt2d, rec3d, cnt3d, rec3dt, cnt3dt, ambiguity,
             batch_count) = C.cross_host_sum(
                (rec2d, cnt2d, rec3d, cnt3d, rec3dt, cnt3dt, ambiguity,
                 batch_count))
        eval_dir = os.path.join(self.log_dir, "eval")
        path = os.path.join(eval_dir, "eval_result.txt")
        # over this process's batches, or over all of them once reduced
        ratio = ambiguity / max(1.0, batch_count) / len(self.cam_id_list)
        self.last_ambiguity_ratio = float(ratio)
        if mesh.process_index() != 0:
            return path
        os.makedirs(eval_dir, exist_ok=True)

        if self.cal_per_act:
            full, select = EU.cal_per_class_error(rec2d, cnt2d)
            full3, select3 = EU.cal_per_class_error(rec3d, cnt3d, multi=True)
            fullt, selectt = EU.cal_per_class_error(rec3dt, cnt3dt, multi=True)
            print("---2D-----")
            print(rec2d)
            print(f"2D MSE: {full} %")
            print(f"2D MSE: {select} %")
            print("---3D----")
            for tag, e in (("", full3), ("select ", select3)):
                for m in ("mpjpe", "n-mpjpe", "p-mpjpe"):
                    print(f"{tag}{m.upper()}: {e[m]}")
            with open(path, "w") as f:
                f.write(f"2D MSE: {full} %\n")
                f.write(f"MPJPE: {full3['mpjpe']} %\n")
                f.write(f"N-MPJPE: {full3['n-mpjpe']} %\n")
                f.write(f"P-MPJPE: {full3['p-mpjpe']} %\n")
                f.write(f"TRI MPJPE: {fullt['mpjpe']} %\n")
                f.write(f"TRI N-MPJPE: {fullt['n-mpjpe']} %\n")
                f.write(f"TRI P-MPJPE: {fullt['p-mpjpe']} %\n")
                f.write("--------select---------\n")
                f.write(f"2D MSE: {select} %\n")
                f.write(f"MPJPE: {select3['mpjpe']} %\n")
                f.write(f"N-MPJPE: {select3['n-mpjpe']} %\n")
                f.write(f"P-MPJPE: {select3['p-mpjpe']} %\n")
                f.write(f"TRI MPJPE: {selectt['mpjpe']} %\n")
                f.write(f"TRI N-MPJPE: {selectt['n-mpjpe']} %\n")
                f.write(f"TRI P-MPJPE: {selectt['p-mpjpe']} %\n")
        else:
            with open(path, "w") as f:
                f.write(f"2D MSE: {rec2d / cnt2d} %\n")
                f.write("---3D-----\n")
                for key, val in rec3d.items():
                    f.write(f"{key}: {val / cnt3d[key]}"
                            + (" %\n" if key in ("pck", "auc") else "\n"))
                f.write("---Tri3D-----\n")
                for key, val in rec3dt.items():
                    # the reference divides pck / auc by cnt3d, not cnt3dt
                    # (reference eval.py:291)
                    denom = cnt3d[key] if key in ("pck", "auc") else cnt3dt[key]
                    f.write(f"{key}: {val / denom}"
                            + (" %\n" if key in ("pck", "auc") else "\n"))

        print(f"Results saved in {path}")
        print(f"Ambiguity Ratio:{ratio}")
        return path
