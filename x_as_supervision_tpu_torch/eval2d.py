"""The port's 2D eval CLI (MPII PCKh), the twin of the JAX package's
eval2d.py:

    python -m x_as_supervision_tpu_torch.eval2d --config <yaml|json> \\
        --checkpoint <ckpt_dir> [--multi_hypo best|confident] \\
        [--batch_size N] [--device cpu]

It takes the detector out of a train checkpoint of the port through
serve.PoseEstimator (eval mode, bf16, as eval2d.py builds it), runs it over the MPII validation crops of
the config's ``dataset_params.dataset`` (data/mpii.py, data/dataloader_2d.py:
mpii_dataset), maps predictions and GT back to original-image pixels
through the inverse crop affine after the L/R switch, and writes
``PCKh@0.5: <value>`` to ``<run>/eval/eval2d_result.txt`` beside the
checkpoint (train/metrics.py:keypoint_pckh with the dataset's head sizes;
reference metrics.py:247-253). It runs on the CUDA card unless given
``--device cpu``; there the kernels' plain versions run.
"""

from __future__ import annotations

import os
import time
import types
from argparse import ArgumentParser

import numpy as np

from .data.hm36 import S_HM36_2_MPII_JT
from .data.mpii import MPII_FLIP_PAIRS


def _switch16(p, g):
    """switch_points with the MPII flip pairs on (B, 16, 2) pixel points,
    in fp32 as the JAX package computes it."""
    import torch

    from .train.eval_utils import switch_points

    def xyz(a):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.concatenate(
            [a, np.zeros_like(a[..., :1])], -1))

    out, _ = switch_points(xyz(p), xyz(g), switch_list=MPII_FLIP_PAIRS)
    return out.numpy()[..., :2]


def evaluate_pckh(dataset, forward_fn, patch: float, batch_size: int,
                  multi_hypo: str = "best", points: list | None = None
                  ) -> float:
    """Mean PCKh@0.5 over the dataset, as the JAX package's
    eval2d.evaluate_pckh computes it.

    forward_fn(imgs (B, S, S, 3)) -> normalized keypoints (B, num_hypo, 18,
    3) in [-1, 1] (the detector's contract), as a numpy array. Per batch:
    normalized -> patch pixels, H36M's 18 joints -> MPII's 16, the L/R
    switch with the MPII flip pairs per hypothesis, the ``best`` gather
    (per joint the hypothesis nearest the GT) or hypothesis 0, the inverse
    crop affine to original pixels, then keypoint_pckh with the head
    sizes. `points`, when given, receives each batch's (predictions, GT)
    in original pixels, (B, 16, 2) each."""
    from .train.metrics import keypoint_pckh

    num_batches = max(1, len(dataset) // batch_size)
    pckh_sum, count = 0.0, 0
    for b in range(num_batches):
        batch = dataset.batch(b * batch_size, batch_size)
        kps = np.asarray(forward_fn(batch["cam_mono_img"]))  # (B,H,18,3)
        pred = (kps[..., :2] + 1) / 2 * (patch - 1)

        gt = np.asarray(batch["cam_mono_joints"])[..., :2]
        # H36M order -> MPII-16 first (mpii_dataset's GT is MPII-16), then
        # the per-hypothesis switch: both in the same joint indexing
        gt16 = gt[:, S_HM36_2_MPII_JT] if gt.shape[1] == 18 else gt
        sw = np.stack(
            [_switch16(pred[:, h, S_HM36_2_MPII_JT], gt16)
             for h in range(pred.shape[1])], axis=1,
        )  # (B, H, 16, 2)
        if multi_hypo == "best" and sw.shape[1] > 1:
            err = ((sw - gt16[:, None]) ** 2).sum(-1)  # (B, H, 16)
            best = err.argmin(axis=1)  # (B, 16)
            pred16 = np.take_along_axis(
                sw, best[:, None, :, None], axis=1
            )[:, 0]
        else:
            pred16 = sw[:, 0]

        trans = np.asarray(batch["cam_mono_trans_image"])
        inv = np.linalg.inv(
            np.concatenate(
                [trans, np.tile([[0, 0, 1]], (trans.shape[0], 1, 1))], axis=1
            )
        )[:, :2]

        def to_org(p):
            return np.einsum(
                "bij,bkj->bki", inv[:, :, :2], p
            ) + inv[:, None, :, 2]

        head = np.asarray(batch["cam_mono_head_size"])
        pred_org, gt_org = to_org(pred16), to_org(gt16)
        if points is not None:
            points.append((pred_org, gt_org))
        pckh = keypoint_pckh(pred_org, gt_org, head)
        pckh_sum += pckh.sum()
        count += pckh.shape[0]
    return float(pckh_sum / max(count, 1))


def mpii_eval_dataset(config: dict):
    """The config's MPII validation crops (its ``test_image_set``)."""
    from .data.dataloader_2d import mpii_dataset
    from .data.mpii import mpii

    dp, tp = config["dataset_params"], config["train_params"]
    ds = dp["dataset"]
    imdb = mpii(ds.get("test_image_set", "valid"), ds["path"],
                ds.get("mask_path", ds["path"]), tp["patch_width"],
                tp["patch_height"], ds.get("extra_param", ""))
    return mpii_dataset(imdb, patch_size=int(tp["patch_width"]))


def timed_forward(estimator):
    """``forward(imgs)``: (B, S, S, 3) numpy crops -> (B, num_hypo, K, 3)
    fp32 numpy keypoints through `estimator` (serve.PoseEstimator).
    ``forward.step_ms`` lists each call's ms between two CUDA events around
    it (the copies to and from the card included; on the card only)."""
    import torch

    timed = estimator.device.type == "cuda"

    def forward(imgs):
        if timed:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        kps = estimator(imgs).kps_patch
        if timed:
            ev1.record()
            ev1.synchronize()
            forward.step_ms.append(ev0.elapsed_time(ev1))
        return kps

    forward.step_ms = []
    return forward


def run_eval2d(config: dict, checkpoint: str, multi_hypo: str = "best",
               batch_size: int | None = None, device=None):
    """Scores the detector of `checkpoint` on the config's MPII crops and
    writes eval2d_result.txt; returns a namespace of the result, its path,
    the number of batches, each batch's device ms and the wall seconds."""
    from .config import apply_overrides
    from .serve import PoseEstimator

    config = apply_overrides(config, batch_size, None)
    tp = config["train_params"]
    dataset = mpii_eval_dataset(config)
    # the crops go to the detector as mpii_dataset makes them, as the JAX
    # package's eval2d feeds them: without the dataiter's mean and std
    forward = timed_forward(PoseEstimator(
        dict(config, dataset_params={}), checkpoint_path=checkpoint,
        batch_size=int(tp["batch_size"]), device=device))
    t0 = time.perf_counter()
    result = evaluate_pckh(dataset, forward, float(tp["patch_width"]),
                           int(tp["batch_size"]), multi_hypo)
    wall_s = time.perf_counter() - t0
    eval_dir = os.path.join(os.path.dirname(os.path.abspath(checkpoint)),
                            "eval")
    os.makedirs(eval_dir, exist_ok=True)
    out = os.path.join(eval_dir, "eval2d_result.txt")
    with open(out, "w") as f:
        f.write(f"PCKh@0.5: {result}\n")
    print(f"PCKh@0.5: {result}")
    print(f"Results saved in {out}")
    return types.SimpleNamespace(
        result=result, result_path=out, dataset=dataset, forward=forward,
        batch_size=int(tp["batch_size"]),
        num_batches=max(1, len(dataset) // int(tp["batch_size"])),
        step_ms=forward.step_ms, wall_s=wall_s)


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument("--multi_hypo", default="best",
                        choices=["best", "confident"])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    opt = parser.parse_args(argv)
    if opt.checkpoint is None:
        raise SystemExit("Must specify checkpoint path")

    from .config import load_config

    return run_eval2d(load_config(opt.config), opt.checkpoint,
                      opt.multi_hypo, opt.batch_size, opt.device)


if __name__ == "__main__":
    main()
