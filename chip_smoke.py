#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (x_as_supervision_tpu_torch) on one
NVIDIA card: builds the port's kernels, holds each against its plain PyTorch
version at the shapes the serving and training paths give it, drives the
serving path once, takes a few steps of the flagship fused GAN training
step, and trains, checkpoints and evaluates the flagship config through the
port's train and eval CLIs, on the synthetic fixture and on a dataset read
from disk.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which fails the run (nonzero exit, no result line):

1. versions, and the card's name and power limit from nvidia-smi;
2. build: every csrc/*.cu with nvcc for sm_90a, all compilers started
   together; ptxas's registers and spills of the decode forward;
3. kernels: each kernel at the shapes the serving path gives it, in fp32 and
   bf16, against its plain version on the same inputs (fp32 with TF32 off);
   kernel, plain and library times with CUDA events, each case with the
   path it took (link: wgmma and its tile, or FMA; conv3x3: tensor cores or
   CUDA cores); the conv's library time at the kernel's channels-last
   layout, and at NCHW as ``library_nchw_ms``; the decode forward at fp32
   and bf16, B = 32 and 128, each with its launch plan (split, cluster,
   stages), its resident blocks per SM and its share of the bound;
4. serving: PoseEstimator with the HM36_Multi_SurS2 detector (ResNet-50,
   256^2 patches, K=18, D=64, 3 hypotheses) in bf16 at batch 32 on 64 seeded
   images, with seeded weights conditioned for a stable eval forward. The
   launch counts are set to 0 just before this run and read just after it:
   one decode and seven links per forward. Then the card's fp32 path against
   the CPU's plain fp32 path on a few images, and lift_to_world;
5. profile: torch.profiler over one serving call;
6. train: the flagship fused GAN step (x_as_supervision_tpu_torch.train,
   the configuration of __graft_entry__._flagship_config: ResNet-50 at
   256^2, 4 cameras x batch 32, physique [32, 64, 128], the 128-dim
   discriminator, every loss) in bf16 with seeded weights: one warm-up step,
   then 3 timed steps (CUDA events), images per second, peak memory, each
   loss. The launch counts are set to 0 just before the timed steps and read
   just after: per step decode forward 2, decode backward 2, link 14 (all on
   wgmma), physique conv 10 forward + 8 input gradients (14 on tensor
   cores, 4 on CUDA cores). Then a vis step (``with_outputs``, the launches
   of a step) timed against a plain one by CUDA events in turns (plain,
   vis, vis, plain), and the host's logging of it: the one fetch of the
   metrics, the one fetch of the outputs, tb_vis into an event file. Then
   torch.profiler over one more step, with the count of NCHW<->NHWC
   transpose kernels it still runs;
7. train-parity: one fused step of a reduced flagship config (ResNet-50 at
   64^2, 2 cameras, batch 2, D = 16) in fp32 on the card, TF32 off, against
   the same step on the CPU's plain path from the same weights and batch;
8. train-eval: the flagship config written as JSON, trained for one epoch
   through the train CLI (``--synthetic``: 128 samples, 4 steps of 4
   cameras x 32 at 256^2, bf16) to its checkpoint 00000_ckpt, with the
   launches per step of phase 6 (counts set to 0 just before the CLI and
   read just after) and its TensorBoard events read back by
   x_as_supervision_tpu_torch.checks.read_events (every CRC checked; one
   file_version record; at each of the 4 steps the flagship losses, the
   total, smpl_disc and the learning rate; at step 0 only, every tb_vis
   panel, written or counted as skipped where cv2 or matplotlib is
   missing), restored with restore_resume into a fresh state (every tensor
   bitwise equal), then
   scored through the eval CLI in best and in confident mode (4 batches of
   4 cameras x 32): eval images per second from CUDA events around each
   batch's device step, the host's share of the eval's wall time, the
   triangulation's time per batch, the launches per batch (decode 4, link
   28, all on wgmma; the counts set to 0 just before each eval and read just
   after), each batch's pose panels in <run>/eval/tensorboard (written or
   counted as skipped), and eval_result.txt, every number finite; then
   torch.profiler over one more best-mode device step;
9. eval-parity: the train-parity config's detector (conditioned), saved in
   a checkpoint from the card and restored on the card and on the CPU, eval
   in fp32 (TF32 off) on 8 samples in batches of 2 at img_size 64, both
   modes, on the anchored fixture (x_as_supervision_tpu_torch.checks: the
   detections lie near the GT, so the DLT is well posed): the detector's
   raw hypotheses and the normalized outputs within 1e-3, the swap masks
   and hypothesis choices equal or tied (the CPU's two candidate errors
   within 1e-4 relative), the triangulation within 0.25 mm per joint,
   eval_result.txt within 1e-4 relative;
10. real_data: the datasets from disk, without --synthetic. A miniature
   Human3.6M in its own layout (x_as_supervision_tpu_torch/checks.py: 4
   cameras of 1000^2 JPEGs, H36M's frame size, 64 frames of
   s_09_act_02_subact_01 with their SAM masks) and a SURREAL pseudo stream
   of 128 256^2 images, under HM36_Multi_SurS2's dataset_params (the
   ``mini`` image set) and its augmentation (all zero), on the flagship
   config: the index built cold and again from its pickle cache; the train
   CLI for one epoch (64 frames padded by a batch: 96 samples, 3 steps),
   once with the fp32 feed and once with uint8_feed (as the Campaign_XL_*
   configs set it), each with the launches per step of phase 6 by kernel
   and by path, CUDA events around each step, the time each step waits on
   the loader's queue and the time the loader took to make each batch;
   the fp32 run's 00000_ckpt restored bitwise; the loader alone in steady
   state (a warm-up epoch, then 9 batches drained as they come, on the
   train CLI's 10 threads), its ms per batch beside the step's, per feed;
   the eval CLI in both modes with the launches per batch of phase 8 and
   every sample in the act_02 bucket; one batch's host-to-device copy as
   fp32 and as uint8, and the uint8 batch normalized on the card equal to
   the fp32 one; one sample's geodesic maps from the port's own FMM build
   (build/host/). It fails without cv2 or when the FMM does not build;
11. variants: the rest of the multi-view model on the card.
   Campaign_SurS2_percam's model_params (per_camera_bn, the decoupled SAGE
   discriminator; the JSON copy in x_as_supervision_tpu_torch/configs/) at
   the flagship shape in bf16 on synthetic data, then with use_aug, and
   with each of the res_sage_gcn, res_gcn (use_bn) and simple_gcn
   discriminators: 1 warm-up and 2 timed steps each (CUDA events), peak
   memory, every loss finite, and the launches per step by kernel (counts
   set to 0 just before the timed steps): decode 2 + 2, link 56 (one per
   camera slice, all on wgmma), conv3x3 14 + 4. The link on each camera's
   slice of a (128, C, H, W) channels-last batch at 256@16^2 and 512@8^2,
   fp32 and bf16, against its plain version with the kernel phase's
   bounds, and a grouped Bottleneck (4 launches) against the plain grouped
   path. The percam step and a control with pooled statistics each
   profiled over one more step. One fused fp32 step of phase 7's reduced
   config at batch 4 (per camera the images of phase 7's pooled
   statistics) with per_camera_bn, use_aug and res_gcn (use_bn), card
   against CPU with phase 7's bounds; both sides take the same rotation
   uniforms, drawn on the CPU from a seeded generator and passed to
   train_step as rot_draws (the two devices' generators draw different
   bits). The SMPL chain
   (rule_transformation -> smpl_forward -> smpl_to_h36m ->
   project_smpl_to_patch_kps) on a seeded random body model at SMPL's size
   (6890 vertices, 24 joints, 207 pose blend shapes, 10 betas), batch 128,
   card against CPU from the same draws: world vertices within 0.05 mm,
   patch keypoints within 5e-3 patch pixels. Then the percam config (the
   flagship's dataset_params) through the train CLI for one epoch (4
   steps, the launches per step above) to 00000_ckpt, restored bitwise,
   and the eval CLI in best mode (per batch decode 4, link 28: eval uses
   the running statistics);
12. mono: the mono / 2D path. First the kernels at the mono step's own
   shapes, fp32 with TF32 off and bf16, against their plain versions with
   the kernel phase's bounds: the decode backward at (32, 1152, 64, 64),
   the physique conv3x3 at every shape of CONV_SHAPES on 32 masks, the
   link's train-mode gradient on whole batches of 32 at 256@16^2 and
   512@8^2 (the forwards at batch 32 are the kernel phase's serving
   cases). A TikTok fixture in the dataset's layout
   (x_as_supervision_tpu_torch/checks.py:write_mini_tiktok: one training
   video of 136 1080 x 604 PNG frames and masks, 96 samples after the
   dataset's 20 / 20 trim), a 128-image 256^2 SURREAL pseudo stream and an
   MPII fixture (write_mini_mpii: 64 JPEGs at 1280 x 720, SAM-style masks,
   annot/mpii_valid.json, mpii_gt_valid.mat). TikTok_Multi_S1 (its JSON
   copy) trained through ``python -m x_as_supervision_tpu_torch.train2d3d``
   for one epoch, 3 steps of 1 camera x 32 at 256^2 in bf16, to
   00000_ckpt: CUDA events around each step, images per second, peak
   memory, the loader's ms per batch and each step's wait on its queue,
   every loss finite, the launches per step (counts set to 0 just before
   the CLI: those of phase 6). That checkpoint scored through
   ``python -m x_as_supervision_tpu_torch.eval2d`` with MPII_2D (2 batches
   of 32, bf16, through PoseEstimator): eval2d_result.txt with a PCKh in
   [0, 100], the launches per batch (decode 1, link 7, all on wgmma), the
   ms per batch between CUDA events around the estimator's call (its
   copies to and from the card included) and the host's share. PoseEstimator(checkpoint_path=...) on 32 of the crops:
   keypoints equal to eval2d's forward (z exactly, x and y within 1e-5:
   the decode forward's atomic x/y sums are not bit-reproducible), one
   decode and seven links. One
   fp32 step of TikTok_Multi_S1 reduced (ResNet-50 at 64^2, D = 16, batch
   4 of SyntheticMonoDataset) card against CPU with phase 7's bounds; the
   eval2d forward of the checkpoint (conditioned on the crops, as the
   serve phase conditions its weights) in fp32 on 8 crops, card against
   CPU: normalized keypoints 1e-3, the MPII predictions in original pixels
   1e-2 px, both modes.
13. dp: data parallelism. (a) The train CLI under ``python -m
   torch.distributed.run --standalone --nproc_per_node 1`` (one rank,
   NCCL; the rank runs this file's ``dp-rank`` wrapper, which calls the
   CLI's main and records its launch counts and collectives) trains the
   flagship config (4 cameras x 32, bf16, 4 steps) to 00000_ckpt with the
   launches per step of phase 6; the eval CLI under torchrun scores it with
   --reduce_hosts, the launches per batch of phase 8. (b) Two ranks on the
   one card over gloo (NCCL refuses two ranks on one device; gloo
   all-reduces and broadcasts CUDA tensors; whether its CUDA all-gather
   runs is recorded): the fp32 flagship config (TF32 off, phase 7's
   conditioning, cuDNN's deterministic algorithms) at 4 cameras x 16
   global, 8 a rank, against one process
   at the global batch: the generator's gradients (summed over the ranks)
   against one process's on the same code path (a process group of one),
   per tensor relative to its largest entry, within 1e-2 or twice the
   native one-process path's own distance from that process (the rounding
   floor of this random-weight fp32 ResNet-50 at full depth, 1.2-1.5e-2),
   whichever is larger, beside their distance from the native path, a
   rerun's and the relative L2 error; one train step's losses 1e-4 relative to the native path; rank
   1's parameters, running statistics, carried gradient and Adam moments
   bitwise equal to rank 0's (sent by broadcast); and the link's stats on
   each rank's half summed over the ranks within 1e-5 of its stats on the
   whole batch. Before it, the synced BatchNorm's CUDA path (PyTorch's
   fused BatchNorm kernels) against its plain version on the CPU in a
   group of one, fp32 and bf16, pooled and per camera. (c) The cost: one
   rank under torchrun,
   the bf16 flagship step with its collectives against the same step with
   no process group seen, by CUDA events in turns (plain, dp, dp, plain, 3
   steps each), peak memory, the launches of the dp steps (phase 6's), the
   collectives' calls and bytes per step (parallel/collectives.py:COUNTS)
   and one profiled step of each (device time by kernel, busy share, the
   NCCL kernels).

14. tp: tensor parallelism (parallel/tp.py), two model ranks on the one
   card over gloo at (data 1, model 2), the flagship width at 4 cameras x
   16 (the batch cut from 4 x 32: each rank holds the gathered activations
   for its backward, near one process's memory). (a) The kernels at a
   rank's shard shapes against their plain versions, with their bound and
   cuDNN's time: the link at 256 -> 128 on 16^2 and 512 -> 256 on 8^2
   (B = 64, bf16 on wgmma and fp32), the physique's 32 -> 16 conv at 256^2
   (the CUDA-core route). (b) Two ranks (fp32, TF32 off, phase 13's
   conditioning and cuDNN's deterministic algorithms) from phase 13's
   one-process reference state on its batch: the generator's gradients,
   gathered, against the one process on the same code path within 1e-2
   or twice that path's rounding floor, whichever is larger; one train
   step's losses 1e-4 relative; rank 1's replicated gradients and running
   statistics before the step's broadcast from model rank 0
   (tp.replica_drift) within that same bound of each tensor's largest
   entry; the gathered weights after the step within Adam's step bound of
   the one process's (every weight within 2 lr, at most 1e-2 of them
   more than 0.1 lr apart). (c) The
   train CLI under ``torchrun --nproc_per_node 2`` with
   ``model_parallelism: 2`` in the config (bf16, synthetic, 4 steps to
   00000_ckpt; the ranks pick gloo themselves): per rank and step decode
   2 + 2, link 14 on wgmma at the shard's Cout, conv3x3 10 on tensor cores
   and 8 on CUDA cores; the checkpoint scored by the eval CLI in one
   process (phase 8's launches per batch); then two ranks under torchrun
   timing the tensor-parallel step against the one-process step at the
   same 4 x 16, by CUDA events in turns (plain on rank 0 alone, tp,
   plain; one step each after a warm-up of each), with each rank's peak
   memory, launches and collectives (calls and MB by group) per step.

Earlier lines carry the findings as JSON; the line before the last lists the
kernels (launches per training step, per serving forward, per eval batch,
per step on the per-camera path, per mono step, per eval2d batch, per step
of the train CLI under torchrun: ``dp_launches``, and per step of each rank
of the tensor-parallel train CLI: ``tp_launches``), and
the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
SERVE_IMAGES = 64
SERVE_BATCH = 32
PATCH = 256
CONDITION_IMAGES = 16
FP32_CHECK_IMAGES = 4
DETECTOR_PARAMS = dict(name="resnet_multi", num_kp=18, depth_dim=64,
                       num_hypo=3, neighbor_size=15, num_layers=50)
# the fused links of a ResNet-50 forward at 256^2: (Cin=Cout, H=W, per forward)
LINK_SHAPES = ((256, 16, 5), (512, 8, 2))

# H100 SXM published peaks (dense): HBM bytes/s, FLOP/s per operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}

# training: batch 32 per camera, 4 cameras folded into the batch
TRAIN_BATCH = 32
TRAIN_IMAGES = 128
TRAIN_STEPS = 3
# the physique convs of the flagship step at B = 128 (Cin, Cout, input side,
# stride): the forward's distinct shapes, then the stride-1 input gradients'
# shapes that no forward has (Cin and Cout swapped)
CONV_SHAPES = (
    (1, 32, 256, 1), (32, 32, 256, 1), (32, 64, 256, 2), (64, 64, 128, 1),
    (64, 128, 128, 2), (128, 128, 64, 1), (128, 64, 128, 1),
    (64, 32, 256, 1), (32, 1, 256, 1),
    (64, 128, 128, 1), (32, 64, 256, 1),
)
# launches per training step: two detector forwards (cameras, pseudo
# images), each one decode and seven links, each differentiated; the
# physique net's 10 convs and the input gradients of its 8 stride-1 ones
TRAIN_LAUNCHES = {"integral_marginals": 2, "integral_marginals_bwd": 2,
                  "conv_bn_link": 14, "conv3x3": 18}
# the same by path: every bf16 link on wgmma; the physique convs with 32 or
# more channels on both sides on tensor cores (8 forwards, 6 input
# gradients), 1->32, 32->1 and their input gradients on the CUDA cores
TRAIN_PATH_LAUNCHES = {
    "conv_bn_link": {"launches_wgmma": 14, "launches_fma": 0},
    "conv3x3": {"launches_tc": 14, "launches_cuda_core": 4},
}
# launches per eval batch: one detector forward per camera, each one decode
# and seven links (all on wgmma in bf16); no backward, no physique net
EVAL_LAUNCHES = {"integral_marginals": 4, "integral_marginals_bwd": 0,
                 "conv_bn_link": 28, "conv3x3": 0}
EVAL_MODES = ("best", "confident")
# the flagship losses, logged as training_loss/<name> at every log step
FLAGSHIP_LOSSES = ("physique_recons", "reconstruction", "smpl_gen",
                   "smpl_pseudo_img", "symmetry")
# eval parity: samples, batch
PARITY_SAMPLES = 8
PARITY_BATCH = 2
# real data: the on-disk H36M fixture (4 cameras of H36M's 1000^2 frames,
# one sequence of the `mini` policy) and its SURREAL pseudo stream (256^2)
REAL_IMG = 1000
REAL_FRAMES = 64
REAL_PSEUDO = 128
# host-to-device copies of one real batch timed per feed
H2D_REPEATS = 5
# the loader alone: one warm-up epoch, then this many epochs of 3 batches
# (at least its prefetch depth + 5 batches), on the train CLI's threads
LOADER_EPOCHS = 3
LOADER_WORKERS = 10
# the real-data feeds: fp32 images from the host, or uint8_feed
FEEDS = ("fp32", "uint8")

# the per-camera path: Campaign_SurS2_percam at the flagship shape (its JSON
# copy: the card's machine has no yaml); the variants of its
# smpl_disc_params; timed steps after one warm-up
PERCAM_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "x_as_supervision_tpu_torch", "configs",
                             "Campaign_SurS2_percam.json")
VARIANTS = {
    "percam": {},
    "percam_use_aug": {"use_aug": True},
    "percam_res_sage_gcn": {"name": "res_sage_gcn"},
    "percam_res_gcn": {"name": "res_gcn", "use_bn": True},
    "percam_simple_gcn": {"name": "simple_gcn"},
}
VARIANT_STEPS = 2
# launches per step under per-camera BN: the link once per camera slice of
# each train-mode Bottleneck (14 x 4 cameras); the rest as the flagship's
VARIANT_LAUNCHES = dict(TRAIN_LAUNCHES, conv_bn_link=56)
VARIANT_PATH_LAUNCHES = dict(
    TRAIN_PATH_LAUNCHES,
    conv_bn_link={"launches_wgmma": 56, "launches_fma": 0})
CAMERAS = TRAIN_IMAGES // TRAIN_BATCH
# the SMPL chain: SMPL's own size, batch 128
SMPL_VERTS = 6890
SMPL_BATCH = 128

# the mono / 2D path: TikTok_Multi_S1 and MPII_2D (their JSON copies) at
# full width; a TikTok fixture of one training video of 1080 x 604 frames,
# 136 of them: 96 after the dataset's 20 / 20 trim, 3 steps of 32; a
# 128-image 256^2 SURREAL pseudo stream; 64 MPII JPEGs at 1280 x 720
CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "x_as_supervision_tpu_torch", "configs")
TIKTOK_CONFIG = os.path.join(CONFIG_DIR, "TikTok_Multi_S1.json")
MPII_CONFIG = os.path.join(CONFIG_DIR, "MPII_2D.json")
MONO_FRAMES = 136
MONO_FRAME_HW = (1080, 604)
MONO_PSEUDO = 128
MONO_STEPS = 3
MPII_IMAGES = 64
MPII_HW = (720, 1280)
# the fp32 checks of the eval2d forward: this many of the MPII crops
MONO_FP32_IMAGES = 8
# per mono step: the flagship step's launches at one camera x 32 (two
# detector forwards, the physique net, their gradients)
MONO_LAUNCHES = TRAIN_LAUNCHES
MONO_PATH_LAUNCHES = TRAIN_PATH_LAUNCHES
# per eval2d batch of 32: one detector forward
EVAL2D_LAUNCHES = {"integral_marginals": 1, "integral_marginals_bwd": 0,
                   "conv_bn_link": 7, "conv3x3": 0}
MONO_LOSSES = ("physique_recons", "reconstruction", "smpl_gen",
               "smpl_pseudo_img")

# data parallelism: two gloo ranks on the one card at this global batch per
# camera (4 cameras x 16 = 64 fp32 images, 32 per rank: the bf16 step's
# 41.15 GB at 128 images is about 20 GB per 32 fp32 images, so the two
# ranks and the card's other process fit); the one-rank NCCL step's cost in
# turns of this many steps
DP_PAIR_BATCH = 16
DP_COST_STEPS = 3
# tensor parallelism: two model ranks on the one card (data 1), at the dp
# pair's global batch per camera (every image on both ranks); the link at a
# rank's Cout shard, (Cin, Cout / 2, H = W); the physique conv the split
# sends to the CUDA cores, (Cin, Cout / 2, side, stride)
TP_MODEL = 2
TP_BATCH = DP_PAIR_BATCH
TP_COST_STEPS = 1
TP_LINK_SHAPES = ((256, 128, 16), (512, 256, 8))
TP_CONV = (32, 16, 256, 1)
# per rank and step: the flagship step's launches, the physique convs on
# their Cout shards: the forwards 1->16, 32->16, 64->16 and the replicated
# 32->1 with their four input gradients on the CUDA cores, the other six
# forwards and four input gradients on tensor cores
TP_PATH_LAUNCHES = {
    "conv_bn_link": {"launches_wgmma": 14, "launches_fma": 0},
    "conv3x3": {"launches_tc": 10, "launches_cuda_core": 8},
}
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))

KERNELS = {
    "integral_marginals": dict(
        source="x_as_supervision_tpu_torch/csrc/integral_marginals.cu",
        replaces="x_as_supervision_tpu/ops/integral_pallas.py:75"),
    "integral_marginals_bwd": dict(
        source="x_as_supervision_tpu_torch/csrc/integral_marginals_bwd.cu",
        replaces="x_as_supervision_tpu/ops/integral_pallas.py:128"),
    "conv_bn_link": dict(
        source="x_as_supervision_tpu_torch/csrc/conv_bn_link.cu",
        replaces="x_as_supervision_tpu/ops/conv_bn_pallas.py:52"),
    "conv3x3": dict(
        source="x_as_supervision_tpu_torch/csrc/conv3x3.cu",
        replaces="x_as_supervision_tpu/ops/conv_pallas.py:91"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _kind(dtype) -> str:
    return "bf16" if str(dtype) == "torch.bfloat16" else "fp32"


def set_tf32(on: bool) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def set_cudnn_deterministic(on: bool) -> None:
    """cuDNN's deterministic algorithms: a backward that adds in the same
    order every run (the default ones may not: the pair check's rerun)."""
    import torch

    torch.backends.cudnn.deterministic = on


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = dict(torch=torch.__version__, cuda=torch.version.cuda,
                python=sys.version.split()[0],
                kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), nvidia_smi=smi)
    emit(phase="device", **info)
    return info


def phase_build() -> None:
    from x_as_supervision_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(*KERNELS)
    for name in KERNELS:
        _build.load(name)
    emit(phase="build", seconds=time.perf_counter() - t0)
    # ptxas -v of the decode forward: each variant's registers and spills
    out = _build.compiler_output.get("integral_marginals", "not built here")
    emit(phase="ptxas", kernel="integral_marginals",
         lines=[ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln])


def _marginals_case(dtype, batch: int) -> dict:
    import torch

    from x_as_supervision_tpu_torch.ops.integral_kernel import (
        integral_marginals, marginals_kernel_info, marginals_plain,
        marginals_plan)

    k, d = DETECTOR_PARAMS["num_kp"], DETECTOR_PARAMS["depth_dim"]
    side = PATCH // 4
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = (torch.randn((batch, k * d, side, side), generator=gen,
                     device="cuda") * 3).to(dtype)
    got = integral_marginals(x, k)
    want = marginals_plain(x, k)
    torch.cuda.synchronize()
    # marginals are <= 1; fp32 sums in another order and __expf's error
    err = max((g - w).abs().max().item() for g, w in zip(got[:3], want[:3]))
    check(err <= 1e-5, f"marginals kernel {dtype}: max|err| {err} > 1e-5")
    check(torch.equal(got[3], want[3]), "marginals kernel: joint max differs")
    zerr = ((got[4] - want[4]).abs() / want[4]).max().item()
    check(zerr <= 1e-5, f"marginals kernel {dtype}: Z rel err {zerr}")
    del got, want
    outputs = batch * k * (2 * side + d + 2) * 4
    nbytes = x.numel() * x.element_size() + outputs
    flops = 5.0 * x.numel()  # subtract, exp, three marginal adds
    bound, by = bound_ms(nbytes, flops, "fp32")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = marginals_plan(batch, k, d, side, side, dtype, sms)
    ms = cuda_ms(lambda: integral_marginals(x, k), iters=50)
    case = dict(
        name="integral_marginals", dtype=_kind(dtype),
        shape=list(x.shape), max_abs_err=err, z_rel_err=zerr,
        plan=dict(split=plan.split, cluster=plan.split, stages=plan.stages,
                  access_bytes=plan.access_bytes, chunks=plan.chunks,
                  blocks=plan.blocks, waves=plan.waves),
        card=marginals_kernel_info(plan, d, side, side),
        ms=ms, plain_ms=cuda_ms(lambda: marginals_plain(x, k), iters=5),
        library_ms=None, bound_ms=bound, bound_by=by,
        share_of_bound=bound / ms,
    )
    del x
    torch.cuda.empty_cache()
    return case


def _link_case(dtype, batch: int, c: int, side: int,
               cout: int | None = None) -> dict:
    """The link at (batch, c, side, side) into `cout` output channels (c
    by default; fewer: a tensor-parallel rank's Cout shard)."""
    import torch
    import torch.nn.functional as F

    from x_as_supervision_tpu_torch.ops.conv_bn import (
        FMA_TILE, bn_relu_conv_plain, fused_bn_relu_conv, link_tile)

    cout = c if cout is None else cout
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # channels-last, as the serving path's 1x1 conv hands it over
    x = torch.randn((batch, c, side, side), generator=gen, device="cuda").to(
        dtype).contiguous(memory_format=torch.channels_last)
    w = (torch.randn((cout, c, 3, 3), generator=gen, device="cuda")
         * (2 / (9 * c)) ** 0.5).to(dtype)
    scale = torch.rand(c, generator=gen, device="cuda") + 0.5
    shift = torch.randn(c, generator=gen, device="cuda") * 0.1
    y, stats = fused_bn_relu_conv(x, w, scale, shift)
    ry, rstats = bn_relu_conv_plain(x, w, scale, shift)
    torch.cuda.synchronize()
    err = (y.float() - ry.float()).abs().max().item()
    ymax = ry.float().abs().max().item()
    # fp32: products summed in another order; bf16: y is then rounded to
    # bf16, where that order can move it by one step (2^-8 relative)
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * ymax
    check(err <= tol, f"link kernel {dtype} {c}->{cout} at {side}^2: max|err| "
                      f"{err} > {tol}")
    # stats: fp32 sums over B*H*W pixels in another order, so the error is
    # relative to the sum of magnitudes, not to the (cancelling) sum
    yf = ry.float()
    mags = torch.stack([yf.abs().sum(dim=(0, 2, 3)),
                        (yf * yf).sum(dim=(0, 2, 3))])
    serr = ((stats - rstats).abs() / mags.clamp_min(1e-30)).max().item()
    check(serr <= 1e-5, f"link kernel {dtype} {c}->{cout} at {side}^2: stats "
                        f"err {serr} of the sum of magnitudes")
    kind = _kind(dtype)
    elt = x.element_size()
    n = batch * side * side
    # read x, w, scale and shift once, write y and the stats once
    nbytes = (n * (c + cout) * elt + 9 * c * cout * elt + 2 * c * 4
              + 2 * cout * 4)
    flops = 2.0 * n * cout * 9 * c + 3.0 * n * c
    bound, by = bound_ms(nbytes, flops, kind)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = (link_tile(batch, side, side, cout, sms)
            if dtype == torch.bfloat16 else FMA_TILE)
    return dict(
        name="conv_bn_link", dtype=kind, shape=[batch, c, side, side],
        cout=cout,
        path="wgmma" if dtype == torch.bfloat16 else "fma", tile=list(tile),
        max_abs_err=err, stats_rel_err=serr,
        ms=cuda_ms(lambda: fused_bn_relu_conv(x, w, scale, shift)),
        plain_ms=cuda_ms(lambda: bn_relu_conv_plain(x, w, scale, shift)),
        library_ms=cuda_ms(lambda: F.conv2d(x, w, padding=1)),
        bound_ms=bound, bound_by=by,
    )


def _marginals_bwd_case(dtype, batch: int) -> dict:
    import torch

    from x_as_supervision_tpu_torch.ops.integral_kernel import (
        integral_marginals, marginals_backward, marginals_backward_plain)

    k, d = DETECTOR_PARAMS["num_kp"], DETECTOR_PARAMS["depth_dim"]
    side = PATCH // 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = (torch.randn((batch, k * d, side, side), generator=gen,
                     device="cuda") * 3).to(dtype)
    gx, gy, gz = (torch.randn((batch, k, n), generator=gen, device="cuda")
                  for n in (side, side, d))
    ax, ay, az, m, z = integral_marginals(x, k)

    def kernel():
        return marginals_backward(x, m, z, ax, ay, az, gx, gy, gz, k)

    def plain():
        return marginals_backward_plain(x, gx, gy, gz, k)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    # fp32: the same products in another order; bf16: both round the fp32
    # gradient to bf16, which another order can move by one step (2^-8)
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * scale
    check(err <= tol, f"marginals backward kernel {dtype}: max|err| {err} > "
                      f"{tol}")
    del got, want
    joints = batch * k
    # read the logits, write dlogits; the cotangents and per-joint scalars
    nbytes = (2 * x.numel() * x.element_size()
              + joints * (2 * side + d + 3) * 4)
    flops = 6.0 * x.numel()  # subtract, exp, scale, three adds, product
    bound, by = bound_ms(nbytes, flops, "fp32")
    case = dict(
        name="integral_marginals_bwd", dtype=_kind(dtype),
        shape=list(x.shape), max_abs_err=err,
        ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, iters=5),
        library_ms=None, bound_ms=bound, bound_by=by,
    )
    torch.cuda.empty_cache()
    return case


def _conv_case(dtype, batch: int, cin: int, cout: int, side: int,
               stride: int) -> dict:
    import torch
    import torch.nn.functional as F

    from x_as_supervision_tpu_torch.ops.conv3x3 import (
        channels_last, conv3x3_kernel, conv3x3_path, conv3x3_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    # channels-last, as the physique net hands it over
    x = channels_last(torch.randn((batch, cin, side, side), generator=gen,
                                  device="cuda").to(dtype))
    w = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
         * (2 / (9 * cin)) ** 0.5)
    b = torch.randn(cout, generator=gen, device="cuda") * 0.1
    path = conv3x3_path(dtype, cin, cout)
    y = conv3x3_kernel(x, w, b, stride)
    ry = conv3x3_plain(x, w, b, stride)
    torch.cuda.synchronize()
    err = (y.float() - ry.float()).abs().max().item()
    ymax = ry.float().abs().max().item()
    # fp32: the same products summed in another order over 9*Cin terms;
    # bf16: y is then rounded to bf16, one step (2^-8) apart at most
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * ymax
    check(err <= tol, f"conv3x3 kernel {dtype} {cin}->{cout} at {side}^2 "
                      f"s{stride} ({path}): max|err| {err} > {tol}")
    elt = x.element_size()
    out = y.numel()
    nbytes = (x.numel() + out) * elt + w.numel() * elt + cout * 4
    flops = 2.0 * out * cin * 9
    bound, by = bound_ms(nbytes, flops, _kind(dtype))
    wc = w.to(dtype)
    bc = b.to(dtype)
    w_cl = wc.contiguous(memory_format=torch.channels_last)
    x_nchw = x.contiguous()
    case = dict(
        name="conv3x3", dtype=_kind(dtype), path=path,
        shape=[batch, cin, side, side], cout=cout, stride=stride,
        max_abs_err=err,
        ms=cuda_ms(lambda: conv3x3_kernel(x, w, b, stride), iters=10),
        plain_ms=cuda_ms(lambda: conv3x3_plain(x, w, b, stride), iters=10),
        # the yardstick at the kernel's layout (channels-last x and w), and
        # at NCHW, the layout of the earlier NCHW kernel's yardstick
        library_ms=cuda_ms(lambda: F.conv2d(x, w_cl, bc, stride=stride,
                                            padding=1), iters=10),
        library_nchw_ms=cuda_ms(lambda: F.conv2d(x_nchw, wc, bc,
                                                 stride=stride, padding=1),
                                iters=10),
        bound_ms=bound, bound_by=by,
    )
    del x, x_nchw, y, ry
    torch.cuda.empty_cache()
    return case


def _link_grad_case(dtype, batch: int, c: int, side: int) -> dict:
    """The link's train-mode gradient (plain PyTorch around the kernel)
    against autograd of the plain link: no kernel of its own, so no row in
    the kernels line."""
    import torch

    from x_as_supervision_tpu_torch.ops.conv_bn import (
        bn_relu_conv_plain, fused_link)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn((batch, c, side, side), generator=gen, device="cuda").to(
        dtype).contiguous(memory_format=torch.channels_last)
    w = torch.randn((c, c, 3, 3), generator=gen, device="cuda") * (
        2 / (9 * c)) ** 0.5
    scale = torch.rand(c, generator=gen, device="cuda") + 0.5
    shift = torch.randn(c, generator=gen, device="cuda") * 0.1
    gy = torch.randn((batch, c, side, side), generator=gen,
                     device="cuda").to(dtype)
    gs = torch.randn((2, c), generator=gen, device="cuda") * 1e-4

    def grads(fn):
        args = [t.detach().clone().requires_grad_(True)
                for t in (x, w, scale, shift)]
        y, stats = fn(*args)
        return torch.autograd.grad((y, stats), args, (gy, gs))

    got, want = grads(fused_link), grads(bn_relu_conv_plain)
    torch.cuda.synchronize()
    errs, shares = [], []
    for a, r in zip(got, want):
        d = (a.float() - r.float()).abs()
        top = r.float().abs().max().clamp_min(1e-30)
        errs.append((d.max() / top).item())
        shares.append((d > 5e-2 * top).float().mean().item())
    if dtype == torch.float32:
        # relative to each gradient's largest entry: fp32 sums in another
        # order
        check(max(errs) <= 1e-4, f"link gradient fp32 {c}x{side}^2: rel "
                                 f"err {errs}")
    else:
        # bf16: the backward recomputes relu's mask from x*scale+shift in
        # bf16 (the JAX package's compute type), the plain forward in fp32,
        # so where that sum is near 0 the two masks differ; held on the
        # share of entries more than 5 % of the largest apart
        check(max(shares) <= 1e-3, f"link gradient bf16 {c}x{side}^2: "
                                   f"shares off {shares}")
    return dict(name="conv_bn_link_grad", dtype=_kind(dtype),
                shape=[batch, c, side, side], rel_err=errs,
                share_off_5pct=shares,
                ms=cuda_ms(lambda: grads(fused_link), iters=5),
                plain_ms=cuda_ms(lambda: grads(bn_relu_conv_plain), iters=5))


def phase_kernels() -> list[dict]:
    """Every kernel at the serving and training shapes, fp32 with TF32
    off, and bf16."""
    import torch

    cases = []
    set_tf32(False)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(_marginals_case(dtype, SERVE_BATCH))
            for c, side, _ in LINK_SHAPES:
                cases.append(_link_case(dtype, SERVE_BATCH, c, side))
            cases.append(_marginals_bwd_case(dtype, TRAIN_IMAGES))
            for cin, cout, side, stride in CONV_SHAPES:
                cases.append(_conv_case(dtype, TRAIN_IMAGES, cin, cout, side,
                                        stride))
            for c, side, _ in LINK_SHAPES:
                cases.append(_link_grad_case(dtype, TRAIN_IMAGES, c, side))
            torch.cuda.synchronize()
        # the forward kernels at the training step's batch and type, and
        # the decode forward at fp32 there too
        cases.append(_marginals_case(torch.bfloat16, TRAIN_IMAGES))
        cases.append(_marginals_case(torch.float32, TRAIN_IMAGES))
        for c, side, _ in LINK_SHAPES:
            cases.append(_link_case(torch.bfloat16, TRAIN_IMAGES, c, side))
        torch.cuda.synchronize()
    finally:
        set_tf32(True)
    for case in cases:
        emit(phase="kernel", **case)
    return cases


def _calibration(n: int, rng: np.random.Generator) -> dict:
    rot = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                    for _ in range(n)]).astype(np.float32)
    return {
        "trans_image": np.tile(np.array([[0.25, 0.0, 8.0], [0.0, 0.25, 4.0]],
                                        np.float32), (n, 1, 1)),
        "pelvis": rng.uniform(4000, 6000, (n, 3)).astype(np.float32),
        "k_mat": np.tile(np.array([[1145.0, 0, 512], [0, 1144.0, 515],
                                   [0, 0, 1]], np.float32), (n, 1, 1)),
        "rot_world": rot,
        "trans_world": rng.normal(0, 100, (n, 3)).astype(np.float32),
    }


def phase_serve() -> tuple:
    import torch

    from x_as_supervision_tpu_torch import weights
    from x_as_supervision_tpu_torch.models.detector import build_detector
    from x_as_supervision_tpu_torch.ops.conv_bn import fused_bn_relu_conv
    from x_as_supervision_tpu_torch.ops.integral_kernel import (
        integral_marginals)
    from x_as_supervision_tpu_torch.serve import PoseEstimator

    config = {
        "dataset_params": {"cam_id_list": [0, 1, 2, 3], "dataiter": {
            "mean": [0.0, 0.0, 0.0], "std": [255.0, 255.0, 255.0]}},
        "model_params": {"detector_params": DETECTOR_PARAMS},
        "train_params": {"patch_width": PATCH, "patch_height": PATCH},
    }
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (SERVE_IMAGES, PATCH, PATCH, 3),
                          dtype=np.uint8)

    # seeded weights, conditioned on the CPU (train-mode BN statistics)
    t0 = time.perf_counter()
    det = build_detector(DETECTOR_PARAMS)
    weights.init_weights(det, SEED)
    cond = torch.from_numpy(images[:CONDITION_IMAGES]).float().div(255.0)
    weights.condition_for_eval(det, cond.permute(0, 3, 1, 2).contiguous())
    state = det.state_dict()
    setup_s = time.perf_counter() - t0

    est = PoseEstimator(config, det_state=state, batch_size=SERVE_BATCH,
                        dtype=torch.bfloat16, device="cuda")
    est(images)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    integral_marginals.launches = 0
    fused_bn_relu_conv.launches = 0
    fused_bn_relu_conv.launches_wgmma = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    result = est(images)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"integral_marginals": integral_marginals.launches,
                "conv_bn_link": fused_bn_relu_conv.launches,
                "conv_bn_link_wgmma": fused_bn_relu_conv.launches_wgmma}
    forwards = -(-SERVE_IMAGES // SERVE_BATCH)
    device_ms = start.elapsed_time(end)

    kps = result.kps_patch
    want_shape = (SERVE_IMAGES, DETECTOR_PARAMS["num_hypo"],
                  DETECTOR_PARAMS["num_kp"], 3)
    check(kps.shape == want_shape, f"kps shape {kps.shape} != {want_shape}")
    check(result.kps_pixels.shape == want_shape, "pixel shape")
    check(np.isfinite(kps).all() and np.isfinite(result.kps_pixels).all(),
          "non-finite keypoints")
    check(launches["integral_marginals"] == forwards,
          f"decode launches {launches['integral_marginals']} != {forwards}")
    links = forwards * sum(n for _, _, n in LINK_SHAPES)
    check(launches["conv_bn_link"] == links
          and launches["conv_bn_link_wgmma"] == links,
          f"link launches {launches} != {links}, all on wgmma")

    # the card's fp32 path against the CPU's plain fp32 path, TF32 off
    few = images[:FP32_CHECK_IMAGES]
    set_tf32(False)
    try:
        card32 = PoseEstimator(config, det_state=state,
                               batch_size=FP32_CHECK_IMAGES,
                               dtype=torch.float32, device="cuda")
        got32 = card32(few)
    finally:
        set_tf32(True)
    cpu32 = PoseEstimator(config, det_state=state,
                          batch_size=FP32_CHECK_IMAGES, dtype=torch.float32,
                          device="cpu")
    want32 = cpu32(few)
    fp32_err = float(np.abs(got32.kps_patch - want32.kps_patch).max())
    # fp32 through 50 conditioned layers, the head and the decode, summed
    # in other orders: 1e-3 of the [-1, 1] range is 0.13 px at 256^2
    check(fp32_err <= 1e-3, f"card fp32 kps vs CPU: max|err| {fp32_err}")
    # bf16 against that fp32 reference: x, y are smooth expectations and
    # must agree to rounding (5e-3 is 0.64 px at 256^2); the depth
    # hypotheses rank 1-D peaks of a nearly flat random-weight marginal,
    # where bf16 rounding may swap the lower-ranked ones, so those are
    # reported, not held
    bf16_dev = np.abs(kps[:FP32_CHECK_IMAGES] - want32.kps_patch)
    bf16_xy_err = float(bf16_dev[..., :2].max())
    check(bf16_xy_err <= 5e-3, f"card bf16 x/y vs CPU fp32: {bf16_xy_err}")

    cam = _calibration(SERVE_IMAGES, rng)
    world = est.lift_to_world(kps, cam)
    world_cpu = cpu32.lift_to_world(kps, cam)
    check(world.shape == want_shape and np.isfinite(world).all(),
          "lift_to_world: shape or non-finite")
    world_err = float(np.abs(world - world_cpu).max())
    # fp32 world coordinates of a few 1e3 mm
    check(world_err <= 0.1, f"lift_to_world card vs CPU: {world_err} mm")

    record = dict(
        phase="serve", images=SERVE_IMAGES, batch=SERVE_BATCH, patch=PATCH,
        dtype="bf16", forwards=forwards, launches=launches,
        device_ms=device_ms, wall_s=wall_s,
        img_per_s=SERVE_IMAGES / (device_ms / 1e3),
        weights_setup_s=setup_s, fp32_kps_max_err_vs_cpu=fp32_err,
        bf16_xy_max_err_vs_cpu_fp32=bf16_xy_err,
        bf16_hypo0_z_max_err_vs_cpu_fp32=float(bf16_dev[:, 0, :, 2].max()),
        bf16_all_z_max_err_vs_cpu_fp32=float(bf16_dev[..., 2].max()),
        world_max_err_mm_vs_cpu=world_err,
    )
    emit(**record)
    return record, est, images


def phase_profile(est, images, top: int = 15) -> None:
    """Where one serving call's device time goes: torch.profiler over one
    batch, the kernels with the most device time, and the device's busy
    share of the call (sum of kernel and copy times over the call's time
    between two CUDA events, host copies in and out included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = images[:SERVE_BATCH]
    est(batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        est(batch)
        end.record()
        torch.cuda.synchronize()
    window_us = start.elapsed_time(end) * 1e3
    emit(phase="profile", images=len(batch), window_us=window_us,
         **_profile_rows(prof, window_us, top))


def _profile_rows(prof, window_us: float, top: int) -> dict:
    """Device time by kernel from a torch.profiler run: the `top` kernels,
    their sum, and its share of the window between two CUDA events."""
    import torch

    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    return dict(device_busy_us=busy_us,
                busy_share=busy_us / window_us if rows else None,
                top=[dict(name=k[:90], us=d, calls=c)
                     for d, c, k in rows[:top]])


def _layout_transposes(prof) -> dict:
    """The NCHW<->NHWC transpose kernels (cuDNN's nchwToNhwc / nhwcToNchw)
    in a torch.profiler run: launches and device microseconds."""
    import re

    import torch

    pat = re.compile(r"nchw.{0,4}to.{0,4}nhwc|nhwc.{0,4}to.{0,4}nchw", re.I)
    calls, us = 0, 0.0
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and pat.search(e.key)):
            calls += e.count
            dev = getattr(e, "self_device_time_total", None)
            us += dev if dev is not None else getattr(
                e, "self_cuda_time_total", 0.0)
    return dict(calls=calls, us=us)


def _counters() -> dict:
    """The launch-counting wrappers of the four kernels, by kernel name."""
    from x_as_supervision_tpu_torch.ops.conv3x3 import conv3x3_kernel
    from x_as_supervision_tpu_torch.ops.conv_bn import fused_bn_relu_conv
    from x_as_supervision_tpu_torch.ops.integral_kernel import (
        integral_marginals, marginals_backward)

    return {"integral_marginals": integral_marginals,
            "integral_marginals_bwd": marginals_backward,
            "conv_bn_link": fused_bn_relu_conv, "conv3x3": conv3x3_kernel}


def _gan(config: dict, dtype, device: str, seed: int):
    """The GAN of `config` with seeded weights on `device`, and its train
    state."""
    from x_as_supervision_tpu_torch import weights
    from x_as_supervision_tpu_torch.train.factory import build_gan_spec
    from x_as_supervision_tpu_torch.train.state import TrainState

    spec = build_gan_spec(config, dtype)
    for i, module in enumerate((spec.detector, spec.physique,
                                spec.discriminator)):
        weights.init_weights(module, seed + i)
        module.to(device)
    return spec, TrainState(spec, config["train_params"], steps_per_epoch=10)


def _named_params(state) -> dict:
    return dict(zip(state.gen_names + ["discriminator." + n
                                       for n in state.disc_names],
                    state.gen_params + state.disc_params))


def phase_train(top: int = 15) -> dict:
    """The flagship fused GAN step on the card in bf16 (see the module
    docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
    from x_as_supervision_tpu_torch.train.factory import flagship_config
    from x_as_supervision_tpu_torch.train.state import train_step
    from x_as_supervision_tpu_torch.train.trainer import (
        step_generator, to_device)

    cfg = flagship_config()
    cams = cfg["dataset_params"]["cam_id_list"]
    check(TRAIN_BATCH * len(cams) == TRAIN_IMAGES, "train batch shape")
    t0 = time.perf_counter()
    spec, state = _gan(cfg, torch.bfloat16, "cuda", SEED)
    ds = SyntheticPoseDataset(num_samples=TRAIN_BATCH * (TRAIN_STEPS + 2),
                              cam_id_list=cams, patch_size=PATCH, seed=SEED)
    host_batches = [ds.batch(i * TRAIN_BATCH, TRAIN_BATCH)
                    for i in range(TRAIN_STEPS + 2)]
    batches = [to_device(b, "cuda") for b in host_batches]
    setup_s = time.perf_counter() - t0
    start = {n: p.detach().clone() for n, p in _named_params(state).items()}

    def step(i, with_outputs=False):
        return train_step(state, batches[i], step_generator(SEED, i, "cuda"),
                          with_outputs=with_outputs)

    step(0)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    counters = _counters()
    for name, fn in counters.items():
        fn.launches = 0
        for attr in TRAIN_PATH_LAUNCHES.get(name, ()):
            setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_STEPS)]
    history = []
    t0 = time.perf_counter()
    for i, (ev0, ev1) in enumerate(events, start=1):
        ev0.record()
        metrics = step(i)
        ev1.record()
        history.append(metrics)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    path_launches = {name: {attr: getattr(counters[name], attr)
                            for attr in attrs}
                     for name, attrs in TRAIN_PATH_LAUNCHES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [a.elapsed_time(b) for a, b in events]
    losses = [{k: float(v) for k, v in sorted(m.items())} for m in history]

    for m in losses:
        check(len(m) == 7 and all(np.isfinite(v) for v in m.values()),
              f"train: missing or non-finite losses {m}")
    moved = {n: (p.detach() - start[n]).abs().max().item()
             for n, p in _named_params(state).items()}
    unmoved = [n for n, d in moved.items() if d == 0]
    check(not unmoved, f"train: parameters that did not move: {unmoved}")
    for name, per_step in TRAIN_LAUNCHES.items():
        check(launches[name] == per_step * TRAIN_STEPS,
              f"train: {name} launched {launches[name]} times in "
              f"{TRAIN_STEPS} steps, expected {per_step} per step")
    for name, attrs in TRAIN_PATH_LAUNCHES.items():
        for attr, per_step in attrs.items():
            check(path_launches[name][attr] == per_step * TRAIN_STEPS,
                  f"train: {name}.{attr} = {path_launches[name][attr]} in "
                  f"{TRAIN_STEPS} steps, expected {per_step} per step")

    vis = _vis_step(cfg, step, host_batches, counters)

    # one more step under the profiler
    ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev0.record()
        step(TRAIN_STEPS + 1)
        ev1.record()
        torch.cuda.synchronize()
    window_us = ev0.elapsed_time(ev1) * 1e3
    record = dict(
        phase="train", config="flagship (__graft_entry__._flagship_config)",
        images_per_step=TRAIN_IMAGES, batch=TRAIN_BATCH, cameras=len(cams),
        patch=PATCH, dtype="bf16", steps=TRAIN_STEPS, step_ms=step_ms,
        mean_step_ms=sum(step_ms) / len(step_ms),
        img_per_s=TRAIN_IMAGES / (sum(step_ms) / len(step_ms) / 1e3),
        wall_s=wall_s, setup_s=setup_s, peak_memory_gb=peak_gb,
        launches=launches,
        launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
        path_launches_per_step={
            name: {a: v / TRAIN_STEPS for a, v in attrs.items()}
            for name, attrs in path_launches.items()},
        losses=losses, params_unmoved=unmoved,
        max_param_change=max(moved.values()), vis_step=vis,
    )
    emit(**record)
    emit(phase="train_profile", window_us=window_us,
         layout_transposes=_layout_transposes(prof),
         **_profile_rows(prof, window_us, top))
    return record


def _vis_step(cfg: dict, step, host_batches, counters) -> dict:
    """A steady-state step with the visualization outputs (a vis step of a
    logging run) against one without, by CUDA events in turns (plain, vis,
    vis, plain) after one warm-up of each, with the launches of a vis step;
    then the host's logging of that step: the one fetch of the metrics, the
    one fetch of the outputs and tb_vis's scalars and panels into an event
    file."""
    import tempfile

    import torch

    from x_as_supervision_tpu_torch.checks import events_in
    from x_as_supervision_tpu_torch.train.evaluator import fetch
    from x_as_supervision_tpu_torch.train.logging import (SummaryWriter,
                                                          tb_vis)

    step(1, with_outputs=True)
    step(2)
    torch.cuda.synchronize()
    _reset_counts()
    metrics, outputs = step(3, with_outputs=True)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, per_step in TRAIN_LAUNCHES.items():
        check(launches[name] == per_step,
              f"vis step: {name} launched {launches[name]} times, expected "
              f"{per_step}")
    times = {"plain": [], "vis": []}
    for kind in ("plain", "vis", "vis", "plain"):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        ev0.record()
        step(2 if kind == "plain" else 3, with_outputs=kind == "vis")
        ev1.record()
        torch.cuda.synchronize()
        times[kind].append(ev0.elapsed_time(ev1))

    mp = cfg["model_params"]
    with tempfile.TemporaryDirectory() as d:
        writer = SummaryWriter(d)
        t0 = time.perf_counter()
        keys = sorted(metrics)
        packed = torch.stack([metrics[k].float().mean()
                              for k in keys]).cpu().numpy()
        fetched = dict(zip(keys, packed))
        t1 = time.perf_counter()
        outs = fetch(outputs)
        t2 = time.perf_counter()
        tb_vis(writer, 0, np.array(mp["flip_pairs"]),
               np.array(mp["parent_ids"]), fetched["loss_total"],
               {k[5:]: v for k, v in fetched.items()
                if k.startswith("loss/")},
               fetched["loss_disc"], outs, host_batches[3], cfg,
               detector_lr=1e-4)
        writer.close()
        t3 = time.perf_counter()
        (events,) = events_in(d).values()
        event_bytes = sum(os.path.getsize(os.path.join(d, f))
                          for f in os.listdir(d))
    panels = sorted(t for e in events for t in e["images"])
    check(all(np.isfinite(v) for e in events for v in e["scalars"].values()),
          "vis step: a non-finite scalar")
    # per camera 7 of the generator and 4 of the discriminator; the depth
    # map of camera 0 and the GT world pose
    check(len(outs) == 11 * len(cfg["dataset_params"]["cam_id_list"]) + 2,
          f"vis step: {len(outs)} outputs {sorted(outs)}")
    record = dict(step_ms=times, launches=launches,
                  extra_ms=(sum(times["vis"]) - sum(times["plain"])) / 2,
                  fetch_metrics_ms=(t1 - t0) * 1e3,
                  fetch_outputs_ms=(t2 - t1) * 1e3,
                  tb_vis_host_ms=(t3 - t2) * 1e3,
                  outputs=len(outs), panels=len(panels),
                  skipped=dict(writer.skipped), event_bytes=event_bytes)
    emit(phase="vis_step", **record)
    return record


def _parity_config() -> dict:
    """The flagship config reduced for card-vs-CPU checks: ResNet-50 at
    64^2, 2 cameras, batch 2, D = 16."""
    from x_as_supervision_tpu_torch.train.factory import flagship_config

    cfg = flagship_config()
    mp, tp = cfg["model_params"], cfg["train_params"]
    cfg["dataset_params"]["cam_id_list"] = mp["cam_id_list"] = [0, 1]
    mp["detector_params"]["depth_dim"] = 16
    tp["patch_width"] = tp["patch_height"] = 64
    tp["batch_size"] = PARITY_BATCH
    return cfg


def _dropout_off(disc) -> None:
    """The discriminator's dropout off (each kind keeps its own p)."""
    if hasattr(disc, "header") and hasattr(disc.header, "p_dropout"):
        disc.header.p_dropout = 0.0
    if hasattr(disc, "p_dropout"):
        disc.p_dropout = 0.0


def phase_train_parity() -> dict:
    """One fused step of a reduced flagship config in fp32 on the card
    (TF32 off) against the CPU's plain path, from the same weights and
    batch. Dropout is off on both sides: the two devices' generators draw
    different bits."""
    return _train_parity(_parity_config(), "train_parity",
                         "flagship reduced: ResNet-50 at 64^2, 2 cameras, "
                         "batch 2, D = 16")


def _train_parity(cfg: dict, phase: str, config: str,
                  rot_draws: dict | None = None, batch=None) -> dict:
    """phase_train_parity's step and checks for `cfg`; `rot_draws` (CPU
    tensors) are use_aug's uniforms, the same on both sides; `batch` (numpy)
    replaces the synthetic two-camera batch."""
    import torch

    from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
    from x_as_supervision_tpu_torch.models.composed import generator_forward
    from x_as_supervision_tpu_torch.models.resnet import Bottleneck
    from x_as_supervision_tpu_torch.train.state import train_step
    from x_as_supervision_tpu_torch.train.trainer import to_device

    def draws(device):
        return (None if rot_draws is None else
                {k: v.to(device) for k, v in rot_draws.items()})

    def gen_grads(spec, state, batch):
        rot_u = None if rot_draws is None else draws(batch[
            "cam_0_img"].device)["gen"]
        losses, decode = generator_forward(spec, batch, rot_u=rot_u)
        total = sum(v.mean() for v in losses.values())
        grads = torch.autograd.grad(total, state.gen_params
                                    + state.disc_params, allow_unused=True)
        return dict(zip(_named_params(state), grads)), decode.kps.detach()

    lr = float(cfg["train_params"]["lr_kp_detector"])
    b = cfg["train_params"]["batch_size"]
    if batch is None:
        batch = SyntheticPoseDataset(num_samples=b, cam_id_list=(0, 1),
                                     patch_size=64, seed=SEED).batch(0, b)
    cpu_spec, cpu_state = _gan(cfg, torch.float32, "cpu", SEED)
    card_spec, card_state = _gan(cfg, torch.float32, "cuda", SEED)
    # a random-weight ResNet-50 in train mode at 64^2 (BatchNorm over 16
    # values in its last stage) is chaotic: a 1e-6 relative change of the
    # input images moves the CPU's own gradients by up to 30 % of their
    # largest entries. Residual branches scaled down as in the serving
    # phase's conditioning (last BN scale 0.1) make it near-linear.
    with torch.no_grad():
        for m in cpu_spec.detector.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.fill_(0.1)
    for name in ("detector", "physique", "discriminator"):
        getattr(card_spec, name).load_state_dict(
            getattr(cpu_spec, name).state_dict())
    for spec in (cpu_spec, card_spec):
        _dropout_off(spec.discriminator)
    cancelled = {"physique." + n
                 for n in card_spec.physique.bn_cancelled_biases()}
    if hasattr(card_spec.discriminator, "bn_cancelled_biases"):
        cancelled |= {"discriminator." + n for n in
                      card_spec.discriminator.bn_cancelled_biases()}
    before = {n: p.detach().clone()
              for n, p in _named_params(cpu_state).items()}
    cpu_batch, card_batch = to_device(batch, "cpu"), to_device(batch, "cuda")
    want_g, want_kps = gen_grads(cpu_spec, cpu_state, cpu_batch)
    set_tf32(False)
    try:
        got_g, got_kps = gen_grads(card_spec, card_state, card_batch)
        torch.cuda.synchronize()
    finally:
        set_tf32(True)
    grad_err = {}
    for n, w in want_g.items():
        if w is None or n in cancelled or w.abs().max() == 0:
            continue
        grad_err[n] = ((got_g[n].cpu() - w).abs().max()
                       / w.abs().max()).item()
    worst_grad = max(grad_err, key=grad_err.get)
    kps_err = (got_kps.cpu() - want_kps).abs().amax(dim=(0, 2)).tolist()
    emit(phase=f"{phase}_grads", kps_max_err_by_hypo_and_coord=kps_err,
         worst=sorted(grad_err.items(), key=lambda kv: -kv[1])[:12])
    # the generator's gradient, per tensor, relative to its largest entry:
    # fp32 through the conditioned ResNet-50 (kernels and cuDNN on the card,
    # the plain versions on the CPU) summed in other orders (the first
    # conditioned card run: 1.3e-3 at most); a wrong backward is off by O(1)
    check(grad_err[worst_grad] <= 1e-2,
          f"{phase}: gradient of {worst_grad} off by "
          f"{grad_err[worst_grad]} of its largest entry")
    want = train_step(cpu_state, cpu_batch, rot_draws=draws("cpu"))
    set_tf32(False)
    try:
        got = train_step(card_state, card_batch, rot_draws=draws("cuda"))
        torch.cuda.synchronize()
    finally:
        set_tf32(True)
    loss_err = {k: abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
                for k in want}
    # fp32 through ResNet-50, the decode, the renderer and the physique
    # net, convs and sums in other orders
    check(max(loss_err.values()) <= 1e-4,
          f"{phase}: loss rel err {loss_err}")
    want_p = _named_params(cpu_state)
    diffs, largest_update = [], 0.0
    for n, p in _named_params(card_state).items():
        if n in cancelled:
            continue
        diffs.append((p.detach().cpu() - want_p[n].detach()).abs().flatten())
        largest_update = max(largest_update,
                             (want_p[n].detach() - before[n]).abs().max().item())
    d = torch.cat(diffs)
    ratio = d.max().item() / largest_update
    median = d.median().item() / largest_update
    over = (d > 0.1 * largest_update).float().mean().item()
    # Adam's first step is lr * g / (|g| + 1e-8): a weight whose gradient is
    # within rounding of 1e-8 moves by an amount that rounding decides (up
    # to a step either way), so the largest difference can reach two steps;
    # the bulk agrees to rounding (conditioned as above, the card runs read
    # a largest difference of 1.006 steps and 2e-6 of the weights more than
    # a tenth of a step apart)
    check(ratio <= 2.05 and median <= 1e-3 and over <= 1e-3,
          f"{phase}: params max|d|/update {ratio}, median {median}, "
          f"share over 0.1 {over}")
    stats_err = 0.0
    for name in ("detector", "physique"):
        card_sd = getattr(card_spec, name).state_dict()
        for k, v in getattr(cpu_spec, name).state_dict().items():
            if "running" in k:
                stats_err = max(stats_err, ((card_sd[k].cpu() - v).abs()
                                            / (v.abs() + 2 * lr)).max().item())
    # fp32 batch statistics of the same activations; a running mean behind
    # a cancelled physique bias moves with that bias (up to a step)
    check(stats_err <= 1e-2, f"{phase}: running stats rel err {stats_err}")
    record = dict(phase=phase, dtype="fp32", config=config,
                  loss_rel_err=loss_err,
                  grad_max_rel_err=grad_err[worst_grad],
                  grad_worst_tensor=worst_grad,
                  largest_update=largest_update,
                  param_max_diff_over_largest_update=ratio,
                  param_median_diff_over_largest_update=median,
                  param_share_over_tenth_update=over,
                  running_stats_rel_err=stats_err)
    emit(**record)
    return record


def _reset_counts() -> None:
    """Every launch count to 0, by kernel and by path."""
    for name, fn in _counters().items():
        fn.launches = 0
        for attr in TRAIN_PATH_LAUNCHES.get(name, ()):
            setattr(fn, attr, 0)


def _check_train_launches(steps: int, what: str,
                          want: dict = TRAIN_LAUNCHES,
                          want_paths: dict = TRAIN_PATH_LAUNCHES
                          ) -> tuple[dict, dict]:
    """The launches since _reset_counts, checked against `want` and
    `want_paths` (by default the flagship step's) per step over `steps`
    steps; returns them per step, by kernel and by path."""
    counters = _counters()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, per_step in want.items():
        check(launches[name] == per_step * steps,
              f"{what}: {name} launched {launches[name]} times in {steps} "
              f"steps, expected {per_step} per step")
    paths = {}
    for name, attrs in want_paths.items():
        paths[name] = {}
        for attr, per_step in attrs.items():
            got = getattr(counters[name], attr)
            check(got == per_step * steps,
                  f"{what}: {name}.{attr} = {got} in {steps} steps, "
                  f"expected {per_step} per step")
            paths[name][attr] = got / steps
    return {k: v / steps for k, v in launches.items()}, paths


def _check_restore(cfg: dict, path: str, trainer) -> int:
    """restore_resume of the checkpoint at `path` into a fresh state: every
    tensor and count bitwise equal to the file and to the trainer's state.
    Returns the number of tensors."""
    import torch

    from x_as_supervision_tpu_torch.checks import bitwise_diffs, flat
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt

    _, fresh = _gan(cfg, torch.bfloat16, "cuda", SEED + 7)
    ckpt.restore_resume(path, fresh)
    restored = flat(ckpt.state_dict(fresh))
    saved = flat(ckpt.load_raw(path, "cuda"))
    live = flat(ckpt.state_dict(trainer.state))
    bad = bitwise_diffs(restored, saved) + bitwise_diffs(restored, live)
    check(not bad, f"restore_resume: differs from the saved state at "
                   f"{bad[:8]}")
    n_tensors = sum(torch.is_tensor(v) for v in restored.values())
    del fresh, restored, saved, live
    torch.cuda.empty_cache()
    return n_tensors


def _eval_cli(cfg_path: str, path: str, mode: str, synthetic: bool):
    """The eval CLI on the checkpoint at `path` in `mode`, its launches per
    batch checked (counts set to 0 just before it and read just after), its
    panels and eval_result.txt read back; returns the Evaluator and the
    mode's record."""
    import torch

    from x_as_supervision_tpu_torch.checks import result_lines
    from x_as_supervision_tpu_torch.eval.__main__ import main as eval_main
    from x_as_supervision_tpu_torch.ops.conv_bn import fused_bn_relu_conv

    counters = _counters()
    _reset_counts()
    ev = eval_main(["--config", cfg_path, "--checkpoint", path,
                    "--multi_hypo", mode]
                   + (["--synthetic"] if synthetic else []))
    torch.cuda.synchronize()
    nb = ev.num_batches
    launches = {name: fn.launches for name, fn in counters.items()}
    wgmma = fused_bn_relu_conv.launches_wgmma
    for name, per_batch in EVAL_LAUNCHES.items():
        check(launches[name] == per_batch * nb,
              f"eval {mode}: {name} launched {launches[name]} times "
              f"in {nb} batches, expected {per_batch} per batch")
    check(wgmma == EVAL_LAUNCHES["conv_bn_link"] * nb,
          f"eval {mode}: {wgmma} links on wgmma of {launches}")
    eval_events = _eval_events(ev, mode)
    lines = result_lines(ev.result_path)
    check(len(lines) == 15 and all(
        v is None or np.isfinite(v) for _, v in lines),
        f"eval {mode}: eval_result.txt {lines}")
    images = nb * ev.batch_size * len(ev.cam_id_list)
    step_s = sum(ev.step_ms) / 1e3
    steady = ev.step_ms[1:]
    return ev, dict(
        batches=nb, images=images, step_ms=ev.step_ms,
        img_per_s=images / step_s,
        steady_img_per_s=(len(steady) * images / nb
                          / (sum(steady) / 1e3)),
        wall_s=ev.wall_s, host_share=1.0 - step_s / ev.wall_s,
        launches_per_batch={k: v / nb for k, v in launches.items()},
        wgmma_per_batch=wgmma / nb,
        panels_per_batch=eval_events["panels_per_batch"],
        panels_skipped=eval_events["skipped"],
        ambiguity_ratio=ev.last_ambiguity_ratio,
        eval_result=[f"{k}: {v}" if v is not None else k
                     for k, v in lines])


def phase_train_eval() -> dict:
    """train CLI -> 00000_ckpt -> restore_resume -> eval CLI in both modes,
    the flagship config at full width (see the module docstring)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from x_as_supervision_tpu_torch.ops import geometry as G
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt
    from x_as_supervision_tpu_torch.train.__main__ import main as train_main
    from x_as_supervision_tpu_torch.train.factory import flagship_config

    with tempfile.TemporaryDirectory() as root:
        cfg = flagship_config()
        cfg["train_params"].update(num_epochs=1, checkpoint_freq=1)
        cfg_path = os.path.join(root, "flagship.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        log_dir = os.path.join(root, "log")
        _reset_counts()
        t0 = time.perf_counter()
        trainer = train_main(["--config", cfg_path, "--synthetic", "--seed",
                              str(SEED), "--log_dir", log_dir])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        steps = TRAIN_IMAGES // TRAIN_BATCH
        check(trainer.state.step == steps,
              f"train CLI: {trainer.state.step} steps, expected {steps}")
        train_launches, _ = _check_train_launches(steps, "train CLI")
        (run,) = os.listdir(log_dir)
        path = os.path.join(log_dir, run, "00000_ckpt")
        check(sorted(os.listdir(os.path.join(log_dir, run)))
              == ["00000_ckpt", "flagship.json", "tensorboard"],
              f"train CLI: run directory holds {os.listdir(log_dir)}")
        train_events = _train_events(
            cfg, os.path.join(log_dir, run, "tensorboard"), trainer, steps)
        ckpt_mb = os.path.getsize(os.path.join(path, ckpt.STATE_FILE)) / 1e6

        n_tensors = _check_restore(cfg, path, trainer)
        del trainer
        torch.cuda.empty_cache()

        modes = {}
        for mode in EVAL_MODES:
            ev, modes[mode] = _eval_cli(cfg_path, path, mode, synthetic=True)

        # the triangulation of one batch, on the card
        batch = ev.to_device(ev.dataset.batch(0, ev.batch_size))
        check(ev.step(batch, "best")["tri"].device.type == "cuda",
              "triangulation left the card")
        cams, side = ev.cam_id_list, batch["cam_0_img"].shape[-2]
        kp = {ck: c["kp"] for ck, c in ev.predict(batch, "best")[1].items()}
        tri_ms = cuda_ms(lambda: G.triangulation(kp, batch, cams, side),
                         iters=20)
        # where one best-mode device step's time goes
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ev0.record()
            ev.step(batch, "best")
            ev1.record()
            torch.cuda.synchronize()
        window_us = ev0.elapsed_time(ev1) * 1e3
        emit(phase="eval_profile", images=ev.batch_size * len(cams),
             window_us=window_us, **_profile_rows(prof, window_us, 15))
        del ev, batch, kp
        torch.cuda.empty_cache()
    record = dict(phase="train_eval", config="flagship, num_epochs 1, "
                  "checkpoint_freq 1 (JSON)", train_cli_s=train_s,
                  train_launches_per_step=train_launches,
                  train_events=train_events,
                  checkpoint_mb=ckpt_mb, restored_tensors=n_tensors,
                  triangulation_ms=tri_ms, modes=modes)
    emit(**record)
    return record


def phase_real_data(card: str) -> dict:
    """The flagship config on the on-disk H36M fixture, without --synthetic:
    train CLI -> 00000_ckpt -> eval CLI in both modes, the loader's wait
    and the host-to-device copy per batch, the uint8 feed on the card, and
    one sample's geodesic maps from the port's FMM build (see the module
    docstring). `card`: nvidia-smi's name and power limit, for the record."""
    import copy
    import tempfile

    import torch

    from x_as_supervision_tpu_torch import checks
    from x_as_supervision_tpu_torch.data import geodesic
    from x_as_supervision_tpu_torch.data.factory import basic_data
    from x_as_supervision_tpu_torch.data.hm36 import hm36
    from x_as_supervision_tpu_torch.models.composed import preprocess_batch
    from x_as_supervision_tpu_torch.ops import _build
    from x_as_supervision_tpu_torch.train import trainer as trainer_mod
    from x_as_supervision_tpu_torch.train.factory import (build_gan_spec,
                                                          flagship_config)

    try:
        import cv2
    except ImportError:
        raise SmokeFailure("real_data: cv2 is not installed; the real "
                           "datasets read their images with it") from None

    with tempfile.TemporaryDirectory(prefix="xas_real_") as root:
        t0 = time.perf_counter()
        checks.write_mini_h36m(root, img_size=REAL_IMG, n_frames=REAL_FRAMES,
                               seed=SEED)
        checks.write_surreal_pseudo(
            os.path.join(root, "surreal_h36m_pose"), REAL_PSEUDO,
            seed=SEED + 1, size=PATCH)
        fixture_s = time.perf_counter() - t0

        cfg = flagship_config()
        cfg["dataset_params"] = checks.hm36_dataset_params(root)
        cfg["train_params"].update(num_epochs=1, checkpoint_freq=1,
                                   aug=dict(checks.NO_AUG))
        cfgs = {}
        for feed in FEEDS:
            cfgs[feed] = copy.deepcopy(cfg)
            cfgs[feed]["dataset_params"]["uint8_feed"] = feed == "uint8"

        # the index: parsed meta files, then its pickle cache
        index = []
        for _ in range(2):
            t0 = time.perf_counter()
            db = hm36("mini", cfg["dataset_params"]["dataset"]["path"],
                      PATCH, PATCH, 2000, 2000, "").gt_db()
            index.append(time.perf_counter() - t0)
            check(len(db) == REAL_FRAMES,
                  f"real_data: index of {len(db)} frames")

        # the train CLI, with the fp32 feed and with uint8_feed (as the
        # Campaign_XL_* configs set it)
        runs, cfg_paths = {}, {}
        for feed in FEEDS:
            cfg_paths[feed] = os.path.join(root, f"flagship_real_{feed}.json")
            with open(cfg_paths[feed], "w") as f:
                json.dump(cfgs[feed], f)
            log_dir = os.path.join(root, f"log_{feed}")
            _reset_counts()
            trainer, run = _timed_train_cli(cfg_paths[feed], log_dir)
            what = f"real_data train CLI ({feed} feed)"
            dataset = trainer.dataset
            steps = len(dataset) // TRAIN_BATCH
            check(type(dataset).__name__ == "hm36_Dataset" and steps == 3
                  and dataset.uint8_feed == (feed == "uint8"),
                  f"{what}: {type(dataset).__name__} of {len(dataset)} "
                  f"samples, {steps} steps, uint8_feed "
                  f"{dataset.uint8_feed}")
            check(trainer.state.step == steps,
                  f"{what}: {trainer.state.step} steps, expected {steps}")
            run["launches_per_step"], run["path_launches_per_step"] = \
                _check_train_launches(steps, what)
            check(len(run["loader_wait_ms"]) == len(run["step_ms"]) == steps
                  == len(trainer.loader.batch_seconds),
                  f"{what}: {len(run['loader_wait_ms'])} waits, "
                  f"{len(run['step_ms'])} steps timed, "
                  f"{len(trainer.loader.batch_seconds)} batches made")
            run["batch_made_ms"] = [t * 1e3
                                    for t in trainer.loader.batch_seconds]
            run["losses"] = trainer.history
            if feed == "fp32":
                (name,) = os.listdir(log_dir)
                path = os.path.join(log_dir, name, "00000_ckpt")
                run["restored_tensors"] = _check_restore(cfgs[feed], path,
                                                         trainer)
            runs[feed] = run
            del trainer
            torch.cuda.empty_cache()

        # the loader alone, after a warm-up epoch: how long it takes to make
        # a batch in steady state, beside the step it has to keep up with
        loader, datasets = {}, {}
        for feed in FEEDS:
            datasets[feed] = basic_data(cfgs[feed])
            made = _loader_batch_ms(datasets[feed])
            steady_step = runs[feed]["step_ms"][1:]
            loader[feed] = dict(
                batch_ms=made, mean_batch_ms=float(np.mean(made)),
                mean_step_ms=float(np.mean(steady_step)),
                sets_the_pace=bool(np.mean(made) > np.mean(steady_step)))

        modes = {}
        for mode in EVAL_MODES:
            ev, modes[mode] = _eval_cli(cfg_paths["fp32"], path, mode,
                                        synthetic=False)
            check(type(ev.dataset).__name__ == "hm36_Dataset"
                  and not ev.dataset.is_train,
                  f"real_data eval: {type(ev.dataset).__name__}")
            # every frame is s_09_act_02: the act_02 (Directions) bucket
            # holds every sample, the other actions none
            cnt2d = ev.tables[1]
            want = modes[mode]["images"]
            check(cnt2d["Directions"] == want
                  and sum(cnt2d.values()) == want
                  and np.isfinite(ev.tables[0]["Directions"]),
                  f"real_data eval {mode}: act table {cnt2d}")
            modes[mode]["act_02_2d_mse"] = ev.tables[0]["Directions"]
            del ev

        # one batch's host-to-device copy, fp32 and uint8 feed (pageable,
        # as trainer.to_device copies)
        feeds = {feed: datasets[feed].batch(0, TRAIN_BATCH)
                 for feed in FEEDS}
        h2d = {}
        for name, batch in feeds.items():
            times = []
            for _ in range(H2D_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dev = trainer_mod.to_device(batch, "cuda")
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            h2d[name] = dict(
                ms=times, mb=sum(v.numel() * v.element_size()
                                 for v in dev.values()) / 1e6)
        # the uint8 feed normalized on the card equals the fp32 feed
        spec = build_gan_spec(cfgs["uint8"])
        fp32 = trainer_mod.to_device(feeds["fp32"], "cuda")
        pre = preprocess_batch(trainer_mod.to_device(feeds["uint8"], "cuda"),
                               spec)
        check(pre.keys() == fp32.keys(), "real_data uint8: keys differ")
        unequal = [k for k in fp32 if not torch.equal(pre[k], fp32[k])]
        check(not unequal, f"real_data uint8: {unequal} differ from fp32")
        del spec, fp32, pre, feeds

        # one sample with geodesic maps, from the port's FMM build
        cfg_g = copy.deepcopy(cfg)
        cfg_g["dataset_params"]["compute_geodesic"] = True
        t0 = time.perf_counter()
        lib = geodesic.fmm_library()
        fmm_build_s = time.perf_counter() - t0
        ds_g = basic_data(cfg_g)
        t0 = time.perf_counter()
        item = ds_g.sample(0)
        sample_s = time.perf_counter() - t0
        for c in cfg["dataset_params"]["cam_id_list"]:
            dis = item[f"cam_{c}_geodesic_dis"]
            check(dis.shape == (PATCH, PATCH, 1) and np.isfinite(dis).all()
                  and dis.min() >= 1.0,
                  f"real_data geodesic cam_{c}: {dis.shape}, "
                  f"{dis.min()}..{dis.max()}")
        check(os.path.dirname(lib._name) == str(_build.HOST_BUILD_DIR),
              f"real_data geodesic: library {lib._name}")

    record = dict(
        phase="real_data", card=card, fixture=dict(
            frames=REAL_FRAMES, cameras=4, image=REAL_IMG,
            pseudo=REAL_PSEUDO, written_s=fixture_s),
        cv2=cv2.__version__, samples=len(datasets["fp32"]), steps=steps,
        index_cold_s=index[0], index_cached_s=index[1], train_cli=runs,
        loader=loader, h2d=h2d, eval=modes,
        geodesic=dict(library=os.path.relpath(lib._name),
                      build_s=fmm_build_s, sample_s=sample_s))
    emit(**record)
    return record


def _timed_train_cli(cfg_path: str, log_dir: str, train_main=None):
    """The train CLI (or `train_main`, another CLI's main) on `cfg_path`,
    timed from outside: how long each step waits on the loader's queue, and
    CUDA events around each train_step. Returns the Trainer and the run's
    record."""
    import torch

    from x_as_supervision_tpu_torch.data.loader import BatchLoader
    from x_as_supervision_tpu_torch.train import trainer as trainer_mod

    if train_main is None:
        from x_as_supervision_tpu_torch.train.__main__ import main as \
            train_main

    waits, events = [], []
    epoch_fn, step_fn = BatchLoader.epoch, trainer_mod.train_step

    def timed_epoch(self, epoch=0):
        batches = epoch_fn(self, epoch)
        try:
            while True:
                t = time.perf_counter()
                try:
                    batch = next(batches)
                except StopIteration:
                    return
                waits.append(time.perf_counter() - t)
                yield batch
        finally:
            batches.close()

    def timed_step(*args, **kwargs):
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        out = step_fn(*args, **kwargs)
        pair[1].record()
        events.append(pair)
        return out

    BatchLoader.epoch, trainer_mod.train_step = timed_epoch, timed_step
    try:
        t0 = time.perf_counter()
        trainer = train_main(["--config", cfg_path, "--seed", str(SEED),
                              "--log_dir", log_dir])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        BatchLoader.epoch, trainer_mod.train_step = epoch_fn, step_fn
    return trainer, dict(train_cli_s=train_s,
                         step_ms=[a.elapsed_time(b) for a, b in events],
                         loader_wait_ms=[w * 1e3 for w in waits])


def _loader_batch_ms(dataset) -> list[float]:
    """The ms the train CLI's loader takes to make each batch of `dataset`
    with nothing else running: one warm-up epoch, then LOADER_EPOCHS epochs
    drained as fast as they come."""
    from x_as_supervision_tpu_torch.data.loader import BatchLoader

    loader = BatchLoader(dataset, TRAIN_BATCH, num_workers=LOADER_WORKERS,
                         prefetch=2, seed=SEED)
    warm = len(loader)
    for epoch in range(1 + LOADER_EPOCHS):
        for _ in loader.epoch(epoch):
            pass
    loader._pool.shutdown()
    made = [t * 1e3 for t in loader.batch_seconds[warm:]]
    check(len(made) == LOADER_EPOCHS * warm >= 2 + 5,
          f"real_data loader: {len(made)} batches timed")
    return made


def _expect_all(got: dict, skipped: dict, want: set, what: str) -> None:
    """Every tag of `want` written (in `got`) or counted as skipped."""
    bare = {t.rsplit(" skeleton", 1)[0] for t in skipped}
    missing = want - set(got) - bare
    check(not missing, f"{what}: missing {sorted(missing)}")


def _train_events(cfg: dict, tb_dir: str, trainer, steps: int) -> dict:
    """The train CLI's events: one file, one file_version record; at every
    step the flagship losses, the total, smpl_disc and the learning rate
    (equal to the trainer's own history); at step 0 and only there, every
    panel of tb_vis, written or counted as skipped."""
    from x_as_supervision_tpu_torch.checks import events_in

    files = events_in(tb_dir)
    check(len(files) == 1, f"train CLI: event files {sorted(files)}")
    (events,) = files.values()
    check(sum(e["file_version"] is not None for e in events) == 1
          and events[0]["file_version"] == "brain.Event:2",
          "train CLI: not one file_version record first")
    scalars: dict = {}
    images: dict = {}
    for e in events:
        scalars.setdefault(e["step"], {}).update(e["scalars"])
        images.setdefault(e["step"], {}).update(e["images"])
    want = {f"training_loss/{k}" for k in FLAGSHIP_LOSSES} | {
        "training_loss/total_loss", "training_loss/smpl_disc",
        "meta/learning_rate/detector"}
    for step in range(steps):
        got = scalars.get(step, {})
        check(want <= set(got), f"train CLI: step {step} scalars "
                                f"{sorted(got)}, missing "
                                f"{sorted(want - set(got))}")
        hist = trainer.history[step]
        check(got["training_loss/total_loss"] == np.float32(
            hist["loss_total"]), f"train CLI: step {step} total_loss")
        check(all(np.isfinite(v) for v in got.values()),
              f"train CLI: step {step} non-finite scalars")
        check(not images.get(step) or step == 0,
              f"train CLI: panels at step {step}")
    cams = [f"cam_{c}" for c in cfg["dataset_params"]["cam_id_list"]]
    panels = {"training_pose_3d/src_gt_pose_3d",
              "training_depth/depth_map_cam_0"}
    for c in cams:
        panels |= {
            f"training_img/{c}_img", f"training_mask/{c}_mask",
            f"training_pose_2d/{c}_gt_pose",
            f"training_weight/{c}_geodesic_dis",
            f"training_mask/mask_heatmap_line_{c}",
            f"training_mask/mask_physique_{c}",
            f"training_pose_2d/pose_2d_pred_{c}_ori",
            f"training_pose_3d/pose_3d_depth_{c}",
            f"training_pseudo/pose_2d_pred_{c}_pseudo",
            f"training_pseudo/pose_3d_pred_{c}_pseudo",
            f"training_pseudo/pose_3d_gt_{c}_pseudo",
            f"training_smpl/pose_smpl_2d_{c}",
            f"training_smpl/pose_smpl_3d_{c}"}
    skipped = dict(trainer.tb_logger.skipped)
    _expect_all(images[0], skipped, panels, "train CLI step 0")
    check(images[0][f"training_img/{cams[0]}_img"] == (PATCH, PATCH, 3),
          f"train CLI: image size {images[0]}")
    disc = {f"training_disc/{k}_logits_{c}" for c in cams
            for k in ("pred", "smpl")}
    check(disc <= set(scalars[0]), "train CLI: step 0 training_disc")
    record = dict(steps=sorted(scalars), panels=sorted(images[0]),
                  skipped=skipped, events=len(events))
    emit(phase="train_events", **record)
    return record


def _eval_events(ev, mode: str) -> dict:
    """An eval CLI's events: per batch (the step) the pose panels of
    _log_batch_images, written or counted as skipped."""
    from x_as_supervision_tpu_torch.checks import read_events

    events = read_events(ev.tb_logger.path)
    check(events[0]["file_version"] == "brain.Event:2",
          f"eval {mode}: no file_version record first")
    cams = [f"cam_{c}" for c in ev.cam_id_list]
    want = {"testing_pose_3D/gt", "testing_pose_3D/pred_tri"}
    for c in cams:
        want |= {f"testing_pred_pose/{c}_pred_pose_v2",
                 f"testing_gt_pose/{c}_gt_pose_v2",
                 f"testing_pose_3D/pred_{c}"}
    images: dict = {}
    for e in events:
        images.setdefault(e["step"], {}).update(e["images"])
    skipped = dict(ev.tb_logger.skipped)
    for b in range(ev.num_batches):
        _expect_all(images.get(b, {}), skipped, want, f"eval {mode} batch {b}")
    check(all(v % ev.num_batches == 0 for v in skipped.values()),
          f"eval {mode}: skips {skipped}")
    record = dict(panels_per_batch=len(images[0]), skipped=skipped)
    emit(phase="eval_events", mode=mode, panels=sorted(images[0]), **record)
    return record


def _switch_errors(kps, gt):
    """The CPU's L1 x/y errors of each joint (B, H, K) kept and L/R
    swapped, and the 3D squared errors of each hypothesis after the switch
    (B, H, K), as the evaluator computes them."""
    import torch

    from x_as_supervision_tpu_torch.train.eval_utils import (
        DEFAULT_SWITCH_LIST, switch_points)

    kps, gt = torch.from_numpy(kps), torch.from_numpy(gt)
    b, nh, k, _ = kps.shape
    perm = list(range(k))
    for i, j in DEFAULT_SWITCH_LIST:
        perm[i], perm[j] = j, i
    gt_h = gt[:, None].expand(b, nh, k, 3)
    kept = (kps - gt_h).abs()[..., :2].sum(-1)
    swapped = (kps[:, :, perm] - gt_h).abs()[..., :2].sum(-1)
    sw3d, _ = switch_points(kps.reshape(b * nh, k, 3),
                            gt_h.reshape(b * nh, k, 3), switch_all=False)
    err3 = ((sw3d.reshape(b, nh, k, 3) - gt_h) ** 2).sum(-1)
    return kept.numpy(), swapped.numpy(), err3.numpy()


def _tied(a, b) -> np.ndarray:
    return np.abs(a - b) <= 1e-4 * np.maximum(np.abs(a), np.abs(b))


def phase_eval_parity() -> dict:
    """One fp32 eval of the train-parity config's detector on the card and
    on the CPU from one checkpoint saved on the card, on the anchored
    fixture (see the module docstring)."""
    import tempfile

    import torch

    from x_as_supervision_tpu_torch import weights
    from x_as_supervision_tpu_torch.checks import (AnchoredDataset,
                                                   AnchoredDetector,
                                                   result_lines)
    from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
    from x_as_supervision_tpu_torch.models.detector import build_detector
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt
    from x_as_supervision_tpu_torch.train.evaluator import Evaluator, fetch

    cfg = _parity_config()
    cams = cfg["model_params"]["cam_id_list"]
    ds = SyntheticPoseDataset(num_samples=PARITY_SAMPLES, cam_id_list=cams,
                              patch_size=64, seed=SEED)
    cpu_spec, _ = _gan(cfg, torch.float32, "cpu", SEED)
    cond = torch.from_numpy(np.concatenate(
        [ds.batch(0, PARITY_SAMPLES)[f"cam_{c}_img"] for c in cams]))
    weights.condition_for_eval(cpu_spec.detector,
                               cond.permute(0, 3, 1, 2).contiguous())
    card_spec, card_state = _gan(cfg, torch.float32, "cuda", SEED)
    for name in ("detector", "physique", "discriminator"):
        getattr(card_spec, name).load_state_dict(
            getattr(cpu_spec, name).state_dict())
    del cpu_spec
    data = AnchoredDataset(ds, cams, 64.0)
    flips = {"swap": 0, "choice": 0}
    out_err = {"detector": 0.0, "kp_pred_2d": 0.0, "kp_pred": 0.0,
               "gts_2d": 0.0}
    world_err = {"per_cam_world": 0.0, "kps_world_gt": 0.0, "tri": 0.0}
    lines_err = {}
    with tempfile.TemporaryDirectory() as root:
        path = ckpt.save_checkpoint(root, 0, card_state)
        del card_spec, card_state
        evs = {}
        for dev in ("cuda", "cpu"):
            det = build_detector(cfg["model_params"]["detector_params"])
            det.load_state_dict(ckpt.restore_detector(path, dev))
            evs[dev] = Evaluator(cfg, AnchoredDetector(det), data,
                                 os.path.join(root, dev), img_size=64.0,
                                 device=dev)
        card, cpu = evs["cuda"], evs["cpu"]

        def raw(ev, batch, ck):
            with torch.inference_mode():
                img = batch[f"{ck}_img"].permute(0, 3, 1, 2)
                return ev.detector.detector(img).kps.cpu()

        set_tf32(False)
        try:
            for mode in EVAL_MODES:
                for b in range(cpu.num_batches):
                    batch = data.batch(b * PARITY_BATCH, PARITY_BATCH)
                    gdev, wdev = card.to_device(batch), cpu.to_device(batch)
                    got = fetch(card.step(gdev, mode))
                    want = fetch(cpu.step(wdev, mode))
                    gsel, wsel = card.predict(gdev, mode)[1], cpu.predict(
                        wdev, mode)[1]
                    # joints where a camera's discrete choice flipped
                    flipped = np.zeros(want["tri"].shape[:2], dtype=bool)
                    for c in cams:
                        ck = f"cam_{c}"
                        out_err["detector"] = max(out_err["detector"], float(
                            (raw(card, gdev, ck) - raw(cpu, wdev, ck))
                            .abs().max()))
                        kept, swapped, err3 = _switch_errors(
                            wsel[ck]["kps"].numpy(), wsel[ck]["gt"].numpy())
                        gm = got["trans_masks"][ck][..., 0]
                        wm = want["trans_masks"][ck][..., 0]
                        off = gm != wm
                        check(_tied(kept[:, -1], swapped[:, -1])[off].all(),
                              f"eval parity {mode}: swap differs where the "
                              f"CPU's candidates are not tied")
                        gb = gsel[ck]["choice"].cpu().numpy()
                        wb = wsel[ck]["choice"].numpy()
                        pick = lambda i: np.take_along_axis(
                            err3, i[:, None], axis=1)[:, 0]
                        moved = gb != wb
                        check(_tied(pick(gb), pick(wb))[moved].all(),
                              f"eval parity {mode}: hypothesis choice "
                              f"differs where the CPU's errors are not tied")
                        flips["swap"] += int(off.sum())
                        flips["choice"] += int(moved.sum())
                        flipped |= off | moved
                        same = ~(off | moved)[..., None]
                        pairs = {
                            "kp_pred_2d": (got["kp_pred_2d"][ck],
                                           want["kp_pred_2d"][ck]),
                            "gts_2d": (got["gts_2d"][ck], want["gts_2d"][ck]),
                            "kp_pred": (gsel[ck]["kp"].cpu().numpy(),
                                        wsel[ck]["kp"].numpy())}
                        for key, (g, w) in pairs.items():
                            out_err[key] = max(out_err[key], float(
                                (np.abs(g - w) * same).max()))
                        d = np.abs(got["per_cam_world"][ck]
                                   - want["per_cam_world"][ck])
                        world_err["per_cam_world"] = max(
                            world_err["per_cam_world"], float(d.max()))
                    world_err["kps_world_gt"] = max(
                        world_err["kps_world_gt"], float(np.abs(
                            got["kps_world_gt"] - want["kps_world_gt"]).max()))
                    d = np.abs(got["tri"] - want["tri"])[~flipped]
                    world_err["tri"] = max(world_err["tri"],
                                           float(d.max(initial=0.0)))
                # normalized coordinates: the serve phase's bound
                check(max(out_err.values()) <= 1e-3,
                      f"eval parity {mode}: outputs off by {out_err}")
                # world mm: the fp32 DLT's own floor (either device)
                check(world_err["tri"] <= 0.25,
                      f"eval parity {mode}: triangulation off by "
                      f"{world_err['tri']} mm")
                got_lines = result_lines(card.record(*card.eval(mode)))
                want_lines = result_lines(cpu.record(*cpu.eval(mode)))
                check([k for k, _ in got_lines] == [k for k, _ in want_lines],
                      f"eval parity {mode}: eval_result.txt keys differ")
                rel = []
                for (key, g), (_, w) in zip(got_lines, want_lines):
                    if w is None:
                        continue
                    check(np.isfinite(g) and abs(g - w) <= 1e-4 * abs(w),
                          f"eval parity {mode}: {key} {g} vs {w}")
                    rel.append(abs(g - w) / max(abs(w), 1e-30))
                lines_err[mode] = max(rel)
                check(card.last_ambiguity_ratio == cpu.last_ambiguity_ratio
                      or flips["swap"] > 0,
                      f"eval parity {mode}: ambiguity ratio "
                      f"{card.last_ambiguity_ratio} vs "
                      f"{cpu.last_ambiguity_ratio}")
        finally:
            set_tf32(True)
    record = dict(phase="eval_parity", dtype="fp32",
                  config="flagship reduced: ResNet-50 at 64^2, 2 cameras, "
                         "batch 2, D = 16; 8 samples, img_size 64; anchored "
                         "detections",
                  normalized_max_err=out_err, world_max_err_mm=world_err,
                  flips=flips, eval_result_max_rel_err=lines_err,
                  ambiguity_ratio=cpu.last_ambiguity_ratio)
    emit(**record)
    return record


def _percam_config() -> dict:
    """Campaign_SurS2_percam (its JSON copy) with the flagship's
    dataset_params: 4 cameras, the synthetic fixture's feed."""
    from x_as_supervision_tpu_torch.config import load_config
    from x_as_supervision_tpu_torch.train.factory import flagship_config

    cfg = load_config(PERCAM_CONFIG)
    cfg["dataset_params"] = flagship_config()["dataset_params"]
    cfg["model_params"]["cam_id_list"] = cfg["dataset_params"]["cam_id_list"]
    return cfg


def _variant_steps(name: str, disc_updates: dict, per_camera_bn: bool = True,
                   profile: bool = False) -> dict:
    """One warm-up and VARIANT_STEPS timed steps of the percam config with
    `disc_updates` in its smpl_disc_params, bf16 at the flagship shape
    (`per_camera_bn` False: the control with pooled statistics); with
    `profile`, torch.profiler over one more step."""
    import torch
    from torch.profiler import ProfilerActivity, profile as profiler

    from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
    from x_as_supervision_tpu_torch.train.state import train_step
    from x_as_supervision_tpu_torch.train.trainer import (
        step_generator, to_device)

    cfg = _percam_config()
    cfg["model_params"]["smpl_disc_params"].update(disc_updates)
    cfg["model_params"]["per_camera_bn"] = per_camera_bn
    cams = cfg["dataset_params"]["cam_id_list"]
    spec, state = _gan(cfg, torch.bfloat16, "cuda", SEED)
    ds = SyntheticPoseDataset(num_samples=TRAIN_BATCH * (VARIANT_STEPS + 2),
                              cam_id_list=cams, patch_size=PATCH, seed=SEED)
    batches = [to_device(ds.batch(i * TRAIN_BATCH, TRAIN_BATCH), "cuda")
               for i in range(VARIANT_STEPS + 2)]

    def step(i):
        return train_step(state, batches[i], step_generator(SEED, i, "cuda"))

    step(0)
    torch.cuda.synchronize()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(VARIANT_STEPS)]
    history = []
    for i, (ev0, ev1) in enumerate(events, start=1):
        ev0.record()
        history.append(step(i))
        ev1.record()
    torch.cuda.synchronize()
    launches, paths = _check_train_launches(
        VARIANT_STEPS, f"variants {name}",
        *((VARIANT_LAUNCHES, VARIANT_PATH_LAUNCHES) if per_camera_bn
          else (TRAIN_LAUNCHES, TRAIN_PATH_LAUNCHES)))
    losses = [{k: float(v) for k, v in sorted(m.items())} for m in history]
    for m in losses:
        check(len(m) == 7 and all(np.isfinite(v) for v in m.values()),
              f"variants {name}: missing or non-finite losses {m}")
    step_ms = [a.elapsed_time(b) for a, b in events]
    record = dict(
        name=name, smpl_disc_params=cfg["model_params"]["smpl_disc_params"],
        discriminator=type(spec.discriminator).__name__,
        step_ms=step_ms, mean_step_ms=sum(step_ms) / len(step_ms),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        losses=losses, launches_per_step=launches,
        path_launches_per_step=paths)
    emit(phase="variant_steps", **record)
    if profile:
        ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        with profiler(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            ev0.record()
            step(VARIANT_STEPS + 1)
            ev1.record()
            torch.cuda.synchronize()
        window_us = ev0.elapsed_time(ev1) * 1e3
        record["profile"] = dict(window_us=window_us,
                                 **_profile_rows(prof, window_us, 15))
        emit(phase="variant_profile", name=name, **record["profile"])
    del spec, state, batches, history
    torch.cuda.empty_cache()
    return record


def _link_camera_case(dtype, c: int, side: int) -> dict:
    """The link on each camera's slice of a (128, C, H, W) channels-last
    batch (a view at an offset, as Bottleneck.forward hands it over),
    against the plain version with the kernel phase's bounds; times of one
    slice."""
    import torch
    import torch.nn.functional as F

    from x_as_supervision_tpu_torch.ops.conv_bn import (
        bn_relu_conv_plain, fused_bn_relu_conv)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((TRAIN_IMAGES, c, side, side), generator=gen,
                    device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn((c, c, 3, 3), generator=gen, device="cuda")
         * (2 / (9 * c)) ** 0.5).to(dtype)
    err = serr = 0.0
    ymax = 0.0
    for xs in x.chunk(CAMERAS):
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        shift = torch.randn(c, generator=gen, device="cuda") * 0.1
        check(xs.is_contiguous(memory_format=torch.channels_last),
              "camera slice is not channels-last")
        y, stats = fused_bn_relu_conv(xs, w, scale, shift)
        ry, rstats = bn_relu_conv_plain(xs, w, scale, shift)
        yf = ry.float()
        ymax = max(ymax, yf.abs().max().item())
        err = max(err, (y.float() - yf).abs().max().item())
        mags = torch.stack([yf.abs().sum(dim=(0, 2, 3)),
                            (yf * yf).sum(dim=(0, 2, 3))])
        serr = max(serr, ((stats - rstats).abs()
                          / mags.clamp_min(1e-30)).max().item())
    torch.cuda.synchronize()
    tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * ymax
    check(err <= tol, f"link on camera slices {dtype} {c}x{side}^2: "
                      f"max|err| {err} > {tol}")
    check(serr <= 1e-5, f"link on camera slices {dtype} {c}x{side}^2: "
                        f"stats err {serr} of the sum of magnitudes")
    kind = _kind(dtype)
    elt = x.element_size()
    batch = TRAIN_BATCH
    n = batch * side * side
    nbytes = 2 * n * c * elt + 9 * c * c * elt + 2 * c * 4 + 2 * c * 4
    flops = 2.0 * n * c * 9 * c + 3.0 * n * c
    bound, by = bound_ms(nbytes, flops, kind)
    xs = x[batch:2 * batch]
    return dict(
        name="conv_bn_link", dtype=kind, shape=[batch, c, side, side],
        camera_slice=True, max_abs_err=err, tol=tol, stats_rel_err=serr,
        ms=cuda_ms(lambda: fused_bn_relu_conv(xs, w, scale, shift)),
        plain_ms=cuda_ms(lambda: bn_relu_conv_plain(xs, w, scale, shift)),
        library_ms=cuda_ms(lambda: F.conv2d(xs, w, padding=1)),
        bound_ms=bound, bound_by=by)


def _grouped_bottleneck_case(dtype) -> dict:
    """A train-mode Bottleneck(1024, 256) at 16^2, B = 128, 4 camera
    groups: the link path (4 launches) against the plain grouped path
    (BatchNorm per camera slice, cuDNN's conv) on the same input and
    weights: output and running statistics."""
    import copy

    import torch

    from x_as_supervision_tpu_torch import weights
    from x_as_supervision_tpu_torch.models.resnet import (
        Bottleneck, set_bn_groups)
    from x_as_supervision_tpu_torch.ops.conv_bn import fused_bn_relu_conv

    groups = CAMERAS
    block = Bottleneck(1024, 256)
    weights.init_weights(block, SEED)
    set_bn_groups(block, groups)
    block = block.to("cuda").train()
    plain = copy.deepcopy(block)
    plain.fused_link = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((TRAIN_IMAGES, 1024, 16, 16), generator=gen,
                    device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last)
    before = fused_bn_relu_conv.launches
    with torch.no_grad():
        y = block(x).float()
        torch.cuda.synchronize()
        launches = fused_bn_relu_conv.launches - before
        ry = plain(x).float()
    check(launches == groups, f"grouped Bottleneck: {launches} link "
                              f"launches, expected {groups}")
    rel = ((y - ry).abs().max() / ry.abs().max()).item()
    want_sd = plain.state_dict()
    stats = max(((v - want_sd[k]).abs() / (want_sd[k].abs() + 1e-3)
                 ).max().item()
                for k, v in block.state_dict().items() if "running" in k)
    # fp32: three convs and the per-camera statistics summed in other
    # orders (the link's bn2 from its one-pass (sum, sumsq)); bf16: the two
    # paths round the activations to bf16 at other points (2^-8 each),
    # through two normalizations
    tol = 1e-4 if dtype == torch.float32 else 2 ** -5
    check(rel <= tol and stats <= 1e-2,
          f"grouped Bottleneck {dtype}: output off by {rel} of its largest "
          f"value (bound {tol}), running stats by {stats}")
    with torch.no_grad():
        ms = cuda_ms(lambda: block(x), iters=10)
        plain_ms = cuda_ms(lambda: plain(x), iters=10)
    return dict(dtype=_kind(dtype), shape=[TRAIN_IMAGES, 1024, 16, 16],
                groups=groups, link_launches=launches, max_rel_err=rel,
                tol=tol, running_stats_rel_err=stats, forward_ms=ms,
                plain_forward_ms=plain_ms)


def _smpl_chain() -> dict:
    """rule_transformation -> smpl_forward -> smpl_to_h36m ->
    project_smpl_to_patch_kps at SMPL's size and batch 128, card against
    CPU from the same draws, fp32."""
    import torch

    from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
    from x_as_supervision_tpu_torch.models.smpl import (
        random_smpl_model, smpl_forward)
    from x_as_supervision_tpu_torch.ops import geometry as G
    from x_as_supervision_tpu_torch.train.trainer import to_device

    model = random_smpl_model(SEED, SMPL_VERTS)
    rng = np.random.default_rng(SEED)
    reg = rng.uniform(0, 1, (17, SMPL_VERTS)).astype(np.float32)
    reg /= reg.sum(axis=1, keepdims=True)
    gen = torch.Generator().manual_seed(SEED)
    draws = G.rule_draws(SMPL_BATCH, gen)
    rot = G.rotate_z(torch.eye(3).expand(SMPL_BATCH, 3, 3).contiguous(),
                     torch.rand(SMPL_BATCH, generator=gen))
    cams = SyntheticPoseDataset(num_samples=SMPL_BATCH, cam_id_list=(0,),
                                patch_size=PATCH, seed=SEED).batch(
        0, SMPL_BATCH)

    def chain(device, m, x, r, d, g):
        pose, beta = G.rule_transformation_from(d)
        fwd = lambda p, b: smpl_forward(m, p, b)  # noqa: E731
        kps = G.project_smpl_to_patch_kps(g, pose[:, 3:], beta, fwd, r, x,
                                          "cam_0")
        verts = G.project_smpl_to_patch_kps(g, pose[:, 3:], beta, fwd, r, x,
                                            "cam_0", convert_verts=True)
        return kps, verts

    args = {}
    for dev in ("cpu", "cuda"):
        args[dev] = (dev, model.to(dev), to_device(cams, dev),
                     torch.from_numpy(reg).to(dev),
                     {k: v.to(dev) for k, v in draws.items()}, rot.to(dev))
    want_kps, want_verts = chain(*args["cpu"])
    set_tf32(False)  # the chain's matmuls turn TF32 off themselves
    try:
        kps, verts = chain(*args["cuda"])
        torch.cuda.synchronize()
    finally:
        set_tf32(True)
    check(kps.shape == (SMPL_BATCH, 18, 3)
          and verts.shape == (SMPL_BATCH, SMPL_VERTS, 3)
          and bool(torch.isfinite(kps).all() and torch.isfinite(verts).all()),
          f"SMPL chain: shapes {tuple(kps.shape)} {tuple(verts.shape)} or "
          "non-finite values")
    kps_err = (kps.cpu() - want_kps).abs().max().item()
    verts_err = (verts.cpu() - want_verts).abs().max().item()
    # fp32 world mm about 5 m out (a step of 5e-4 mm), summed in other
    # orders; patch pixels (x, y and the depth, 7.8 mm a pixel) of 256^2
    check(verts_err <= 0.05 and kps_err <= 5e-3,
          f"SMPL chain: world vertices off by {verts_err} mm (0.05), patch "
          f"keypoints by {kps_err} px (5e-3)")
    ms = cuda_ms(lambda: chain(*args["cuda"]), iters=10)
    record = dict(batch=SMPL_BATCH, verts=SMPL_VERTS, joints=24,
                  pose_blend_shapes=207, betas=10,
                  verts_max_err_mm=verts_err, kps_max_err_px=kps_err,
                  kps_range_px=[kps.min().item(), kps.max().item()],
                  card_ms=ms)
    emit(phase="smpl_chain", **record)
    return record


def _variants_cli() -> dict:
    """The percam config (the flagship's dataset_params, --synthetic)
    through the train CLI for one epoch to 00000_ckpt, restored bitwise,
    then the eval CLI in best mode."""
    import tempfile

    import torch

    from x_as_supervision_tpu_torch.train.__main__ import main as train_main

    with tempfile.TemporaryDirectory() as root:
        cfg = _percam_config()
        cfg["train_params"].update(num_epochs=1, checkpoint_freq=1)
        cfg_path = os.path.join(root, "Campaign_SurS2_percam.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        log_dir = os.path.join(root, "log")
        _reset_counts()
        t0 = time.perf_counter()
        trainer = train_main(["--config", cfg_path, "--synthetic", "--seed",
                              str(SEED), "--log_dir", log_dir])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        steps = TRAIN_IMAGES // TRAIN_BATCH
        check(trainer.state.step == steps,
              f"variants train CLI: {trainer.state.step} steps, expected "
              f"{steps}")
        launches, _ = _check_train_launches(
            steps, "variants train CLI", VARIANT_LAUNCHES,
            VARIANT_PATH_LAUNCHES)
        check(all(np.isfinite(v) for h in trainer.history
                  for v in h.values()) and trainer.history,
              f"variants train CLI: losses {trainer.history}")
        (run,) = os.listdir(log_dir)
        path = os.path.join(log_dir, run, "00000_ckpt")
        n_tensors = _check_restore(cfg, path, trainer)
        del trainer
        torch.cuda.empty_cache()
        _, best = _eval_cli(cfg_path, path, "best", synthetic=True)
    record = dict(train_cli_s=train_s, train_launches_per_step=launches,
                  restored_tensors=n_tensors, eval_best=best)
    emit(phase="variants_cli", **record)
    return record


def phase_variants() -> dict:
    """The rest of the multi-view model on the card (see the module
    docstring, phase 11)."""
    import torch

    runs = [_variant_steps(name, updates, profile=name == "percam")
            for name, updates in VARIANTS.items()]
    # the control: the same model with pooled statistics (14 links a step)
    control = _variant_steps("percam_pooled", {}, per_camera_bn=False,
                             profile=True)
    links = []
    for dtype in (torch.float32, torch.bfloat16):
        set_tf32(False)
        try:
            for c, side, _ in LINK_SHAPES:
                links.append(_link_camera_case(dtype, c, side))
                emit(phase="variant_link", **links[-1])
            block = _grouped_bottleneck_case(dtype)
        finally:
            set_tf32(True)
        emit(phase="variant_bottleneck", **block)
    cfg = _parity_config()
    mp = cfg["model_params"]
    mp["per_camera_bn"] = True
    mp["smpl_disc_params"].update(name="res_gcn", use_bn=True, use_aug=True)
    # per camera the batch of phase 7's pooled statistics (4 images): at 2
    # images a camera the CPU's own gradients move by up to 6.7 % of a
    # tensor's largest entry when the images change by 1e-6 relative (4:
    # 0.75 %; scripts/parity_sensitivity.py), so the card could not be told
    # from the CPU at phase 7's bound
    b = cfg["train_params"]["batch_size"] = 2 * PARITY_BATCH
    nc, nh = len(mp["cam_id_list"]), mp["detector_params"]["num_hypo"]
    gen = torch.Generator().manual_seed(SEED)
    draws = {"gen": torch.rand(nc * b * nh, generator=gen),
             "disc": torch.rand(nc * b, generator=gen)}
    parity = _train_parity(
        cfg, "variant_parity", "flagship reduced (ResNet-50 at 64^2, 2 "
        "cameras, D = 16) at batch 4 + per_camera_bn, use_aug, res_gcn "
        "with use_bn", rot_draws=draws)
    smpl = _smpl_chain()
    cli = _variants_cli()
    record = dict(phase="variants", runs=[
        {k: r[k] for k in ("name", "discriminator", "mean_step_ms",
                           "peak_memory_gb")} for r in runs + [control]],
        launches_per_step=runs[0]["launches_per_step"],
        link_ms_per_camera={f"{c['dtype']} {c['shape']}": c["ms"]
                            for c in links},
        parity_loss_rel_err=max(parity["loss_rel_err"].values()),
        smpl_verts_err_mm=smpl["verts_max_err_mm"],
        smpl_kps_err_px=smpl["kps_max_err_px"],
        cli_train_s=cli["train_cli_s"])
    emit(**record)
    return record


class _FirstN:
    """The first `n` samples of a dataset with ``batch(start, size)``."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return self.n

    def batch(self, start: int, size: int) -> dict:
        return self.dataset.batch(start, size)


def _mono_parity_config() -> dict:
    """TikTok_Multi_S1 reduced for the card-vs-CPU step: ResNet-50 at 64^2,
    D = 16, batch 4 (phase 7's population per BatchNorm statistic)."""
    from x_as_supervision_tpu_torch.config import load_config

    cfg = load_config(TIKTOK_CONFIG)
    tp = cfg["train_params"]
    cfg["model_params"]["detector_params"]["depth_dim"] = 16
    tp["patch_width"] = tp["patch_height"] = 64
    tp["batch_size"] = 2 * PARITY_BATCH
    return cfg


def _mono_eval_parity(cfg: dict, path: str, dataset) -> dict:
    """The eval2d forward in fp32 (TF32 off) on the card and on the CPU from
    the mono checkpoint, conditioned on the crops (weights.
    condition_for_eval), on MONO_FP32_IMAGES MPII crops: normalized
    keypoints within 1e-3, the inverse-affine MPII predictions within 1e-2
    px, in both modes."""
    import torch

    from x_as_supervision_tpu_torch import weights
    from x_as_supervision_tpu_torch.eval2d import evaluate_pckh
    from x_as_supervision_tpu_torch.models.detector import build_detector
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt

    few = _FirstN(dataset, MONO_FP32_IMAGES)
    imgs = few.batch(0, MONO_FP32_IMAGES)["cam_mono_img"]
    det = build_detector(cfg["model_params"]["detector_params"])
    det.load_state_dict(ckpt.restore_detector(path))
    weights.condition_for_eval(
        det, torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous())
    state = det.state_dict()
    kps, fwd = {}, {}
    for dev in ("cuda", "cpu"):
        d = build_detector(cfg["model_params"]["detector_params"])
        d.load_state_dict(state)
        d = d.to(dev).eval()

        @torch.inference_mode()
        def forward(x, d=d, dev=dev):
            out = d(torch.as_tensor(x).to(dev).permute(0, 3, 1, 2)).kps
            kps[dev] = out.float().cpu().numpy()
            return kps[dev]

        fwd[dev] = forward
    record = {}
    patch = float(cfg["train_params"]["patch_width"])
    set_tf32(False)
    try:
        for mode in EVAL_MODES:
            pts, pckh = {}, {}
            for dev in ("cuda", "cpu"):
                pts[dev] = []
                pckh[dev] = evaluate_pckh(few, fwd[dev], patch,
                                          MONO_FP32_IMAGES, mode, pts[dev])
            kps_err = float(np.abs(kps["cuda"] - kps["cpu"]).max())
            px_err = float(np.abs(pts["cuda"][0][0] - pts["cpu"][0][0]).max())
            # normalized coordinates: the serve phase's bound; original
            # pixels (crops of ~600 px to 256^2): 1e-2 px
            check(kps_err <= 1e-3,
                  f"mono eval2d fp32 {mode}: kps off by {kps_err}")
            check(px_err <= 1e-2,
                  f"mono eval2d fp32 {mode}: MPII predictions off by "
                  f"{px_err} px")
            record[mode] = dict(kps_max_err=kps_err, px_max_err=px_err,
                                pckh_card=pckh["cuda"], pckh_cpu=pckh["cpu"])
    finally:
        set_tf32(True)
    return record


def _mono_kernel_cases() -> list[dict]:
    """The kernels at the mono step's shapes (one camera x 32) that the
    kernel phase checks only at the flagship's 128: the decode backward,
    every physique conv, the link's train-mode gradient; fp32 with TF32 off,
    and bf16."""
    import torch

    cases = []
    set_tf32(False)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(_marginals_bwd_case(dtype, TRAIN_BATCH))
            for cin, cout, side, stride in CONV_SHAPES:
                cases.append(_conv_case(dtype, TRAIN_BATCH, cin, cout, side,
                                        stride))
            for c, side, _ in LINK_SHAPES:
                cases.append(_link_grad_case(dtype, TRAIN_BATCH, c, side))
            torch.cuda.synchronize()
    finally:
        set_tf32(True)
    for case in cases:
        emit(phase="mono_kernel", **case)
    return cases


def phase_mono(card: str) -> dict:
    """The mono / 2D path on the card (see the module docstring, phase
    12). `card`: nvidia-smi's name and power limit, for the record."""
    import tempfile

    import torch

    from x_as_supervision_tpu_torch import checks
    from x_as_supervision_tpu_torch.config import load_config
    from x_as_supervision_tpu_torch.data.synthetic import SyntheticMonoDataset
    from x_as_supervision_tpu_torch.eval2d import main as eval2d_main
    from x_as_supervision_tpu_torch.ops.conv_bn import fused_bn_relu_conv
    from x_as_supervision_tpu_torch.ops.integral_kernel import (
        integral_marginals)
    from x_as_supervision_tpu_torch.serve import PoseEstimator
    from x_as_supervision_tpu_torch.train2d3d import main as train2d3d_main

    try:
        import cv2  # noqa: F401
    except ImportError:
        raise SmokeFailure("mono: cv2 is not installed; the TikTok and MPII "
                           "datasets read their images with it") from None

    kernel_cases = _mono_kernel_cases()

    with tempfile.TemporaryDirectory(prefix="xas_mono_") as root:
        t0 = time.perf_counter()
        tiktok = checks.write_mini_tiktok(root, n_frames=MONO_FRAMES,
                                          size_hw=MONO_FRAME_HW, seed=SEED)
        pseudo = checks.write_surreal_pseudo(
            os.path.join(root, "surreal_h36m_pose"), MONO_PSEUDO,
            seed=SEED + 1, size=PATCH)
        mpii_path, mpii_masks = checks.write_mini_mpii(
            root, n_images=MPII_IMAGES, size_hw=MPII_HW, seed=SEED + 2)
        fixture_s = time.perf_counter() - t0

        with open(TIKTOK_CONFIG) as f:
            cfg = json.load(f)
        cfg["dataset_params"]["dataset"]["path"] = tiktok
        cfg["dataset_params"]["smpl_pseudo_img"]["data_path"] = pseudo
        cfg["train_params"].update(num_epochs=1, checkpoint_freq=1)
        cfg_path = os.path.join(root, "TikTok_Multi_S1.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        with open(MPII_CONFIG) as f:
            mcfg = json.load(f)
        mcfg["dataset_params"]["dataset"].update(path=mpii_path,
                                                 mask_path=mpii_masks)
        mcfg_path = os.path.join(root, "MPII_2D.json")
        with open(mcfg_path, "w") as f:
            json.dump(mcfg, f)

        # train2d3d: one epoch of 3 steps of 32, bf16
        log_dir = os.path.join(root, "log")
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        trainer, run = _timed_train_cli(cfg_path, log_dir, train2d3d_main)
        what = "mono train2d3d CLI"
        dataset = trainer.dataset
        check(type(dataset).__name__ == "TikTok_dataset"
              and len(dataset) == MONO_STEPS * TRAIN_BATCH
              and trainer.images_per_step == TRAIN_BATCH,
              f"{what}: {type(dataset).__name__} of {len(dataset)} samples, "
              f"{trainer.images_per_step} images a step")
        check(trainer.state.step == MONO_STEPS,
              f"{what}: {trainer.state.step} steps, expected {MONO_STEPS}")
        run["launches_per_step"], run["path_launches_per_step"] = \
            _check_train_launches(MONO_STEPS, what, MONO_LAUNCHES,
                                  MONO_PATH_LAUNCHES)
        run["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        check(len(trainer.history) == MONO_STEPS and all(
            set(h) == {f"loss/{k}" for k in MONO_LOSSES}
            | {"loss_total", "loss_disc"}
            and np.isfinite(list(h.values())).all()
            for h in trainer.history),
            f"{what}: losses {trainer.history}")
        run["losses"] = trainer.history
        run["batch_made_ms"] = [t * 1e3 for t in trainer.loader.batch_seconds]
        steady = run["step_ms"][1:]
        run["mean_step_ms"] = float(np.mean(steady))
        run["img_per_s"] = TRAIN_BATCH / (run["mean_step_ms"] / 1e3)
        run["mean_batch_made_ms"] = float(np.mean(run["batch_made_ms"]))
        # the loader against the step it has to keep up with, both after
        # the first (cold) one
        run["loader_sets_the_pace"] = bool(
            np.mean(run["batch_made_ms"][1:]) > run["mean_step_ms"])
        (name,) = os.listdir(log_dir)
        path = os.path.join(log_dir, name, "00000_ckpt")
        check(sorted(os.listdir(os.path.join(log_dir, name)))
              == ["00000_ckpt", "TikTok_Multi_S1.json", "tensorboard"],
              f"{what}: run directory {os.listdir(os.path.join(log_dir, name))}")
        del trainer
        torch.cuda.empty_cache()

        # eval2d: MPII PCKh of that checkpoint, bf16, batches of 32
        _reset_counts()
        ev = eval2d_main(["--config", mcfg_path, "--checkpoint", path])
        torch.cuda.synchronize()
        nb = ev.num_batches
        check(nb == MPII_IMAGES // TRAIN_BATCH,
              f"mono eval2d: {nb} batches of {len(ev.dataset)} crops")
        counters = _counters()
        eval_launches = {k: fn.launches / nb for k, fn in counters.items()}
        for k, per_batch in EVAL2D_LAUNCHES.items():
            check(eval_launches[k] == per_batch,
                  f"mono eval2d: {k} launched {eval_launches[k]} times a "
                  f"batch, expected {per_batch}")
        check(fused_bn_relu_conv.launches_wgmma
              == EVAL2D_LAUNCHES["conv_bn_link"] * nb,
              f"mono eval2d: {fused_bn_relu_conv.launches_wgmma} links on "
              f"wgmma")
        with open(ev.result_path) as f:
            line = f.read().strip()
        key, _, value = line.partition(":")
        check(key == "PCKh@0.5" and np.isfinite(float(value))
              and 0.0 <= float(value) <= 100.0,
              f"mono eval2d: eval2d_result.txt {line!r}")
        step_s = sum(ev.step_ms) / 1e3
        eval2d = dict(batches=nb, pckh=float(value),
                      step_ms=list(ev.step_ms),
                      wall_s=ev.wall_s, host_share=1.0 - step_s / ev.wall_s,
                      launches_per_batch=eval_launches,
                      img_per_s=nb * ev.batch_size / step_s)

        # serving from the mono checkpoint: the keypoints of eval2d's
        # forward on the same 32 crops. The decode forward sums its x/y
        # marginals with shared-memory atomics, in the order the warps
        # reach them, so two runs of one forward may part in the last bits
        # of x, y (1.2e-7 in the first run on the card); z comes from
        # ordered sums and its peak choice, and is equal
        crops = ev.dataset.batch(0, TRAIN_BATCH)["cam_mono_img"]
        want = ev.forward(crops)
        again = ev.forward(crops)
        est = PoseEstimator(load_config(mcfg_path), checkpoint_path=path,
                            batch_size=TRAIN_BATCH)
        integral_marginals.launches = fused_bn_relu_conv.launches = 0
        got = est(crops).kps_patch
        torch.cuda.synchronize()
        serve_err = float(np.abs(got - want).max())
        rerun_err = float(np.abs(again - want).max())
        check(got.shape == want.shape
              and np.array_equal(got[..., 2], want[..., 2])
              and serve_err <= 1e-5,
              f"mono serve: keypoints differ from eval2d's by {serve_err} "
              f"(eval2d's forward from itself: {rerun_err})")
        check(integral_marginals.launches == 1
              and fused_bn_relu_conv.launches == 7,
              f"mono serve: {integral_marginals.launches} decodes, "
              f"{fused_bn_relu_conv.launches} links for one forward")
        del est

        # fp32 on the card against the CPU: one step, the eval2d forward
        pcfg = _mono_parity_config()
        b = pcfg["train_params"]["batch_size"]
        parity = _train_parity(
            pcfg, "mono_parity", "TikTok_Multi_S1 reduced: ResNet-50 at "
            "64^2, D = 16, mono, batch 4",
            batch=SyntheticMonoDataset(num_samples=b, patch_size=64,
                                       seed=SEED).batch(0, b))
        eval_parity = _mono_eval_parity(load_config(mcfg_path), path,
                                        ev.dataset)
        del ev
        torch.cuda.empty_cache()

    record = dict(
        phase="mono", card=card, kernel_cases=len(kernel_cases),
        fixture=dict(
            tiktok_frames=MONO_FRAMES, frame_hw=MONO_FRAME_HW,
            pseudo=MONO_PSEUDO, mpii_images=MPII_IMAGES, mpii_hw=MPII_HW,
            written_s=fixture_s),
        config="TikTok_Multi_S1 (JSON), 1 camera x 32 at 256^2, bf16",
        train_cli=run, eval2d=eval2d, serve_max_err=serve_err,
        eval2d_rerun_max_err=rerun_err,
        parity_loss_rel_err=max(parity["loss_rel_err"].values()),
        parity_grad_max_rel_err=parity["grad_max_rel_err"],
        eval2d_fp32=eval_parity)
    emit(**record)
    record["kernel_cases"] = kernel_cases
    return record


# ---------------------------------------------------------------- dp


def _torchrun(root: str, role: str, args: list, timeout: float,
              nproc: int = 1) -> list:
    """`python -m torch.distributed.run --standalone --nproc_per_node
    <nproc> chip_smoke.py dp-rank <role> <out> <args>`: `nproc` ranks under
    torchrun (one: NCCL; two on the one card: gloo, the backend they pick
    themselves), each of which writes its record to <root>/<role>.json.<r>;
    returns the records by rank."""
    out = os.path.join(root, f"{role}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), os.path.abspath(__file__),
           "dp-rank", role, out, *args]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, cwd=REPO_ROOT)
    check(res.returncode == 0,
          f"{role}: torchrun exited {res.returncode}: "
          f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    records = []
    for r in range(nproc):
        with open(f"{out}.{r}") as f:
            records.append(json.load(f))
        records[-1]["process_s"] = time.perf_counter() - t0
    return records


def _rank_out(out: str) -> str:
    """This rank's record file under _torchrun."""
    from x_as_supervision_tpu_torch.parallel import mesh

    return f"{out}.{mesh.process_index()}"


def _dp_rank_counts() -> dict:
    counters = _counters()
    return dict(
        launches={name: fn.launches for name, fn in counters.items()},
        path_launches={name: {a: getattr(counters[name], a) for a in attrs}
                       for name, attrs in TRAIN_PATH_LAUNCHES.items()})


def _dp_rank_cli(out: str, which: str, args: list) -> None:
    """A rank of the train or eval CLI under torchrun: the CLI's main on
    `args`, its launch counts (set to 0 just before) and the collectives
    it called."""
    import torch

    from x_as_supervision_tpu_torch.parallel import collectives as C
    from x_as_supervision_tpu_torch.parallel import mesh

    _reset_counts()
    C.COUNTS.reset()
    train = which.endswith("train")
    if train:
        from x_as_supervision_tpu_torch.train.__main__ import main
    else:
        from x_as_supervision_tpu_torch.eval.__main__ import main
    result = main(args)
    torch.cuda.synchronize()
    record = dict(_dp_rank_counts(), collectives=C.COUNTS.snapshot(),
                  world=mesh.process_count(), rank=mesh.process_index(),
                  grid=[mesh.data_size(), mesh.model_size()],
                  backend=str(torch.distributed.get_backend()),
                  device=str(torch.cuda.current_device()))
    if train:
        record.update(steps=result.state.step,
                      history=result.history,
                      peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    else:
        record.update(batches=len(result.my_batches),
                      num_batches=result.num_batches,
                      result_path=result.result_path,
                      ambiguity_ratio=result.last_ambiguity_ratio)
    with open(_rank_out(out), "w") as f:
        json.dump(record, f)


def _dp_rank_cost(out: str) -> None:
    """One rank under torchrun (NCCL, a group of one): the flagship bf16
    step on its data-parallel path (the synced statistics and losses, the
    gradient all-reduce) against the same step without a process group,
    by CUDA events in turns (plain, dp, dp, plain; the plain turns see no
    group), with the launches and collectives of a dp step and the NCCL
    kernels' device time in a profiled dp step."""
    from unittest import mock

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
    from x_as_supervision_tpu_torch.parallel import collectives as C
    from x_as_supervision_tpu_torch.parallel import mesh
    from x_as_supervision_tpu_torch.train.factory import flagship_config
    from x_as_supervision_tpu_torch.train.state import train_step
    from x_as_supervision_tpu_torch.train.trainer import (
        step_generator, to_device)

    mesh.initialize_multihost()
    device = mesh.rank_device()
    cfg = flagship_config()
    cams = cfg["dataset_params"]["cam_id_list"]
    spec, state = _gan(cfg, torch.bfloat16, device, SEED)
    ds = SyntheticPoseDataset(num_samples=TRAIN_BATCH * 2, cam_id_list=cams,
                              patch_size=PATCH, seed=SEED)
    batches = [to_device(ds.batch(i * TRAIN_BATCH, TRAIN_BATCH), device)
               for i in range(2)]

    def step(i):
        return train_step(state, batches[i % 2],
                          step_generator(SEED, i, device))

    def plain():
        return mock.patch.object(dist, "is_initialized", lambda: False)

    with plain():
        step(0)
    step(1)  # warm-up of each path
    torch.cuda.synchronize()
    times = {"plain": [], "dp": []}
    peak = {}
    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    dp_steps = 0
    for kind in ("plain", "dp", "dp", "plain"):
        torch.cuda.reset_peak_memory_stats()
        before = {name: fn.launches for name, fn in counters.items()}
        for i in range(DP_COST_STEPS):
            ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            if kind == "plain":
                with plain():
                    ev0.record()
                    step(i)
                    ev1.record()
            else:
                C.COUNTS.reset()
                ev0.record()
                step(i)
                ev1.record()
                dp_steps += 1
            torch.cuda.synchronize()
            times[kind].append(ev0.elapsed_time(ev1))
        peak[kind] = torch.cuda.max_memory_allocated() / 1e9
        if kind == "dp":
            for name, fn in counters.items():
                launches[name] += fn.launches - before[name]
    per_step = C.COUNTS.snapshot()  # the last dp step's
    profiles = {}
    for kind in ("plain", "dp"):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if kind == "plain":
                with plain():
                    ev0.record()
                    step(0)
                    ev1.record()
            else:
                ev0.record()
                step(0)
                ev1.record()
            torch.cuda.synchronize()
        window_us = ev0.elapsed_time(ev1) * 1e3
        profiles[kind] = dict(window_us=window_us,
                              nccl_kernels=_profile_calls(prof, "nccl"),
                              **_profile_rows(prof, window_us, 12))
    with open(_rank_out(out), "w") as f:
        json.dump(dict(
            step_ms=times, peak_memory_gb=peak, dp_steps=dp_steps,
            plain_steps=2 * DP_COST_STEPS,
            launches=launches, collectives_per_step=per_step,
            profiles=profiles, backend=str(dist.get_backend()),
            world=mesh.process_count()), f)


def _profile_calls(prof, needle: str) -> dict:
    """Calls and device ms of the CUDA kernels whose name holds `needle`."""
    import torch

    calls, us = 0, 0.0
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and needle in e.key.lower()):
            calls += e.count
            dev = getattr(e, "self_device_time_total", None)
            us += dev if dev is not None else getattr(
                e, "self_cuda_time_total", 0.0)
    return dict(calls=calls, ms=us / 1e3)


def _synced_bn_cases() -> list[dict]:
    """models/resnet.py's synced BatchNorm on the card (PyTorch's fused
    BatchNorm kernels) against its plain version on the CPU, in a process
    group of one (gloo), fp32 and bf16, pooled and per camera (4 groups),
    at two activation shapes of the flagship step: the output and the
    input gradient (bf16: one bf16 step, 2^-7, of the largest value), the
    affine's gradients and the running statistics (1e-5; bf16 inputs
    1e-4), each relative to its largest value."""
    import socket

    import torch

    from x_as_supervision_tpu_torch.models.resnet import BatchNorm2d
    from x_as_supervision_tpu_torch.parallel import mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh.initialize_multihost(f"localhost:{port}", 1, 0, backend="gloo")
    cases = []
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for shape in ((128, 256, 16, 16), (64, 64, 64, 64)):
                for groups in (1, 4):
                    gen = torch.Generator().manual_seed(SEED)
                    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(
                        dtype).contiguous(memory_format=torch.channels_last)
                    gy = torch.randn(shape, generator=gen).to(dtype)
                    affine = (torch.rand(shape[1], generator=gen) + 0.5,
                              torch.randn(shape[1], generator=gen) * 0.1)
                    out = {}
                    for dev in ("cpu", "cuda"):
                        bn = BatchNorm2d(shape[1]).to(dev)
                        bn.groups = groups
                        with torch.no_grad():
                            bn.weight.copy_(affine[0])
                            bn.bias.copy_(affine[1])
                        xx = x.detach().to(dev).requires_grad_()
                        y = bn(xx)
                        y.backward(gy.to(dev))
                        out[dev] = dict(
                            y=y.detach().float().cpu(),
                            x_grad=xx.grad.float().cpu(),
                            weight_grad=bn.weight.grad.cpu(),
                            bias_grad=bn.bias.grad.cpu(),
                            running_mean=bn.running_mean.cpu(),
                            running_var=bn.running_var.cpu())
                    errs = {k: ((out["cuda"][k] - v).abs().max()
                                / v.abs().max()).item()
                            for k, v in out["cpu"].items()}
                    bf16 = dtype == torch.bfloat16
                    for k, e in errs.items():
                        bound = ((2.0 ** -7 if k in ("y", "x_grad") else 1e-4)
                                 if bf16 else 1e-5)
                        check(e <= bound, f"dp synced BatchNorm {dtype} "
                                          f"{shape} groups {groups}: {k} "
                                          f"off by {e} (bound {bound})")
                    cases.append(dict(dtype=_kind(dtype), shape=list(shape),
                                      groups=groups, rel_err=errs))
    finally:
        mesh.shutdown()
    emit(phase="dp_synced_bn", cases=cases)
    return cases


def _dp_pair_config() -> dict:
    from x_as_supervision_tpu_torch.train.factory import flagship_config

    cfg = flagship_config()
    cfg["train_params"]["batch_size"] = DP_PAIR_BATCH
    return cfg


def _dp_condition(spec) -> None:
    """Phase 7's conditioning: each residual branch's last BN scale 0.1."""
    import torch

    from x_as_supervision_tpu_torch.models.resnet import Bottleneck

    with torch.no_grad():
        for m in spec.detector.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.fill_(0.1)


def _gen_grads(spec, state, batch, generator) -> dict:
    """The generator loss's gradients (the sum of this rank's shares,
    summed over the ranks in a process group), by parameter name."""
    import torch

    from x_as_supervision_tpu_torch.models.composed import generator_forward
    from x_as_supervision_tpu_torch.parallel import collectives as C

    losses, _ = generator_forward(spec, batch, generator)
    total = sum(v.mean() for v in losses.values())
    params = state.gen_params + state.disc_params
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
        torch.autograd.grad(total, params, allow_unused=True), params)]
    (grads,) = C.psum_flat(grads)
    return dict(zip(_named_params(state), grads))


def _link_inputs(batch: int):
    """Seeded inputs of the link at its 256@16^2 training shape, fp32."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    c, side = 256, 16
    x = torch.randn((batch, c, side, side), generator=gen, device="cuda")
    w = torch.randn((c, c, 3, 3), generator=gen, device="cuda") * 0.05
    scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
    shift = torch.randn((c,), generator=gen, device="cuda") * 0.1
    return x.contiguous(memory_format=torch.channels_last), w, scale, shift


def _dp_pair_reference(root: str) -> dict:
    """The one-process side of the pair check, at the pair's global batch:
    the conditioned fp32 state written for the ranks, the generator's
    gradients, one train step's losses and parameters, and the link's
    stats on the whole batch."""
    import torch

    from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
    from x_as_supervision_tpu_torch.ops.conv_bn import fused_bn_relu_conv
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt
    from x_as_supervision_tpu_torch.train.state import train_step
    from x_as_supervision_tpu_torch.train.trainer import (
        step_generator, to_device)

    cfg = _dp_pair_config()
    cams = cfg["dataset_params"]["cam_id_list"]
    spec, state = _gan(cfg, torch.float32, "cuda", SEED)
    _dp_condition(spec)
    batch = SyntheticPoseDataset(num_samples=DP_PAIR_BATCH, cam_id_list=cams,
                                 patch_size=PATCH, seed=SEED).batch(
                                     0, DP_PAIR_BATCH)
    np.savez(os.path.join(root, "pair_batch.npz"),
             **{k: v for k, v in batch.items() if isinstance(v, np.ndarray)})
    os.makedirs(os.path.join(root, "pair_ckpt"))
    torch.save(ckpt.state_dict(state),
               os.path.join(root, "pair_ckpt", ckpt.STATE_FILE))
    dev = to_device(batch, "cuda")
    set_tf32(False)
    set_cudnn_deterministic(True)
    try:
        torch.cuda.reset_peak_memory_stats()
        grads = _gen_grads(spec, state, dev, step_generator(SEED, 0, "cuda"))
        grads = {k: v.detach().cpu() for k, v in grads.items()}
        floors, group_of_one = _gradient_floors(spec, state, dev, grads)
        metrics = train_step(state, dev, step_generator(SEED, 1, "cuda"))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        x, w, scale, shift = _link_inputs(DP_PAIR_BATCH * len(cams))
        _, stats = fused_bn_relu_conv(x, w, scale, shift)
    finally:
        set_tf32(True)
        set_cudnn_deterministic(False)
    torch.save(dict(grads=grads, floors=floors, group_of_one=group_of_one,
                    metrics={k: float(v) for k, v in metrics.items()},
                    params={k: p.detach().cpu() for k, p in
                            _named_params(state).items()},
                    stats=stats.cpu()),
               os.path.join(root, "pair_ref.pt"))
    del spec, state, dev, grads, group_of_one
    torch.cuda.empty_cache()
    return dict(peak_memory_gb=peak,
                gradient_floors={k: max(v.values()) for k, v in
                                 floors.items()})


def _rel_errs(got: dict, want: dict, skip: set) -> dict:
    """Per tensor, max |got - want| over max |want| (phase 7's measure)."""
    return {n: ((got[n].cpu() - w).abs().max() / w.abs().max()).item()
            for n, w in want.items() if n not in skip and w.abs().max() > 0}


def _gradient_floors(spec, state, batch, grads) -> dict:
    """How far the one-process gradients move without data parallelism:
    the same computation run again (``rerun``: cuDNN's backward kernels
    may add in another order each run) and the data-parallel code path in
    a process group of one (``group_of_one``, gloo: the synced BatchNorm's
    fp32 sums in place of the native kernel's), each held to `grads` by
    phase 7's measure. Returns those errors and the group of one's
    gradients (on the CPU: the ranks' reference). The BatchNorm statistics
    are restored after."""
    import copy
    import socket

    from x_as_supervision_tpu_torch.parallel import mesh
    from x_as_supervision_tpu_torch.train.trainer import step_generator

    saved = {name: copy.deepcopy(getattr(spec, name).state_dict())
             for name in ("detector", "physique")}
    skip = {"physique." + n for n in spec.physique.bn_cancelled_biases()}
    again = _gen_grads(spec, state, batch, step_generator(SEED, 0, "cuda"))
    floors = {"rerun": _rel_errs(again, grads, skip)}
    del again
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh.initialize_multihost(f"localhost:{port}", 1, 0, backend="gloo")
    try:
        one = _gen_grads(spec, state, batch, step_generator(SEED, 0, "cuda"))
        one = {k: v.detach().cpu() for k, v in one.items()}
        floors["group_of_one"] = _rel_errs(one, grads, skip)
    finally:
        mesh.shutdown()
    for name, sd in saved.items():
        getattr(spec, name).load_state_dict(sd)
    return floors, one


def _dp_rank_pair(rank: int, port: int, root: str) -> None:
    """A rank of the two-rank pair on the one card (gloo): the generator's
    gradients and one train step from the reference's state on this rank's
    half of the batch; rank 1 holds its parameters to rank 0's (sent by
    broadcast), rank 0 holds the gradients, losses and link stats to the
    one-process reference."""
    import torch
    import torch.distributed as dist

    from x_as_supervision_tpu_torch.ops.conv_bn import fused_bn_relu_conv
    from x_as_supervision_tpu_torch.parallel import collectives as C
    from x_as_supervision_tpu_torch.parallel import mesh
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt
    from x_as_supervision_tpu_torch.train.state import train_step
    from x_as_supervision_tpu_torch.train.trainer import (
        step_generator, to_device)

    torch.cuda.set_device(0)
    mesh.initialize_multihost(f"localhost:{port}", 2, rank, backend="gloo",
                              timeout_s=600)
    cfg = _dp_pair_config()
    cams = cfg["dataset_params"]["cam_id_list"]
    spec, state = _gan(cfg, torch.float32, "cuda", SEED)
    ckpt.restore_resume(os.path.join(root, "pair_ckpt"), state)
    b = DP_PAIR_BATCH // 2
    batch = {k: v[rank * b:(rank + 1) * b] for k, v in
             np.load(os.path.join(root, "pair_batch.npz")).items()}
    dev = to_device(batch, "cuda")
    set_tf32(False)
    set_cudnn_deterministic(True)
    torch.cuda.reset_peak_memory_stats()
    C.COUNTS.reset()
    grads = _gen_grads(spec, state, dev, step_generator(SEED, 0, "cuda"))
    grad_counts = C.COUNTS.snapshot()
    C.COUNTS.reset()
    t0 = time.perf_counter()
    metrics = train_step(state, dev, step_generator(SEED, 1, "cuda"))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step_counts = C.COUNTS.snapshot()
    peak = torch.cuda.max_memory_allocated() / 1e9
    x, w, scale, shift = _link_inputs(DP_PAIR_BATCH * len(cams))
    rows = x.shape[0] // 2
    _, stats = fused_bn_relu_conv(x[rank * rows:(rank + 1) * rows], w, scale,
                                  shift)
    stats = C.psum_data(stats)
    # rank 0's parameters, running statistics, carried gradient and Adam
    # moments to rank 1, bitwise
    flat = torch.cat([t.detach().reshape(-1).float() for t in (
        [p for p in _named_params(state).values()]
        + [v for m in (spec.detector, spec.physique)
           for k, v in m.state_dict().items() if "running" in k]
        + list(state.pending_disc_grads)
        + [s[k] for opt in (state.opt_det, state.opt_disc)
           for s in opt.state.values() for k in ("exp_avg", "exp_avg_sq")])])
    theirs = flat.clone()
    dist.broadcast(theirs, src=0)
    record = dict(rank=rank, metrics={k: float(v) for k, v in
                                      metrics.items()},
                  state_values=flat.numel(),
                  state_equal_to_rank0=bool(torch.equal(flat, theirs)),
                  grad_collectives=grad_counts,
                  step_collectives=step_counts, step_s=step_s,
                  peak_memory_gb=peak, backend=str(dist.get_backend()))
    if rank == 0:
        ref = torch.load(os.path.join(root, "pair_ref.pt"))
        # phase 7's rule: a bias that a train-mode BatchNorm follows has a
        # zero gradient up to rounding, which no relative bound holds
        cancelled = {"physique." + n
                     for n in spec.physique.bn_cancelled_biases()}
        # held to the one process on the same code path (the group of
        # one): the two halves summed over the ranks against the whole
        # batch; the native one-process path beside it, with its floors
        err = _rel_errs(grads, ref["group_of_one"], cancelled)
        worst = max(err, key=err.get)
        l2 = {n: ((grads[n].cpu() - w).norm() / w.norm()).item()
              for n, w in ref["group_of_one"].items() if n in err}
        native = _rel_errs(grads, ref["grads"], cancelled)
        floors = {k: (max(v, key=v.get), max(v.values()))
                  for k, v in ref["floors"].items()}
        lr = float(cfg["train_params"]["lr_kp_detector"])
        got_p = _named_params(state)
        pd = max(((got_p[n].detach().cpu() - p).abs().max().item()
                  for n, p in ref["params"].items()))
        want_stats = ref["stats"]
        stats_err = ((stats.cpu() - want_stats).abs().amax(dim=1)
                     / want_stats.abs().amax(dim=1)).tolist()
        record.update(
            loss_rel_err={k: abs(record["metrics"][k] - v) / abs(v)
                          for k, v in ref["metrics"].items()},
            grad_max_rel_err=err[worst], grad_worst_tensor=worst,
            grad_max_rel_l2=max(l2.values()),
            grad_worst=sorted(err.items(), key=lambda kv: -kv[1])[:6],
            grad_vs_native=(max(native, key=native.get),
                            max(native.values())),
            grad_floors=floors,
            param_max_diff_over_lr=pd / lr, link_stats_rel_err=stats_err)
    # gloo has no all-gather of CUDA tensors: what it says
    try:
        parts = [torch.empty(1, device="cuda") for _ in range(2)]
        dist.all_gather(parts, torch.ones(1, device="cuda"))
        record["gloo_cuda_all_gather"] = "ran"
    except RuntimeError as e:
        record["gloo_cuda_all_gather"] = str(e).splitlines()[0][:200]
    with open(os.path.join(root, f"pair_{rank}.json"), "w") as f:
        json.dump(record, f)
    mesh.shutdown()


def _dp_pair(root: str) -> dict:
    """Two gloo ranks on the one card against one process at the global
    batch (see the module docstring)."""
    import socket

    ref = _dp_pair_reference(root)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "dp-rank", "pair",
         str(r), str(port), root], cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"dp pair rank {r} exited {p.returncode}: "
                                 f"{out[-4000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"pair_{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    emit(phase="dp_pair", ranks=ranks, reference=ref)
    check(ranks[1]["state_equal_to_rank0"],
          f"dp pair: rank 1's state differs from rank 0's")
    check(max(r0["loss_rel_err"].values()) <= 1e-4,
          f"dp pair: loss rel err {r0['loss_rel_err']}")
    # against one process on the same code path (the synced statistics in
    # a group of one), by phase 7's measure: its bound 1e-2, or twice the
    # distance of the native one-process path from that same one process
    # where that is larger. Both are one process computing the same
    # function in two summation orders, so that distance is this
    # configuration's rounding floor: a random-weight fp32 ResNet-50 at
    # full depth carries it to 1.2-1.5e-2 of a gradient's largest entry
    # (PERF.md §6), where a fault of the data-parallel path (a
    # rank's own statistics or draws) moves gradients by O(1)
    bound = max(1e-2, 2 * r0["grad_floors"]["group_of_one"][1])
    r0["grad_bound"] = bound
    check(r0["grad_max_rel_err"] <= bound,
          f"dp pair: gradient of {r0['grad_worst_tensor']} off by "
          f"{r0['grad_max_rel_err']} of its largest entry (bound {bound})")
    # the kernel sums its per-block partials in a fixed order; two halves
    # summed over the ranks add the same values in another fp32 order
    check(max(r0["link_stats_rel_err"]) <= 1e-5,
          f"dp pair: link stats summed over the ranks off by "
          f"{r0['link_stats_rel_err']}")
    calls = r0["step_collectives"].get("all_reduce/data", {}).get("calls", 0)
    check(calls > 0, "dp pair: the step called no all-reduce")
    return dict(reference=ref, ranks=ranks)


def phase_dp(card: str, root: str) -> dict:
    """Data parallelism on the card (see the module docstring): (a) the
    train and eval CLIs under torchrun, one rank over NCCL, at the flagship
    width; (b) two gloo ranks on the one card against one process; (c) the
    one-rank step's cost against the step without a process group. Its
    files go under `root`, where phase_tp finds the pair's reference."""
    import torch

    from x_as_supervision_tpu_torch.checks import result_lines
    from x_as_supervision_tpu_torch.train.factory import flagship_config

    torch.cuda.empty_cache()
    cfg = flagship_config()
    cfg["train_params"].update(num_epochs=1, checkpoint_freq=1)
    cfg_path = os.path.join(root, "flagship.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    log_dir = os.path.join(root, "log")
    (train,) = _torchrun(root, "train", [
        "--config", cfg_path, "--synthetic", "--seed", str(SEED),
        "--log_dir", log_dir], timeout=600)
    steps = TRAIN_IMAGES // TRAIN_BATCH
    check(train["steps"] == steps and train["world"] == 1
          and train["backend"] == "nccl",
          f"dp train CLI: {train['steps']} steps, world "
          f"{train['world']}, backend {train['backend']}")
    for name, per_step in TRAIN_LAUNCHES.items():
        check(train["launches"][name] == per_step * steps,
              f"dp train CLI: {name} launched {train['launches'][name]}"
              f" times in {steps} steps, expected {per_step} per step")
    for name, attrs in TRAIN_PATH_LAUNCHES.items():
        for attr, per_step in attrs.items():
            got = train["path_launches"][name][attr]
            check(got == per_step * steps,
                  f"dp train CLI: {name}.{attr} = {got} in {steps} "
                  f"steps, expected {per_step} per step")
    check(all(np.isfinite(v) for h in train["history"]
              for v in h.values()), "dp train CLI: a non-finite loss")
    (run,) = os.listdir(log_dir)
    path = os.path.join(log_dir, run, "00000_ckpt")
    check(os.path.exists(os.path.join(path, "state.pt")),
          "dp train CLI: no checkpoint")
    (ev,) = _torchrun(root, "eval", [
        "--config", cfg_path, "--synthetic", "--checkpoint", path,
        "--multi_hypo", "best", "--reduce_hosts"], timeout=600)
    nb = ev["batches"]
    check(nb == ev["num_batches"] > 0, f"dp eval CLI: {nb} batches")
    for name, per_batch in EVAL_LAUNCHES.items():
        check(ev["launches"][name] == per_batch * nb,
              f"dp eval CLI: {name} launched {ev['launches'][name]} "
              f"times in {nb} batches, expected {per_batch} per batch")
    lines = result_lines(ev["result_path"])
    check(len(lines) == 15 and all(
        v is None or np.isfinite(v) for _, v in lines),
        f"dp eval CLI: eval_result.txt {lines}")
    synced_bn = _synced_bn_cases()
    pair = _dp_pair(root)
    (cost,) = _torchrun(root, "cost", [], timeout=600)
    for name, per_step in TRAIN_LAUNCHES.items():
        got = cost["launches"][name]
        check(got == per_step * cost["dp_steps"],
              f"dp cost: {name} launched {got} times in {cost['dp_steps']} "
              f"dp steps, expected {per_step} per step")
    mean = {k: sum(v) / len(v) for k, v in cost["step_ms"].items()}
    ar = cost["collectives_per_step"].get("all_reduce/data", {})
    record = dict(
        phase="dp", card=card,
        train_cli=dict(
            steps=steps, process_s=train["process_s"],
            launches_per_step={k: v / steps
                               for k, v in train["launches"].items()},
            collectives=train["collectives"],
            peak_memory_gb=train["peak_memory_gb"]),
        eval_cli=dict(batches=nb, process_s=ev["process_s"],
                      launches_per_batch={k: v / nb for k, v in
                                          ev["launches"].items()},
                      collectives=ev["collectives"],
                      ambiguity_ratio=ev["ambiguity_ratio"],
                      eval_result=[f"{k}: {v}" if v is not None else k
                                   for k, v in lines]),
        synced_bn_max_rel_err={
            kind: max(max(c["rel_err"].values()) for c in synced_bn
                      if c["dtype"] == kind) for kind in ("fp32", "bf16")},
        pair=dict(global_batch_per_camera=DP_PAIR_BATCH,
                  reference_peak_memory_gb=pair["reference"][
                      "peak_memory_gb"],
                  loss_rel_err=pair["ranks"][0]["loss_rel_err"],
                  grad_max_rel_err=pair["ranks"][0]["grad_max_rel_err"],
                  grad_worst_tensor=pair["ranks"][0]["grad_worst_tensor"],
                  grad_bound=pair["ranks"][0]["grad_bound"],
                  grad_max_rel_l2=pair["ranks"][0]["grad_max_rel_l2"],
                  grad_vs_native=pair["ranks"][0]["grad_vs_native"],
                  grad_floors=pair["ranks"][0]["grad_floors"],
                  param_max_diff_over_lr=pair["ranks"][0][
                      "param_max_diff_over_lr"],
                  link_stats_rel_err=pair["ranks"][0]["link_stats_rel_err"],
                  state_values=pair["ranks"][1]["state_values"],
                  state_bitwise_equal=pair["ranks"][1][
                      "state_equal_to_rank0"],
                  step_s=[r["step_s"] for r in pair["ranks"]],
                  peak_memory_gb=[r["peak_memory_gb"]
                                  for r in pair["ranks"]],
                  step_collectives=pair["ranks"][0]["step_collectives"],
                  gloo_cuda_all_gather=pair["ranks"][0][
                      "gloo_cuda_all_gather"]),
        cost=dict(step_ms=cost["step_ms"], mean_step_ms=mean,
                  dp_over_plain=mean["dp"] / mean["plain"],
                  peak_memory_gb=cost["peak_memory_gb"],
                  collectives_per_step=cost["collectives_per_step"],
                  all_reduce_calls_per_step=ar.get("calls", 0),
                  all_reduce_mb_per_step=ar.get("bytes", 0) / 1e6,
                  profiles=cost["profiles"]))
    emit(**record)
    return record


def _tp_kernel_cases() -> list[dict]:
    """The kernels at a tensor-parallel rank's shard shapes (B = 64, the
    pair's 4 cameras x 16) against their plain versions, fp32 with TF32
    off and bf16: the link into its Cout shard, and the physique conv that
    the split sends to the CUDA cores."""
    import torch

    batch = TP_BATCH * CAMERAS
    cases = []
    set_tf32(False)
    try:
        for dtype in (torch.bfloat16, torch.float32):
            for c, cout, side in TP_LINK_SHAPES:
                cases.append(_link_case(dtype, batch, c, side, cout))
            cases.append(_conv_case(dtype, batch, *TP_CONV))
        torch.cuda.synchronize()
    finally:
        set_tf32(True)
    for case in cases:
        emit(phase="tp_kernel", **case)
    conv = [c for c in cases if c["name"] == "conv3x3"]
    check(all(c["path"] == "cuda_core" for c in conv),
          f"tp kernels: the 32->16 conv took {[c['path'] for c in conv]}")
    return cases


def _tp_rank_pair(rank: int, port: int, root: str) -> None:
    """A rank of the tensor-parallel pair on the one card (gloo, data 1,
    model 2): phase 13's reference state cut to this rank's shards, the
    generator's gradients and one train step on the whole batch; each rank
    reads how far its replicated gradients and statistics were from model
    rank 0's before the step's broadcast (tp.replica_drift), rank 0 holds
    the gathered gradients, losses and parameters to the one process."""
    import torch
    import torch.distributed as dist

    from x_as_supervision_tpu_torch.parallel import collectives as C
    from x_as_supervision_tpu_torch.parallel import mesh, tp
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt
    from x_as_supervision_tpu_torch.train.state import train_step
    from x_as_supervision_tpu_torch.train.trainer import (
        step_generator, to_device)

    torch.cuda.set_device(0)
    mesh.initialize_multihost(f"localhost:{port}", TP_MODEL, rank,
                              backend="gloo", timeout_s=600)
    mesh.make_grid(TP_MODEL)
    cfg = _dp_pair_config()
    spec, state = _gan(cfg, torch.float32, "cuda", SEED)
    ckpt.restore_resume(os.path.join(root, "pair_ckpt"), state)
    tp.shard_state(state)
    dims = state.shard_dims
    # one data index: both model ranks read the whole batch
    dev = to_device(dict(np.load(os.path.join(root, "pair_batch.npz"))),
                    "cuda")
    set_tf32(False)
    set_cudnn_deterministic(True)
    torch.cuda.reset_peak_memory_stats()
    C.COUNTS.reset()
    grads = _gen_grads(spec, state, dev, step_generator(SEED, 0, "cuda"))
    grads = {n: (C.gather_channels(g, dims[n]) if n in dims else g)
             .detach().cpu() for n, g in grads.items()}
    grad_counts = C.COUNTS.snapshot()
    C.COUNTS.reset()
    tp.replica_drift()
    t0 = time.perf_counter()
    metrics = train_step(state, dev, step_generator(SEED, 1, "cuda"))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    drift = tp.replica_drift()
    step_counts = C.COUNTS.snapshot()
    peak = torch.cuda.max_memory_allocated() / 1e9
    whole = tp.gather_state(state, ckpt.state_dict(state))
    record = dict(rank=rank, metrics={k: float(v) for k, v in
                                      metrics.items()},
                  replica_drift=drift,
                  split_tensors=len(dims), grad_collectives=grad_counts,
                  step_collectives=step_counts, step_s=step_s,
                  peak_memory_gb=peak, backend=str(dist.get_backend()))
    if rank == 0:
        ref = torch.load(os.path.join(root, "pair_ref.pt"))
        cancelled = {"physique." + n
                     for n in spec.physique.bn_cancelled_biases()}
        # phase 13's measure, against the one process on the same code
        # path (the synced statistics in a group of one)
        err = _rel_errs(grads, ref["group_of_one"], cancelled)
        worst = max(err, key=err.get)
        l2 = {n: ((grads[n] - w).norm() / w.norm()).item()
              for n, w in ref["group_of_one"].items() if n in err}
        native = _rel_errs(grads, ref["grads"], cancelled)
        floors = {k: (max(v, key=v.get), max(v.values()))
                  for k, v in ref["floors"].items()}
        params = {f"{m}.{k}": v for m in tp.MODULES
                  for k, v in whole[m].items()}
        lr = float(cfg["train_params"]["lr_kp_detector"])
        diffs = {n: (params[n].detach().cpu() - p).abs()
                 for n, p in ref["params"].items()}
        pd = max(d.max().item() for d in diffs.values())
        # weights more than a tenth of a step from the one process's,
        # where the gradient is not zero by construction
        held = [d for n, d in diffs.items() if n not in cancelled]
        far = sum(int((d > 0.1 * lr).sum()) for d in held)
        pmax = max(p.abs().max().item() for p in ref["params"].values())
        record.update(
            param_frac_over_tenth_step=far / sum(d.numel() for d in held),
            # Adam's first step moves a weight by less than lr, so two
            # first steps from one state differ by less than 2 lr, plus
            # the two results' rounding
            param_bound_over_lr=(2 * lr + 2 * torch.finfo(
                torch.float32).eps * pmax) / lr)
        record.update(
            loss_rel_err={k: abs(record["metrics"][k] - v) / abs(v)
                          for k, v in ref["metrics"].items()},
            grad_max_rel_err=err[worst], grad_worst_tensor=worst,
            grad_max_rel_l2=max(l2.values()),
            grad_vs_native=(max(native, key=native.get),
                            max(native.values())),
            grad_floors=floors, param_max_diff_over_lr=pd / lr)
    with open(os.path.join(root, f"tp_pair_{rank}.json"), "w") as f:
        json.dump(record, f)
    mesh.shutdown()


def _tp_pair(root: str) -> list:
    """Two tensor-parallel ranks on the one card against phase 13's one
    process (see the module docstring)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "dp-rank", "tp_pair",
         str(r), str(port), root], cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(TP_MODEL)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"tp pair rank {r} exited {p.returncode}: "
                                 f"{out[-4000:]}")
    ranks = []
    for r in range(TP_MODEL):
        with open(os.path.join(root, f"tp_pair_{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    emit(phase="tp_pair", ranks=ranks)
    check(max(r0["loss_rel_err"].values()) <= 1e-4,
          f"tp pair: loss rel err {r0['loss_rel_err']}")
    # phase 13's bound: 1e-2, or twice the native one-process path's
    # distance from the same code path in a group of one
    bound = max(1e-2, 2 * r0["grad_floors"]["group_of_one"][1])
    r0["grad_bound"] = bound
    check(r0["grad_max_rel_err"] <= bound,
          f"tp pair: gradient of {r0['grad_worst_tensor']} off by "
          f"{r0['grad_max_rel_err']} of its largest entry (bound {bound})")
    # the model ranks compute the replicated values alike up to the order
    # of the kernels' atomic sums: the same bound, before the broadcast
    # that makes them equal
    drift = ranks[1]["replica_drift"]
    check(drift is not None and drift <= bound,
          f"tp pair: rank 1's replicated values {drift} of their largest "
          f"entry from rank 0's before the broadcast (bound {bound})")
    check(r0["param_max_diff_over_lr"] <= r0["param_bound_over_lr"]
          and r0["param_frac_over_tenth_step"] <= 1e-2,
          f"tp pair: weights after the step {r0['param_max_diff_over_lr']}"
          f" lr (bound {r0['param_bound_over_lr']}) from the one process's"
          f", {r0['param_frac_over_tenth_step']} of them over 0.1 lr "
          f"(bound 1e-2)")
    for op in ("all_gather/model", "all_reduce/model"):
        check(r0["step_collectives"].get(op, {}).get("calls", 0) > 0,
              f"tp pair: the step called no {op}")
    return ranks


def _tp_rank_cost(out: str) -> None:
    """Two ranks under torchrun (gloo, model 2): the bf16 flagship step at
    4 cameras x 16 split over the ranks against the same step whole in one
    process (rank 0, no process group seen), by CUDA events in turns
    (plain, tp, plain; rank 1 waits while rank 0 runs plain), with each
    rank's peak memory, launches, collectives and replica drift
    (tp.replica_drift, bf16 without cuDNN's deterministic algorithms) per
    tensor-parallel step."""
    from unittest import mock

    import torch
    import torch.distributed as dist

    from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
    from x_as_supervision_tpu_torch.parallel import collectives as C
    from x_as_supervision_tpu_torch.parallel import mesh, tp
    from x_as_supervision_tpu_torch.train.factory import flagship_config
    from x_as_supervision_tpu_torch.train.state import train_step
    from x_as_supervision_tpu_torch.train.trainer import (
        step_generator, to_device)

    mesh.initialize_multihost()
    mesh.make_grid(TP_MODEL)
    rank = mesh.process_index()
    device = mesh.rank_device()
    cfg = flagship_config()
    cfg["train_params"].update(batch_size=TP_BATCH,
                               model_parallelism=TP_MODEL)
    cams = cfg["dataset_params"]["cam_id_list"]
    spec, state = _gan(cfg, torch.bfloat16, device, SEED)
    tp.shard_state(state)
    plain_state = (_gan(cfg, torch.bfloat16, device, SEED)[1]
                   if rank == 0 else None)
    ds = SyntheticPoseDataset(num_samples=TP_BATCH * 2, cam_id_list=cams,
                              patch_size=PATCH, seed=SEED)
    batches = [to_device(ds.batch(i * TP_BATCH, TP_BATCH), device)
               for i in range(2)]

    def step(i, kind):
        if kind == "tp":
            return train_step(state, batches[i % 2],
                              step_generator(SEED, i, device))
        with mock.patch.object(dist, "is_initialized", lambda: False):
            return train_step(plain_state, batches[i % 2],
                              step_generator(SEED, i, device))

    if rank == 0:
        step(0, "plain")  # warm-up of each path
    mesh.barrier()
    step(1, "tp")
    torch.cuda.synchronize()
    times = {"plain": [], "tp": []}
    peak = {}
    counters = _counters()
    launches = dict.fromkeys(counters, 0)
    paths = {name: dict.fromkeys(attrs, 0)
             for name, attrs in TP_PATH_LAUNCHES.items()}
    tp_steps = 0
    for kind in ("plain", "tp", "plain"):
        mesh.barrier()
        if kind == "plain" and rank != 0:
            mesh.barrier()
            continue
        torch.cuda.reset_peak_memory_stats()
        before = {name: fn.launches for name, fn in counters.items()}
        before_paths = {name: {a: getattr(counters[name], a) for a in attrs}
                        for name, attrs in TP_PATH_LAUNCHES.items()}
        for i in range(TP_COST_STEPS):
            ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            if kind == "tp":
                C.COUNTS.reset()
                tp.replica_drift()
                tp_steps += 1
            ev0.record()
            step(i, kind)
            ev1.record()
            torch.cuda.synchronize()
            times[kind].append(ev0.elapsed_time(ev1))
            if kind == "tp":
                per_step = C.COUNTS.snapshot()
                drift = tp.replica_drift()
        peak[kind] = torch.cuda.max_memory_allocated() / 1e9
        if kind == "tp":
            for name, fn in counters.items():
                launches[name] += fn.launches - before[name]
            for name, attrs in TP_PATH_LAUNCHES.items():
                for a in attrs:
                    paths[name][a] += (getattr(counters[name], a)
                                       - before_paths[name][a])
        else:
            mesh.barrier()
    with open(_rank_out(out), "w") as f:
        json.dump(dict(
            rank=rank, step_ms=times, peak_memory_gb=peak, tp_steps=tp_steps,
            launches=launches, path_launches=paths,
            collectives_per_step=per_step,  # the last tp step's
            replica_drift=drift,
            backend=str(dist.get_backend()), world=mesh.process_count(),
            grid=[mesh.data_size(), mesh.model_size()],
            split_tensors=len(state.shard_dims)), f)


def phase_tp(card: str, root: str) -> dict:
    """Tensor parallelism on the card (see the module docstring): (a) the
    kernels at the shard shapes; (b) two gloo ranks against phase 13's one
    process (its reference files in `root`); (c) the train CLI under
    torchrun with model_parallelism 2, its checkpoint through the eval CLI,
    and the tensor-parallel step's cost against one process."""
    import torch

    from x_as_supervision_tpu_torch.train.factory import flagship_config

    torch.cuda.empty_cache()
    cases = _tp_kernel_cases()
    pair = _tp_pair(root)
    cfg = flagship_config()
    cfg["train_params"].update(num_epochs=1, checkpoint_freq=1,
                               batch_size=TP_BATCH,
                               model_parallelism=TP_MODEL)
    cfg_path = os.path.join(root, "flagship_tp.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    log_dir = os.path.join(root, "tp_log")
    ranks = _torchrun(root, "tp_train", [
        "--config", cfg_path, "--synthetic", "--seed", str(SEED),
        "--log_dir", log_dir], timeout=900, nproc=TP_MODEL)
    # the synthetic fixture holds max(4 B, 64) samples
    steps = max(4 * TP_BATCH, 64) // TP_BATCH
    per_rank = []
    for train in ranks:
        r = train["rank"]
        check(train["steps"] == steps and train["world"] == TP_MODEL
              and train["grid"] == [1, TP_MODEL]
              and train["backend"] == "gloo",
              f"tp train CLI rank {r}: {train['steps']} steps, world "
              f"{train['world']}, grid {train['grid']}, backend "
              f"{train['backend']}")
        for name, per_step in TRAIN_LAUNCHES.items():
            check(train["launches"][name] == per_step * steps,
                  f"tp train CLI rank {r}: {name} launched "
                  f"{train['launches'][name]} times in {steps} steps, "
                  f"expected {per_step} per step")
        for name, attrs in TP_PATH_LAUNCHES.items():
            for attr, per_step in attrs.items():
                got = train["path_launches"][name][attr]
                check(got == per_step * steps,
                      f"tp train CLI rank {r}: {name}.{attr} = {got} in "
                      f"{steps} steps, expected {per_step} per step")
        check(all(np.isfinite(v) for h in train["history"]
                  for v in h.values()), "tp train CLI: a non-finite loss")
        per_rank.append(dict(
            rank=r, process_s=train["process_s"],
            peak_memory_gb=train["peak_memory_gb"],
            launches_per_step={k: v / steps
                               for k, v in train["launches"].items()},
            path_launches_per_step={
                k: {a: n / steps for a, n in v.items()}
                for k, v in train["path_launches"].items()},
            collectives=train["collectives"]))
    (run,) = os.listdir(log_dir)
    path = os.path.join(log_dir, run, "00000_ckpt")
    check(os.path.exists(os.path.join(path, "state.pt")),
          "tp train CLI: no checkpoint")
    _, ev = _eval_cli(cfg_path, path, "best", True)
    cost = _torchrun(root, "tp_cost", [], timeout=900, nproc=TP_MODEL)
    for c in cost:
        for name, per_step in TRAIN_LAUNCHES.items():
            got = c["launches"][name]
            check(got == per_step * c["tp_steps"],
                  f"tp cost rank {c['rank']}: {name} launched {got} times in "
                  f"{c['tp_steps']} tp steps, expected {per_step} per step")
        for name, attrs in TP_PATH_LAUNCHES.items():
            for attr, per_step in attrs.items():
                got = c["path_launches"][name][attr]
                check(got == per_step * c["tp_steps"],
                      f"tp cost rank {c['rank']}: {name}.{attr} = {got} in "
                      f"{c['tp_steps']} tp steps")
    plain = cost[0]["step_ms"]["plain"]
    mean_plain = sum(plain) / len(plain)
    by_group = {op: dict(calls=v["calls"], mb=v["bytes"] / 1e6)
                for op, v in cost[0]["collectives_per_step"].items()}
    record = dict(
        phase="tp", card=card, model=TP_MODEL,
        global_batch_per_camera=TP_BATCH,
        kernel_cases=[{k: c.get(k) for k in (
            "name", "dtype", "shape", "cout", "path", "tile", "max_abs_err",
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for c in cases],
        pair=dict(
            loss_rel_err=pair[0]["loss_rel_err"],
            grad_max_rel_err=pair[0]["grad_max_rel_err"],
            grad_worst_tensor=pair[0]["grad_worst_tensor"],
            grad_bound=pair[0]["grad_bound"],
            grad_max_rel_l2=pair[0]["grad_max_rel_l2"],
            grad_vs_native=pair[0]["grad_vs_native"],
            grad_floors=pair[0]["grad_floors"],
            param_max_diff_over_lr=pair[0]["param_max_diff_over_lr"],
            param_bound_over_lr=pair[0]["param_bound_over_lr"],
            param_frac_over_tenth_step=pair[0][
                "param_frac_over_tenth_step"],
            replica_drift=[r["replica_drift"] for r in pair],
            split_tensors=pair[0]["split_tensors"],
            step_s=[r["step_s"] for r in pair],
            peak_memory_gb=[r["peak_memory_gb"] for r in pair],
            step_collectives=pair[0]["step_collectives"]),
        train_cli=dict(steps=steps, ranks=per_rank),
        eval_cli={k: ev[k] for k in ("batches", "launches_per_batch",
                                     "wgmma_per_batch", "ambiguity_ratio",
                                     "eval_result")},
        cost=dict(
            step_ms=[c["step_ms"] for c in cost],
            mean_plain_ms=mean_plain,
            mean_tp_ms=[sum(c["step_ms"]["tp"]) / len(c["step_ms"]["tp"])
                        for c in cost],
            tp_over_plain=[sum(c["step_ms"]["tp"]) / len(c["step_ms"]["tp"])
                           / mean_plain for c in cost],
            peak_memory_gb=[c["peak_memory_gb"] for c in cost],
            replica_drift=[c["replica_drift"] for c in cost],
            collectives_per_step=by_group,
            launches_per_step={k: v / cost[0]["tp_steps"]
                               for k, v in cost[0]["launches"].items()}))
    emit(**record)
    return record


def dp_rank_main(argv: list) -> int:
    """The rank processes of phase_dp and phase_tp: ``dp-rank
    train|eval|tp_train <out> <CLI args>`` and ``dp-rank cost|tp_cost
    <out>`` under torchrun, ``dp-rank pair|tp_pair <rank> <port> <dir>``
    beside its twin."""
    role = argv[0]
    if role in ("pair", "tp_pair"):
        run = _dp_rank_pair if role == "pair" else _tp_rank_pair
        run(int(argv[1]), int(argv[2]), argv[3])
        return 0
    from x_as_supervision_tpu_torch.parallel import mesh

    try:
        if role == "cost":
            _dp_rank_cost(argv[1])
        elif role == "tp_cost":
            _tp_rank_cost(argv[1])
        else:
            _dp_rank_cli(argv[1], role, argv[2:])
    finally:
        mesh.shutdown()
    return 0


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "dp-rank":
        return dp_rank_main(sys.argv[2:])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA card",
              file=sys.stderr)
        return 1
    try:
        device = phase_device()
        phase_build()
        cases = phase_kernels()
        serve, est, images = phase_serve()
        phase_profile(est, images)
        del est
        torch.cuda.empty_cache()
        train = phase_train()
        phase_train_parity()
        train_eval = phase_train_eval()
        phase_eval_parity()
        phase_real_data(device["nvidia_smi"])
        variants = phase_variants()
        mono = phase_mono(device["nvidia_smi"])
        with tempfile.TemporaryDirectory() as root:
            dp = phase_dp(device["nvidia_smi"], root)
            tp = phase_tp(device["nvidia_smi"], root)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # each kernel's line: the case at the training step's shape and type
    main_case = {
        "integral_marginals": lambda c: (c["dtype"] == "bf16"
                                         and c["shape"][0] == TRAIN_IMAGES),
        "integral_marginals_bwd": lambda c: c["dtype"] == "bf16",
        "conv_bn_link": lambda c: (c["dtype"] == "bf16"
                                   and c["shape"][:2] == [TRAIN_IMAGES, 256]),
        "conv3x3": lambda c: (c["dtype"] == "bf16"
                              and c["shape"][1:] == [32, 256, 256]
                              and c["cout"] == 32),
    }
    # and at the mono step's (batch 32, bf16)
    mono_case = {
        "integral_marginals": lambda c: (c["dtype"] == "bf16"
                                         and c["shape"][0] == TRAIN_BATCH),
        "integral_marginals_bwd": lambda c: (c["dtype"] == "bf16"
                                             and c["shape"][0] == TRAIN_BATCH),
        "conv_bn_link": lambda c: (c["dtype"] == "bf16"
                                   and c["shape"][:2] == [TRAIN_BATCH, 256]),
        "conv3x3": lambda c: (c["dtype"] == "bf16"
                              and c["shape"] == [TRAIN_BATCH, 32, 256, 256]
                              and c["cout"] == 32),
    }
    kernels = []
    for name, meta in KERNELS.items():
        case = next(c for c in cases
                    if c["name"] == name and main_case[name](c))
        mcase = next(c for c in cases + mono["kernel_cases"]
                     if c["name"] == name and mono_case[name](c))
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=train["launches"][name],
            max_abs_err=case["max_abs_err"], ms=case["ms"],
            plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
            bound_by=case["bound_by"], library_ms=case["library_ms"],
            dtype=case["dtype"], shape=case["shape"],
            library_nchw_ms=case.get("library_nchw_ms"),
            path_launches=train["path_launches_per_step"].get(name),
            serve_launches=serve["launches"].get(name),
            eval_launches=train_eval["modes"]["best"][
                "launches_per_batch"][name],
            variants_launches=variants["launches_per_step"][name],
            mono_launches=mono["train_cli"]["launches_per_step"][name],
            eval2d_launches=mono["eval2d"]["launches_per_batch"][name],
            dp_launches=dp["train_cli"]["launches_per_step"][name],
            tp_launches=tp["train_cli"]["ranks"][0]["launches_per_step"][
                name],
            tp_path_launches=tp["train_cli"]["ranks"][0][
                "path_launches_per_step"].get(name),
            mono_shape=mcase["shape"], mono_max_abs_err=mcase["max_abs_err"],
            mono_ms=mcase["ms"], mono_plain_ms=mcase["plain_ms"],
            mono_bound_ms=mcase["bound_ms"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
