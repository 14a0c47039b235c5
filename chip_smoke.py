#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (x_as_supervision_tpu_torch) on one
NVIDIA card: builds the port's kernels, holds each against its plain PyTorch
version at the shapes the serving and training paths give it, drives the
serving path once, takes a few steps of the flagship fused GAN training
step, and trains, checkpoints and evaluates the flagship config through the
port's train and eval CLIs.

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
   eval_result.txt within 1e-4 relative.

Earlier lines carry the findings as JSON; the line before the last lists the
kernels (launches per training step, per serving forward and per eval
batch), and the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def _link_case(dtype, batch: int, c: int, side: int) -> dict:
    import torch
    import torch.nn.functional as F

    from x_as_supervision_tpu_torch.ops.conv_bn import (
        FMA_TILE, bn_relu_conv_plain, fused_bn_relu_conv, link_tile)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # channels-last, as the serving path's 1x1 conv hands it over
    x = torch.randn((batch, c, side, side), generator=gen, device="cuda").to(
        dtype).contiguous(memory_format=torch.channels_last)
    w = (torch.randn((c, c, 3, 3), generator=gen, device="cuda")
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
    check(err <= tol, f"link kernel {dtype} {c}x{side}^2: max|err| {err} > "
                      f"{tol}")
    # stats: fp32 sums over B*H*W pixels in another order, so the error is
    # relative to the sum of magnitudes, not to the (cancelling) sum
    yf = ry.float()
    mags = torch.stack([yf.abs().sum(dim=(0, 2, 3)),
                        (yf * yf).sum(dim=(0, 2, 3))])
    serr = ((stats - rstats).abs() / mags.clamp_min(1e-30)).max().item()
    check(serr <= 1e-5, f"link kernel {dtype} {c}x{side}^2: stats err "
                        f"{serr} of the sum of magnitudes")
    kind = _kind(dtype)
    elt = x.element_size()
    n = batch * side * side
    nbytes = 2 * n * c * elt + 9 * c * c * elt + 2 * c * 4 + 2 * c * 4
    flops = 2.0 * n * c * 9 * c + 3.0 * n * c
    bound, by = bound_ms(nbytes, flops, kind)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = (link_tile(batch, side, side, c, sms)
            if dtype == torch.bfloat16 else FMA_TILE)
    return dict(
        name="conv_bn_link", dtype=kind, shape=[batch, c, side, side],
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


def phase_train_parity() -> dict:
    """One fused step of a reduced flagship config in fp32 on the card
    (TF32 off) against the CPU's plain path, from the same weights and
    batch. Dropout is off on both sides: the two devices' generators draw
    different bits."""
    import torch

    from x_as_supervision_tpu_torch.data.synthetic import SyntheticPoseDataset
    from x_as_supervision_tpu_torch.models.composed import generator_forward
    from x_as_supervision_tpu_torch.models.resnet import Bottleneck
    from x_as_supervision_tpu_torch.train.state import train_step
    from x_as_supervision_tpu_torch.train.trainer import to_device

    def gen_grads(spec, state, batch):
        losses, decode = generator_forward(spec, batch)
        total = sum(v.mean() for v in losses.values())
        grads = torch.autograd.grad(total, state.gen_params
                                    + state.disc_params, allow_unused=True)
        return dict(zip(_named_params(state), grads)), decode.kps.detach()

    cfg = _parity_config()
    lr = float(cfg["train_params"]["lr_kp_detector"])
    batch = SyntheticPoseDataset(num_samples=2, cam_id_list=(0, 1),
                                 patch_size=64, seed=SEED).batch(0, 2)
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
        spec.discriminator.header.p_dropout = 0.0
    cancelled = {"physique." + n
                 for n in card_spec.physique.bn_cancelled_biases()}
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
    emit(phase="train_parity_grads", kps_max_err_by_hypo_and_coord=kps_err,
         worst=sorted(grad_err.items(), key=lambda kv: -kv[1])[:12])
    # the generator's gradient, per tensor, relative to its largest entry:
    # fp32 through the conditioned ResNet-50 (kernels and cuDNN on the card,
    # the plain versions on the CPU) summed in other orders (the first
    # conditioned card run: 1.3e-3 at most); a wrong backward is off by O(1)
    check(grad_err[worst_grad] <= 1e-2,
          f"train-parity: gradient of {worst_grad} off by "
          f"{grad_err[worst_grad]} of its largest entry")
    want = train_step(cpu_state, cpu_batch)
    set_tf32(False)
    try:
        got = train_step(card_state, card_batch)
        torch.cuda.synchronize()
    finally:
        set_tf32(True)
    loss_err = {k: abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
                for k in want}
    # fp32 through ResNet-50, the decode, the renderer and the physique
    # net, convs and sums in other orders
    check(max(loss_err.values()) <= 1e-4,
          f"train-parity: loss rel err {loss_err}")
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
          f"train-parity: params max|d|/update {ratio}, median {median}, "
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
    check(stats_err <= 1e-2, f"train-parity: running stats rel err "
                             f"{stats_err}")
    record = dict(phase="train_parity", dtype="fp32",
                  config="flagship reduced: ResNet-50 at 64^2, 2 cameras, "
                         "batch 2, D = 16",
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
    for fn in _counters().values():
        fn.launches = 0
    from x_as_supervision_tpu_torch.ops.conv_bn import fused_bn_relu_conv

    fused_bn_relu_conv.launches_wgmma = 0


def phase_train_eval() -> dict:
    """train CLI -> 00000_ckpt -> restore_resume -> eval CLI in both modes,
    the flagship config at full width (see the module docstring)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from x_as_supervision_tpu_torch.checks import (bitwise_diffs, flat,
                                                   result_lines)
    from x_as_supervision_tpu_torch.eval.__main__ import main as eval_main
    from x_as_supervision_tpu_torch.ops import geometry as G
    from x_as_supervision_tpu_torch.ops.conv_bn import fused_bn_relu_conv
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt
    from x_as_supervision_tpu_torch.train.__main__ import main as train_main
    from x_as_supervision_tpu_torch.train.factory import flagship_config

    counters = _counters()
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
        train_launches = {name: fn.launches for name, fn in counters.items()}
        for name, per_step in TRAIN_LAUNCHES.items():
            check(train_launches[name] == per_step * steps,
                  f"train CLI: {name} launched {train_launches[name]} times "
                  f"in {steps} steps, expected {per_step} per step")
        check(fused_bn_relu_conv.launches_wgmma
              == TRAIN_LAUNCHES["conv_bn_link"] * steps,
              f"train CLI: {fused_bn_relu_conv.launches_wgmma} links on "
              f"wgmma of {train_launches}")
        (run,) = os.listdir(log_dir)
        path = os.path.join(log_dir, run, "00000_ckpt")
        check(sorted(os.listdir(os.path.join(log_dir, run)))
              == ["00000_ckpt", "flagship.json", "tensorboard"],
              f"train CLI: run directory holds {os.listdir(log_dir)}")
        train_events = _train_events(
            cfg, os.path.join(log_dir, run, "tensorboard"), trainer, steps)
        ckpt_mb = os.path.getsize(os.path.join(path, ckpt.STATE_FILE)) / 1e6

        # restore into a fresh state: every tensor and count bitwise equal
        # to the file and to the state that was saved
        _, fresh = _gan(cfg, torch.bfloat16, "cuda", SEED + 7)
        ckpt.restore_resume(path, fresh)
        restored = flat(ckpt.state_dict(fresh))
        saved = flat(ckpt.load_raw(path, "cuda"))
        live = flat(ckpt.state_dict(trainer.state))
        bad = bitwise_diffs(restored, saved) + bitwise_diffs(restored, live)
        check(not bad, f"restore_resume: differs from the saved state at "
                       f"{bad[:8]}")
        n_tensors = sum(torch.is_tensor(v) for v in restored.values())
        del trainer, fresh, restored, saved, live
        torch.cuda.empty_cache()

        modes = {}
        for mode in EVAL_MODES:
            _reset_counts()
            ev = eval_main(["--config", cfg_path, "--checkpoint", path,
                            "--synthetic", "--multi_hypo", mode])
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
            modes[mode] = dict(
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
                  train_launches_per_step={k: v / steps for k, v in
                                           train_launches.items()},
                  train_events=train_events,
                  checkpoint_mb=ckpt_mb, restored_tensors=n_tensors,
                  triangulation_ms=tri_ms, modes=modes)
    emit(**record)
    return record


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


def main() -> int:
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
    kernels = []
    for name, meta in KERNELS.items():
        case = next(c for c in cases
                    if c["name"] == name and main_case[name](c))
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
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
