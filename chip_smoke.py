#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (x_as_supervision_tpu_torch) on one
NVIDIA card: builds the port's kernels, holds each against its plain PyTorch
version at the serving shapes, and drives the serving path once.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which fails the run (nonzero exit, no result line):

1. versions, and the card's name and power limit from nvidia-smi;
2. build: every csrc/*.cu with nvcc for sm_90a, all compilers started
   together;
3. kernels: each kernel at the shapes the serving path gives it, in fp32 and
   bf16, against its plain version on the same inputs (fp32 with TF32 off);
   kernel, plain and library times with CUDA events;
4. serving: PoseEstimator with the HM36_Multi_SurS2 detector (ResNet-50,
   256^2 patches, K=18, D=64, 3 hypotheses) in bf16 at batch 32 on 64 seeded
   images, with seeded weights conditioned for a stable eval forward. The
   launch counts are set to 0 just before this run and read just after it:
   one decode and seven links per forward. Then the card's fp32 path against
   the CPU's plain fp32 path on a few images, and lift_to_world.

Earlier lines carry the findings as JSON; the line before the last lists the
kernels, and the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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

KERNELS = {
    "integral_marginals": dict(
        source="x_as_supervision_tpu_torch/csrc/integral_marginals.cu",
        replaces="x_as_supervision_tpu/ops/integral_pallas.py:75"),
    "conv_bn_link": dict(
        source="x_as_supervision_tpu_torch/csrc/conv_bn_link.cu",
        replaces="x_as_supervision_tpu/ops/conv_bn_pallas.py:52"),
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


def _marginals_case(dtype, batch: int) -> dict:
    import torch

    from x_as_supervision_tpu_torch.ops.integral_kernel import (
        integral_marginals, marginals_plain)

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
    outputs = batch * k * (2 * side + d + 2) * 4
    nbytes = x.numel() * x.element_size() + outputs
    flops = 5.0 * x.numel()  # subtract, exp, three marginal adds
    bound, by = bound_ms(nbytes, flops, "fp32")
    return dict(
        name="integral_marginals", dtype=_kind(dtype),
        shape=list(x.shape), max_abs_err=err,
        ms=cuda_ms(lambda: integral_marginals(x, k)),
        plain_ms=cuda_ms(lambda: marginals_plain(x, k)),
        library_ms=None, bound_ms=bound, bound_by=by,
    )


def _link_case(dtype, batch: int, c: int, side: int) -> dict:
    import torch
    import torch.nn.functional as F

    from x_as_supervision_tpu_torch.ops.conv_bn import (
        bn_relu_conv_plain, fused_bn_relu_conv)

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
    return dict(
        name="conv_bn_link", dtype=kind, shape=[batch, c, side, side],
        max_abs_err=err, stats_rel_err=serr,
        ms=cuda_ms(lambda: fused_bn_relu_conv(x, w, scale, shift)),
        plain_ms=cuda_ms(lambda: bn_relu_conv_plain(x, w, scale, shift)),
        library_ms=cuda_ms(lambda: F.conv2d(x, w, padding=1)),
        bound_ms=bound, bound_by=by,
    )


def phase_kernels() -> list[dict]:
    """Every kernel at the serving shapes, fp32 with TF32 off, and bf16."""
    import torch

    cases = []
    set_tf32(False)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(_marginals_case(dtype, SERVE_BATCH))
            for c, side, _ in LINK_SHAPES:
                cases.append(_link_case(dtype, SERVE_BATCH, c, side))
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    result = est(images)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"integral_marginals": integral_marginals.launches,
                "conv_bn_link": fused_bn_relu_conv.launches}
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
    check(launches["conv_bn_link"] == links,
          f"link launches {launches['conv_bn_link']} != {links}")

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
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    emit(phase="profile", images=len(batch), window_us=window_us,
         device_busy_us=busy_us,
         busy_share=busy_us / window_us if rows else None,
         top=[dict(name=k[:90], us=d, calls=c) for d, c, k in rows[:top]])


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
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    main_case = {"integral_marginals": ("fp32", None),
                 "conv_bn_link": ("bf16", LINK_SHAPES[0][0])}
    for name, meta in KERNELS.items():
        dtype, channels = main_case[name]
        case = next(c for c in cases if c["name"] == name
                    and c["dtype"] == dtype
                    and (channels is None or c["shape"][1] == channels))
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=serve["launches"][name],
            max_abs_err=case["max_abs_err"], ms=case["ms"],
            plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
            bound_by=case["bound_by"], library_ms=case["library_ms"],
            dtype=case["dtype"], shape=case["shape"],
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
