"""Isolated benchmark of the link kernel: the port of the JAX package's
tools/bench_conv_bn.py.

Times ops/conv_bn.py:fused_bn_relu_conv (csrc/conv_bn_link.cu: BN-apply ->
ReLU -> 3x3 conv -> the output's (sum, sumsq)) against its plain PyTorch
chain ops/conv_bn.py:bn_relu_conv_plain (the counterpart of JAX's
xla_bn_relu_conv) and against ``F.conv2d`` alone, at the detector's
stride-1 3x3 shapes. The JAX tool's ``<spatial>x<channels>`` shapes are
NHWC; here each is an NCHW batch (B, C, S, S) in channels-last memory, as
the detector's 1x1 conv hands it to the link, with w (C, C, 3, 3). bf16
runs the kernel's wgmma path, ``--dtype f32`` its FMA path.

Each row: ``fused_ms``, ``plain_ms``, ``library_ms`` (``F.conv2d``),
``speedup`` (plain over fused), ``fused_tflops``, ``bound_ms`` (the larger
of x, w, scale, shift read once and y, stats written once over the memory
rate, and the conv's and the BN-apply's operations over the type's peak),
``max_abs_err`` of y against the plain version with ``y_max`` (the plain
y's largest magnitude) and the stats' error relative to their sums of
magnitudes, each kernel's launches per call, and ``device``. Inputs come from
numpy's generator seeded 0.

Usage: python -m x_as_supervision_tpu_torch.tools.bench_conv_bn
       [--batch 128] [--iters 20] [--shapes 32x128,16x256,8x512]
       [--dtype bf16|f32] [--check_batches 2,8,16,128] [--device cpu]

--check_batches: the exactness-only sweep (no timing) of those batch sizes
per shape.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv_bn import bn_relu_conv_plain, fused_bn_relu_conv
from . import measure

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# untimed calls before each timed run (the JAX tool's)
WARMUP = 3


def inputs(rng: np.random.Generator, batch: int, side: int, channels: int):
    """The JAX tool's draws in NCHW: x (B, C, S, S) normal, w (C, C, 3, 3)
    normal * 0.05, scale uniform(0.5, 1.5), shift normal * 0.1; fp32 numpy
    arrays."""
    x = rng.normal(size=(batch, channels, side, side))
    w = rng.normal(size=(channels, channels, 3, 3)) * 0.05
    scale = rng.uniform(0.5, 1.5, channels)
    shift = rng.normal(size=channels) * 0.1
    return tuple(a.astype(np.float32) for a in (x, w, scale, shift))


def to_torch(arrays, dtype, device):
    """x and w in `dtype` (x channels-last), scale and shift fp32."""
    x, w, scale, shift = (torch.from_numpy(a).to(device) for a in arrays)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    return x, w.to(dtype), scale, shift


def errors(x, w, scale, shift) -> dict:
    """The kernel against its plain version on the same inputs: y's
    largest difference and the plain y's largest magnitude; the stats'
    largest difference relative to the sum of magnitudes it came from."""
    y, stats = fused_bn_relu_conv(x, w, scale, shift)
    ry, rstats = bn_relu_conv_plain(x, w, scale, shift)
    yf = ry.float()
    mags = torch.stack([yf.abs().sum(dim=(0, 2, 3)),
                        (yf * yf).sum(dim=(0, 2, 3))])
    return dict(
        y_max_abs_err=(y.float() - yf).abs().max().item(),
        y_max=yf.abs().max().item(),
        stats_max_abs_err=(stats - rstats).abs().max().item(),
        stats_rel_err=((stats - rstats).abs()
                       / mags.clamp_min(1e-30)).max().item())


def bench_shape(rng, batch: int, side: int, channels: int, dtype: str,
                device, iters: int, peaks, label: str) -> dict:
    x, w, scale, shift = to_torch(inputs(rng, batch, side, channels),
                                  DTYPES[dtype], device)
    err = errors(x, w, scale, shift)
    before = measure.launches()
    fused_ms, _ = measure.time_ms(
        lambda: fused_bn_relu_conv(x, w, scale, shift), device, iters,
        WARMUP)
    per_call = measure.launches_since(before, iters + WARMUP)
    plain_ms, _ = measure.time_ms(
        lambda: bn_relu_conv_plain(x, w, scale, shift), device, iters,
        WARMUP)
    library_ms, _ = measure.time_ms(
        lambda: F.conv2d(x, w, padding=1), device, iters, WARMUP)
    n = batch * side * side
    elt = x.element_size()
    conv_flops = 2.0 * n * channels * 9 * channels
    # read x, w, scale and shift once, write y and the stats once
    nbytes = (2 * n * channels * elt + 9 * channels * channels * elt
              + 2 * channels * 4 + 2 * channels * 4)
    kind = "bf16" if dtype == "bf16" else "fp32"
    bound, by = measure.bound_ms(nbytes, conv_flops + 3.0 * n * channels,
                                 kind, peaks)
    return {
        "shape": f"{channels}x{side}x{side}", "layout": "NCHW",
        "batch": batch, "dtype": dtype,
        "path": (("wgmma" if kind == "bf16" else "fma")
                 if peaks is not None else "plain"),
        "fused_ms": fused_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "speedup": plain_ms / fused_ms,
        "fused_tflops": (conv_flops / fused_ms / 1e9
                         if peaks is not None else None),
        "bound_ms": bound, "bound_by": by,
        "max_abs_err": err["y_max_abs_err"], "y_max": err["y_max"],
        "stats_rel_err": err["stats_rel_err"],
        "launches_per_call": per_call, "device": label,
    }


def _shapes(spec: str):
    return [tuple(int(v) for v in s.split("x")) for s in spec.split(",")]


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m x_as_supervision_tpu_torch.tools.bench_conv_bn")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--shapes", default="32x128,16x256,8x512",
                   help="comma list of <spatial>x<channels>")
    p.add_argument("--dtype", default="bf16", choices=tuple(DTYPES))
    p.add_argument("--check_batches", default=None,
                   help="exactness-only sweep over these batch sizes")
    measure.add_device_arg(p)
    args = p.parse_args(argv)

    device = measure.resolve_device(args.device)
    label = measure.device_label(device)
    rng = np.random.default_rng(0)
    rows = []
    if args.check_batches:
        for side, channels in _shapes(args.shapes):
            for b in (int(v) for v in args.check_batches.split(",")):
                x, w, scale, shift = to_torch(
                    inputs(rng, b, side, channels), DTYPES[args.dtype],
                    device)
                err = errors(x, w, scale, shift)
                rows.append({"shape": f"{b}x{channels}x{side}x{side}",
                             "layout": "NCHW", "dtype": args.dtype, **err,
                             "device": label})
                measure.emit(rows[-1])
        return rows

    peaks = measure.card_peaks(device)
    for side, channels in _shapes(args.shapes):
        rows.append(bench_shape(rng, args.batch, side, channels, args.dtype,
                                device, args.iters, peaks, label))
        measure.emit(rows[-1])
    return rows


if __name__ == "__main__":
    main()
