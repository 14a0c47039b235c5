"""What the port's measurement tools (bench_conv_bn, bench_serve,
bench_resnet_control, bench_loader, trace_opclass, scaling_projection)
share: the device a tool runs on and the label each of its rows carries,
the card's published peaks and the least time a function could take on it,
the timer, and the kernels' launch counters.

A tool runs on the CUDA card unless the caller passes ``--device cpu``
(serve.resolve_device: asking for the card where there is none raises).
Every row carries ``device``: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, or ``"cpu"``. A CPU run's rows have times (labelled ``cpu``) but no
peak, bound, share or FLOP rate: those are device metrics.

``time_ms``: on the card, CUDA events around `iters` back-to-back calls
after `warmup` calls, then a checksum of the last call's output fetched to
the host; on the CPU the host clock around the same calls. On the card the
stream is first held by a spin of HOLD_CYCLES while the host queues the
timed calls: a call whose host work outlasts its kernels (a short kernel
behind a Python wrapper) would otherwise be timed at the host's pace.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from ..serve import resolve_device

# the dense peaks of the cards the tools know, from NVIDIA's data sheets at
# the full power limit, keyed by a part of torch.cuda.get_device_name's
# answer: bf16 and fp32 (outside the tensor cores) FLOP/s, HBM bytes/s.
# "NVIDIA H100 80GB HBM3" is the H100 SXM5.
CARD_PEAKS = {
    "H100 80GB HBM3": {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12},
    "H100 SXM": {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12},
}


# the spin that holds the stream while the host queues the timed calls:
# about 25 ms at the H100's clock of at most 2 GHz, some ten times what
# the host takes to queue 20 calls of a plain chain of a few dozen ops
HOLD_CYCLES = 50_000_000


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="where to run: the CUDA card (the default) or "
                             "cpu")


def device_label(device) -> str:
    """The label of a tool's rows: the card's ``name, power.limit`` as
    nvidia-smi gives them, or the device type (``cpu``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(index)],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(device) -> dict | None:
    """The card's published peaks (CARD_PEAKS); None off the card. A card
    the table does not name raises: its rates are not guessed."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    raise ValueError(f"no published peaks for {name!r}: add its data "
                     "sheet's dense rates to tools/measure.py:CARD_PEAKS")


def bound_ms(nbytes: float, flops: float, kind: str, peaks: dict | None):
    """(ms, "bytes" or "operations"): the larger of `nbytes` over the
    memory rate and `flops` over the `kind` ("bf16", "fp32") peak; (None,
    None) without peaks (the CPU)."""
    if peaks is None:
        return None, None
    t_bytes = nbytes / peaks["hbm"] * 1e3
    t_ops = flops / peaks[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, np.ndarray):
        return torch.from_numpy(out)
    if isinstance(out, dict):
        out = list(out.values())
    for v in out if isinstance(out, (list, tuple)) else ():
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def checksum(out) -> float:
    """The sum of the first tensor in `out` (a tensor or numpy array, or
    nested lists, tuples and dicts holding one), fetched to the host."""
    t = _first_tensor(out)
    if t is None:
        raise ValueError(f"no tensor in {type(out).__name__} to check")
    return float(t.detach().double().sum().item())


def time_ms(fn, device, iters: int = 20, warmup: int = 3):
    """(mean ms per call of fn(), checksum of the last call's output)."""
    if iters < 1:
        raise ValueError(f"iters must be at least 1, got {iters}")
    for _ in range(warmup):
        fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        ms = (time.perf_counter() - t0) * 1e3 / iters
    return ms, checksum(out)


def kernel_counters() -> dict:
    """The launch-counting wrappers of the port's four kernels, by kernel
    name: each adds one to ``launches`` where it launches its kernel (on
    a CUDA tensor) and nowhere else."""
    from ..ops.conv3x3 import conv3x3_kernel
    from ..ops.conv_bn import fused_bn_relu_conv
    from ..ops.integral_kernel import integral_marginals, marginals_backward

    return {"integral_marginals": integral_marginals,
            "integral_marginals_bwd": marginals_backward,
            "conv_bn_link": fused_bn_relu_conv, "conv3x3": conv3x3_kernel}


def launches() -> dict:
    """Each kernel's launch count so far, by kernel name."""
    return {name: fn.launches for name, fn in kernel_counters().items()}


def launches_since(before: dict, calls: int = 1) -> dict:
    """Each kernel's launches since `before` (a launches() answer), per
    one of `calls` calls."""
    return {name: (n - before[name]) / calls
            for name, n in launches().items()}


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)

