"""The device trace of a few steady steps or requests: the PyTorch
profiler's Chrome trace, read back into device time by op class, the busy
union, the host-to-device copies, and the idle gaps by what the host was
doing.

The op classes are the program's own table (its trace_opclass tool),
copied here so that the yardstick stays put: each of the four hand-written
kernels by its symbol, then cuDNN's and cuBLAS's convolutions and GEMMs,
BatchNorm, elementwise and reduction kernels, NCCL, copies and fills.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# symbols each wrapper call launches once, then the helpers beside them
PORT_KERNELS = {
    "integral_marginals": (("marginals_kernel",), ()),
    "integral_marginals_bwd": (("marginals_bwd_kernel",), ()),
    "conv_bn_link": (("link_wgmma_kernel", "link_fma_kernel"),
                     ("stats_kernel",)),
    "conv3x3": (("conv3x3_tc_kernel", "conv3x3_thin_kernel",
                 "conv3x3_fma_kernel"), ()),
}
LIBRARY_CLASSES = (
    ("nccl", r"nccl"),
    ("memcpy_memset", r"memcpy|memset"),
    ("batchnorm", r"batch_?norm|bn_fw|bn_bw|welford"),
    ("conv_gemm", r"cudnn|cublas|cutlass|gemm|xmma|conv|wgrad|dgrad|nvjet"),
    ("elementwise_reduce", r"elementwise|reduce|reduction|multi_tensor"),
)
_PORT = [(k, re.compile(r"(?<!\w)(%s)(?!\w)" % "|".join(syms)))
         for k, (main, helpers) in PORT_KERNELS.items()
         for syms in (main, helpers) if syms]
_LIBRARY = [(c, re.compile(p, re.I)) for c, p in LIBRARY_CLASSES]


def classify(name: str) -> str:
    for kernel, pat in _PORT:
        if pat.search(name):
            return kernel
    for cls, pat in _LIBRARY:
        if pat.search(name):
            return cls
    return "other"


def profile():
    """A profiler of the host and the card; record the traced steps inside
    ``torch.profiler.record_function(WINDOW)`` and synchronise before it
    closes."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    return _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, units: int, top: int = 10) -> dict:
    """The trace of `units` steps or requests: window and busy seconds,
    device ms by class and by op, device events, host-to-device copy ms,
    and the ten largest device ops and idle gaps (by the innermost host op
    running at the gap's start)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"no {WINDOW} range in the trace")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    if not any(e["cat"] == "kernel" for e in dev):
        raise RuntimeError("no kernel in the trace: the card was not traced")
    spans = []
    cls_ms, op_ms = collections.Counter(), collections.Counter()
    h2d_ms = 0.0
    n_events = 0
    for e in dev:
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        n_events += 1
        spans.append((a, b))
        ms = (b - a) / 1e3
        cls_ms[classify(e["name"])] += ms
        op_ms[e["name"]] += ms
        if "HtoD" in e["name"]:
            h2d_ms += ms
    busy = _union(spans)
    busy_us = sum(b - a for a, b in busy)
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "cpu_op")
    starts = [h[0] for h in host]
    by_host = collections.Counter()
    for a, b in gaps:
        i = bisect.bisect_right(starts, a)
        name = "(no host op)"
        for j in range(i - 1, max(-1, i - 400), -1):
            if host[j][1] >= a:
                name = host[j][2]
                break
        by_host[name] += (b - a) / 1e6
    return {
        "units": units,
        "window_s": (t1 - t0) / 1e6,
        "busy_s": busy_us / 1e6,
        "class_ms": dict(cls_ms),
        "device_events": n_events,
        "h2d_ms": h2d_ms,
        "device_ops": [[k, v / 1e3] for k, v in op_ms.most_common(top)],
        "idle_gaps": [[k, v] for k, v in by_host.most_common(top)],
    }
