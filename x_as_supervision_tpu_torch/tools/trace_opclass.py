"""Device time of a profiled train window by op class, optionally diffing
two windows: the port of the JAX package's tools/trace_opclass.py.

Reads the Chrome trace that train/profiling.py writes under
``train_params.profile`` (``<run_dir>/profile/trace_<a>_<b>.json``: steps a
to b of the run), takes its device events (CUDA kernels, and the copies and
fills the profiler records beside them) and sums their time and count per
class, divided by ``--steps``, the train steps inside the window. The
classes:

  * each of the port's four kernels, matched by its symbol in csrc/*.cu
    (PORT_KERNELS; the link's ``stats_kernel`` adds its time to the link's
    but not a count: one wrapper call launches both);
  * ``conv_gemm``: cuDNN's, cuBLAS's and CUTLASS's convolutions and GEMMs;
  * ``batchnorm``; ``elementwise_reduce`` (PyTorch's elementwise, reduce
    and multi-tensor kernels); ``nccl``; ``memcpy_memset``; ``other``.

Given two traces it also diffs them per op name and per class (second minus
first, ms per step). A trace without kernel events (one taken on the CPU)
raises: host ops are not counted in their place. Each line carries
``device``: the trace's own names of the cards it ran on (a trace records
no power limit).

Usage:
  python -m x_as_supervision_tpu_torch.tools.trace_opclass DIR [DIR2] \
      --steps 2
DIR: a run directory, its profile directory or a trace file (the newest
trace_*.json of a directory).
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re

# symbols each wrapper call launches once (its count), then the helpers it
# launches beside them
PORT_KERNELS = {
    "integral_marginals": (("marginals_kernel",), ()),
    "integral_marginals_bwd": (("marginals_bwd_kernel",), ()),
    "conv_bn_link": (("link_wgmma_kernel", "link_fma_kernel"),
                     ("stats_kernel",)),
    "conv3x3": (("conv3x3_tc_kernel", "conv3x3_thin_kernel",
                 "conv3x3_fma_kernel"), ()),
}
# the library classes, first match wins (after the port's kernels):
# cuDNN's BatchNorm kernels hold "cudnn", so batchnorm comes before conv_gemm
LIBRARY_CLASSES = (
    ("nccl", r"nccl"),
    ("memcpy_memset", r"memcpy|memset"),
    ("batchnorm", r"batch_?norm|bn_fw|bn_bw|welford"),
    ("conv_gemm", r"cudnn|cublas|cutlass|gemm|xmma|conv|wgrad|dgrad|nvjet"),
    ("elementwise_reduce", r"elementwise|reduce|reduction|multi_tensor"),
)
CLASSES = tuple(PORT_KERNELS) + tuple(c for c, _ in LIBRARY_CLASSES) + (
    "other",)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the JAX tool's threshold for a diff line, ms per step
DIFF_MS = 0.05

_PORT = [(kernel, re.compile(r"(?<!\w)(%s)(?!\w)" % "|".join(syms)), counted)
         for kernel, (main, helpers) in PORT_KERNELS.items()
         for syms, counted in ((main, True), (helpers, False)) if syms]
_LIBRARY = [(cls, re.compile(pat, re.I)) for cls, pat in LIBRARY_CLASSES]


def classify(name: str) -> tuple[str, bool]:
    """(class, whether the event counts as a launch of it)."""
    for kernel, pat, counted in _PORT:
        if pat.search(name):
            return kernel, counted
    for cls, pat in _LIBRARY:
        if pat.search(name):
            return cls, True
    return "other", True


def find_trace(path: str) -> str:
    """A trace file: `path` itself, or the newest trace_*.json in it or in
    its profile/ directory."""
    if os.path.isfile(path):
        return path
    files = sorted(glob.glob(os.path.join(path, "trace_*.json"))
                   + glob.glob(os.path.join(path, "profile", "trace_*.json")),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no trace_*.json in {path} or its profile/")
    return files[-1]


def load_events(path: str) -> tuple[list[dict], list[str]]:
    """The device events of a trace and the names of its cards. Raises
    where it has no kernel event."""
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not any(e["cat"] == "kernel" for e in events):
        raise ValueError(
            f"{path}: no GPU kernel events (a trace taken without a card, "
            "or without CUDA activity); host ops are not counted in their "
            "place")
    cards = [d.get("name", "?") for d in trace.get("deviceProperties", [])]
    return events, cards


def tables(events: list[dict], steps: int) -> tuple[dict, dict]:
    """({class: {ms_per_step, count_per_step}}, {op name: the same})."""
    if steps < 1:
        raise ValueError(f"--steps must be at least 1, got {steps}")
    cls_ms, cls_n = collections.Counter(), collections.Counter()
    op_ms, op_n = collections.Counter(), collections.Counter()
    for e in events:
        cls, counted = classify(e["name"])
        ms = e.get("dur", 0.0) / 1e3
        cls_ms[cls] += ms
        cls_n[cls] += counted
        op_ms[e["name"]] += ms
        op_n[e["name"]] += 1

    def per_step(ms, n, keys):
        return {k: {"ms_per_step": ms[k] / steps,
                    "count_per_step": n[k] / steps} for k in keys}

    return (per_step(cls_ms, cls_n, CLASSES),
            per_step(op_ms, op_n, sorted(op_ms, key=lambda k: -op_ms[k])))


def diff(a: dict, b: dict, threshold: float = 0.0) -> dict:
    """b - a in ms per step for every key of either table, largest change
    first, those of at least `threshold`."""
    out = {k: b.get(k, {}).get("ms_per_step", 0.0)
           - a.get(k, {}).get("ms_per_step", 0.0) for k in set(a) | set(b)}
    return {k: d for k, d in sorted(out.items(), key=lambda kv: -abs(kv[1]))
            if abs(d) >= threshold}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m x_as_supervision_tpu_torch.tools.trace_opclass")
    p.add_argument("dirs", nargs="+", help="1 or 2 runs, profile directories "
                                           "or trace files")
    p.add_argument("--steps", type=int, required=True,
                   help="train steps inside the capture window")
    args = p.parse_args(argv)
    if len(args.dirs) > 2:
        p.error("at most two traces")

    rows, ops = [], []
    for d in args.dirs:
        path = find_trace(d)
        events, cards = load_events(path)
        classes, by_op = tables(events, args.steps)
        ops.append(by_op)
        rows.append({"trace": path, "steps": args.steps,
                     "total_ms_per_step": sum(c["ms_per_step"]
                                              for c in classes.values()),
                     "classes": classes, "device": ", ".join(cards)})
        print(json.dumps(rows[-1]), flush=True)
    if len(rows) == 2:
        rows.append({"diff": [r["trace"] for r in rows],
                     "classes_ms_per_step": diff(rows[0]["classes"],
                                                 rows[1]["classes"]),
                     "ops_ms_per_step": diff(ops[0], ops[1], DIFF_MS),
                     "device": [r["device"] for r in rows[:2]]})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
