#!/usr/bin/env python3
"""A traced run of a cell as run.py makes it, with the program's spans read
from the traced stretch (harness/spans.py). The benchmark's own line does
not carry that reading until ``trace.summarize`` merges it.

    python3 bench_h100/spans_run.py --workload <cell> --seed <n> \
        --seconds <s> [--out FILE]

run from the root of a checkout. It prints run.py's ``--trace 1`` line,
then one JSON line ``{"spans": ...}``: device ms, launches and idle
seconds a step or request under each span, the innermost span's ms by op
class, the readings of ``READINGS``, the phases' share of the traced
device time and of its idle time, the traced window's ms a step or
request, the spans entered a step or request, and what a span costs with
no profiler recording (us, this process, after the run). ``--out`` also
writes the whole summary there.

It reads the spans by putting its own ``summarize`` in place of the one
that harness/train_cell.py and harness/serve_cell.py import by name from
harness/trace.py; should they stop importing it so, no summary reaches it
and it returns 1. It goes once ``trace.summarize`` merges
``spans.attribute`` and readers under metrics/ read the six readings.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import timeit

import run  # bench_h100/run.py: the script's directory leads sys.path
from harness import bench, serve_cell, spans, trace, train_cell

# the per-layer readings the spans give: kind of cell and the spans whose
# device ms a step or request add up to each (the span ms do not nest
# within one reading)
READINGS = {
    "forward_ms_per_step.train": (
        "train", ("xas.train.gen_forward", "xas.train.disc_forward")),
    "backward_ms_per_step.train": (
        "train", ("xas.train.gen_backward", "xas.train.disc_backward")),
    "optimizer_ms_per_step.train": ("train", ("xas.train.optimizer",)),
    "recompute_ms_per_step.train": ("train", ("xas.remat.recompute",)),
    "kernel_ops_ms_per_step.train": ("train", spans.KERNEL_OPS),
    "preprocess_ms_per_request.serve": ("serve", ("xas.serve.preprocess",)),
}

_last = {}


class _Exported:
    """A profiler's trace, exported once (a profiler exports only once),
    for a reader that exports it."""

    def __init__(self, path: str):
        self.path = path

    def export_chrome_trace(self, path: str) -> None:
        shutil.copyfile(self.path, path)


def summarize(prof, units: int, top: int = 10) -> dict:
    """``trace.summarize`` with the span readings merged in."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out = trace.summarize(_Exported(path), units, top)
        with open(path) as f:
            out.update(spans.attribute(json.load(f).get("traceEvents", [])))
    finally:
        os.unlink(path)
    return out


def reading(run: dict, name: str):
    """The per-layer reading `name` of READINGS: device ms a step or
    request under its spans, or None where the run has no trace of its
    kind or the trace none of those spans."""
    kind, names = READINGS[name]
    if run.get("kind") != kind or not run.get("trace"):
        return None
    ms = run["trace"].get("span_ms") or {}
    if not any(n in ms for n in names):
        return None
    return sum(ms.get(n, 0.0) for n in names) / run["trace"]["units"]


def _summarize(prof, units, top=10):
    _last["summary"] = summarize(prof, units, top)
    return _last["summary"]


def per_unit(summary: dict, kind: str) -> dict:
    """The span readings of a `kind` ("train" or "serve") cell's trace
    summary a step or request, the readings of READINGS, and the phases'
    shares."""
    n = summary["units"]
    phases = spans.TRAIN_PHASES if kind == "train" else spans.SERVE_STAGES
    device_ms = sum(summary["class_ms"].values())
    idle_s = summary["window_s"] - summary["busy_s"]
    gaps = dict(summary["idle_gaps_by_span"])
    fake = {"kind": kind, "trace": summary}
    return {
        "kind": kind,
        "units": n,
        "traced_ms_per_unit": 1e3 * summary["window_s"] / n,
        "device_ms_per_unit": device_ms / n,
        "idle_ms_per_unit": 1e3 * idle_s / n,
        "span_ms": {k: v / n for k, v in sorted(summary["span_ms"].items())},
        "span_launches": {k: v / n for k, v in
                          sorted(summary["span_launches"].items())},
        "span_class_ms": {
            k: {c: ms / n for c, ms in sorted(v.items())}
            for k, v in sorted(summary["span_class_ms"].items())},
        "idle_ms_by_span": {k: 1e3 * v / n for k, v in gaps.items()},
        "span_entered": {k: v / n for k, v in
                         sorted(summary["span_entered"].items())},
        "spans_entered_per_unit": sum(summary["span_entered"].values()) / n,
        "readings": {k: reading(fake, k) for k in READINGS},
        "phase_share_of_device_ms": sum(
            summary["span_ms"].get(p, 0.0) for p in phases) / device_ms,
        "idle_share_in_spans": sum(
            v for k, v in gaps.items() if k != spans.NO_SPAN) / idle_s,
        "h2d_ms_per_unit": summary["h2d_ms"] / n,
    }


def span_cost_us(number: int = 200_000) -> dict:
    """Microseconds to enter and leave a span with no profiler recording,
    and an unguarded record_function, on this process's host."""
    import torch

    from x_as_supervision_tpu_torch.spans import span

    def guarded():
        with span("xas.cost"):
            pass

    def unguarded():
        with torch.profiler.record_function("xas.cost"):
            pass

    return {"guarded_us": min(timeit.repeat(guarded, number=number,
                                            repeat=3)) / number * 1e6,
            "unguarded_us": min(timeit.repeat(unguarded, number=number // 10,
                                              repeat=3)) / (number // 10)
            * 1e6}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_h100/spans_run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    train_cell.summarize = serve_cell.summarize = _summarize
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc or "summary" not in _last:
        return rc or 1
    out = per_unit(_last["summary"], bench.load_cell(args.workload).kind)
    out["workload"] = args.workload
    out["cost"] = span_cost_us()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(out, summary=_last["summary"]), f)
    print(json.dumps({"spans": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
