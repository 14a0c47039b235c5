#!/usr/bin/env python3
"""The benchmark of x_as_supervision_tpu_torch on NVIDIA H100 cards.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. It loads the cell named in BENCHMARK.json
with its configuration, traffic and limits, builds the program from the
seed's weights on the card, warms up the cell's own shapes (set-up, timed
from the process's start), measures for ``--seconds``, checks what the
timed path produced against the plain reference (reference/gan.py), and
prints one JSON line: with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a profiler trace of a
few steps or requests after the window. Without the program in the tree
it prints no result and exits with 5, without enough CUDA cards with 3,
and if a JAX module was loaded with 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import torch  # noqa: E402

from harness import bench  # noqa: E402
from harness.checks import judge  # noqa: E402
from harness.work import card_peaks  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(prog="bench_h100/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, peaks: dict | None, **fault) -> dict:
    """One run of `cell` on `device`: the driver's record, its metrics
    and the checks. ``fault`` passes a stand-in for the timed call to the
    driver (tests)."""
    drv = bench.driver(cell)
    run = drv.run(cell, seed, seconds, trace, device, t_start, **fault)
    run.update(kind=cell.kind, dtype=bench.SHORT[cell.dtype], peaks=peaks,
               work=drv.work(cell, peaks) if peaks else None)
    metrics = {}
    for e in bench.metric_entries(cell.name, trace):
        value = bench.read_metric(e["name"], run)
        if value is not None:
            metrics[e["name"]] = {"value": float(value), "unit": e["unit"]}
    run["correct"], run["checks"] = judge(run["values"], cell.limits)
    run["metrics"] = metrics
    return run


def main(argv=None) -> int:
    args = parse(argv)
    cell = bench.load_cell(args.workload)
    if importlib.util.find_spec("x_as_supervision_tpu_torch") is None:
        print("the program (x_as_supervision_tpu_torch) is not in this "
              "tree: no result", file=sys.stderr)
        return 5
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 3
    # the program's cuDNN and cuBLAS work in their default modes; only the
    # reference turns TF32 off, after the window
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(device)
    run = measure(cell, args.seed, args.seconds, bool(args.trace), device,
                  T_START, card_peaks(name))
    loaded = bench.forbidden_modules()
    if loaded:
        print(f"JAX modules loaded in the measured process: {loaded}",
              file=sys.stderr)
        return 4
    dev = {"platform": "gpu", "kind": name, "count": cell.chips,
           "memory_peak_bytes": int(run["peak_bytes"])}
    line = {"correct": bool(run["correct"]), "attempted": run["attempted"],
            "failed": run["failed"], "metrics": run["metrics"],
            "device": dev}
    if args.trace:
        tr = run["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = run["checks"]
    if args.trace:
        tr = run["trace"]
        print(json.dumps({"device_ms_per_unit_by_class": {
            k: v / tr["units"] for k, v in sorted(tr["class_ms"].items())}}),
            file=sys.stderr)
    print(json.dumps({"where": run["where"]}), file=sys.stderr)
    for k, v in run["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
