#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size (never run by the benchmark itself):

    python3 bench_h100/control.py --workload <cell> --seeds 1 2 3 ... \
        [--controls 3]

For every seed the program's readings against the reference's (the lower
readings); for the first ``--controls`` seeds also the control, the
reference with float8 e4m3 GEMM operands in the program's place, and the
faults the cell can have, planted in the reference put in the program's
place (training: half of each camera's rows left out, the mean taken over
the rest; a state left unchanged reads 1 by construction) or in the
program's answers (serving: the left and right hips swapped). One JSON
line per reading.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import bench, checks  # noqa: E402
from harness import serve_cell, train_cell  # noqa: E402

SERVE_WINDOW_S = 3.0


def swap_hips(kps: np.ndarray) -> np.ndarray:
    out = kps.copy()
    out[..., [1, 4], :] = kps[..., [4, 1], :]
    return out


def train_readings(cell, seed, device, control: bool):
    t = time.perf_counter()
    out = train_cell.program(cell, seed, 0.0, False, device, t)
    pool = out.pop("pool")
    ref = train_cell.reference(cell, seed, pool, device)
    rows = [("program", *checks.train_numbers(out["readings"], ref))]
    if control:
        for what, kw in (("control_fp8", {"operands": "fp8"}),
                         ("fault_half_batch", {"half_batch": True})):
            got = train_cell.reference(cell, seed, pool, device, **kw)
            rows.append((what, *checks.train_numbers(got, ref)))
    return rows, {"setup_s": out["setup_s"]}


def serve_readings(cell, seed, device, control: bool):
    t = time.perf_counter()
    out = serve_cell.program(cell, seed, SERVE_WINDOW_S, False, device, t)
    picked = serve_cell.sample(seed, out["served"],
                               int(cell.traffic["checked_requests"]))
    slots = [s for s, _ in picked]
    ref = serve_cell.reference(cell, out["pool"], out["state"], slots,
                               device)
    rows = [("program", checks.serve_numbers(picked, ref), {})]
    if control:
        got = serve_cell.reference(cell, out["pool"], out["state"], slots,
                                   device, operands="fp8")
        rows.append(("control_fp8", checks.serve_numbers(
            [(s, got[s]) for s in slots], ref), {}))
        rows.append(("fault_swapped_hips", checks.serve_numbers(
            [(s, swap_hips(k)) for s, k in picked], ref), {}))
    return rows, {"setup_s": out["setup_s"], "requests": out["attempted"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_h100/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    cell = bench.load_cell(args.workload)
    device = torch.device("cuda", 0)
    read = train_readings if cell.kind == "train" else serve_readings
    for k, seed in enumerate(args.seeds):
        t = time.perf_counter()
        rows, extra = read(cell, seed, device, k < args.controls)
        for what, values, where in rows:
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "reading": what, "values": values,
                              "where": where, **extra,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
