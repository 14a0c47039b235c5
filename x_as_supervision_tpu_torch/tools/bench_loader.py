"""Host input-pipeline throughput, the port of the JAX package's
tools/bench_loader.py.

Measures the training feed the port's train CLI drives: data/factory.py's
basic_data -> data/loader.py:BatchLoader (a thread pool, prefetch 2) ->
train/trainer.py:to_device (each batch copied to the device the step runs
on), in samples/s and device images/s (samples times cameras), for three
settings of the feed's two knobs: the uint8 feed (``uint8_feed``) and the
geodesic distance maps (``geodesic_pt_list`` with ``compute_geodesic``).
Given the device's demand (``--device-demand``, the images per second the
train step consumes on that device, measured by the caller), each row
also says the feed's headroom over it and the summary whether the feed
bounds the step.

Usage:
  python -m x_as_supervision_tpu_torch.tools.bench_loader --config <cfg>
      [--batches 12] [--batch-size 32] [--worker 12]
      [--device-demand IMG_S] [--device cpu]
Prints one JSON line per knob setting and a summary line. The first batch
of each setting is a warm-up (the pool's start and the first prefetch);
the next min(--batches, batches in the epoch - 1) are timed, so the
dataset must hold at least two batches.
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import torch

from ..config import load_config
from ..data.factory import basic_data
from ..data.loader import BatchLoader
from ..train.trainer import to_device
from . import measure

KNOBS = (
    # the shipped feed: uint8 images and masks, no geodesic maps
    ("uint8+nogeo", {"uint8_feed": True, "geodesic_pt_list": [],
                     "compute_geodesic": False}),
    # fp32 images and masks from the host, no geodesic maps: against the
    # first row, the cost of the fp32 feed alone
    ("f32+nogeo", {"uint8_feed": False, "geodesic_pt_list": [],
                   "compute_geodesic": False}),
    # the uint8 feed with the geodesic maps of joint 0 computed (the FMM
    # solve per camera image): against the first row, the maps' cost
    ("uint8+geo", {"uint8_feed": True, "geodesic_pt_list": [0],
                   "compute_geodesic": True}),
)


def measure_feed(config: dict, batches: int, workers: int, device,
                 seed: int = 0) -> dict:
    """One warm-up batch, then min(batches, len(loader) - 1) timed ones,
    each copied to `device` (host clock; the card synchronized before the
    clock stops)."""
    if batches < 1:
        raise ValueError(f"--batches must be at least 1, got {batches}")
    dataset = basic_data(config, seed=seed)
    batch_size = config["train_params"]["batch_size"]
    loader = BatchLoader(dataset, batch_size=batch_size, shuffle=True,
                         num_workers=workers, prefetch=2, seed=seed)
    if len(loader) < 2:
        raise ValueError(
            f"the loader yields {len(loader)} batch(es) of {batch_size} from "
            f"{len(dataset)} samples: the measurement needs at least two, "
            "one warm-up and one timed")
    timed = min(batches, len(loader) - 1)
    it = loader.epoch(0)
    to_device(next(it), device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(timed):
        to_device(next(it), device)
    if cuda:
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    it.close()
    n = timed * batch_size
    cams = len(config["dataset_params"]["cam_id_list"])
    return {"samples_s": n / dt, "device_imgs_s": n * cams / dt,
            "batches": timed, "seconds": dt}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m x_as_supervision_tpu_torch.tools.bench_loader")
    p.add_argument("--config", required=True)
    p.add_argument("--batches", type=int, default=12)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--worker", type=int, default=12)
    p.add_argument("--device-demand", type=float, default=None,
                   help="images/s the train step consumes on the device, "
                        "measured there; without it no headroom is given")
    measure.add_device_arg(p)
    args = p.parse_args(argv)

    device = measure.resolve_device(args.device)
    label = measure.device_label(device)
    base = load_config(args.config)
    base["train_params"]["batch_size"] = args.batch_size
    rows, results = [], {}
    for name, over in KNOBS:
        cfg = copy.deepcopy(base)
        cfg["dataset_params"].update(over)
        res = measure_feed(cfg, args.batches, args.worker, device)
        results[name] = res
        row = {"knob": name, **res, "device": label}
        if args.device_demand is not None:
            row["feed_headroom_vs_device"] = (res["device_imgs_s"]
                                              / args.device_demand)
        rows.append(row)
        measure.emit(row)

    shipped = results["uint8+nogeo"]["device_imgs_s"]
    summary = {"summary": "host_feed", "host_cpus": os.cpu_count(),
               "shipped_feed_imgs_s": shipped, "device": label}
    if args.device_demand is not None:
        summary.update(device_demand_imgs_s=args.device_demand,
                       feed_bound=shipped < args.device_demand)
    rows.append(summary)
    measure.emit(summary)
    return rows


if __name__ == "__main__":
    main()
