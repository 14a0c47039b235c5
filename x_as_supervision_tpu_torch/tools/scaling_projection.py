"""Data-parallel scaling: the collective traffic of a real train step, and a
projection of its all-reduce onto more cards; the port of the JAX
package's tools/scaling_projection.py.

The JAX tool compiled the step for a virtual mesh and read its collectives
out of the HLO. The port has no HLO: this tool runs the flagship fused GAN
step (``--tiny``: the tests' shape) on the ranks it is launched with
(torchrun, or one process, a world of one; gloo with ``--device cpu``,
NCCL on cards: parallel/mesh.py), at ``--per-device-batch`` samples of
every camera a rank, with seeded weights and the synthetic fixture:

1. Measured traffic: one step's collectives (parallel/collectives.py:
   COUNTS, calls and bytes by op kind and group), and the gradient
   all-reduce among them (train/state.py's ``C.psum_flat``).
2. Analytic cross-check (the JAX tool's ``analytic``): parameter counts
   by module; the bytes of the gradients the fused step sums, from the
   state (every generator parameter's and, twice, every discriminator
   parameter's: its own gradient and the one the generator's loss leaves
   to be carried); the BatchNorm channels of the detector and the
   physique net, whose statistics are synced.
3. Weak scaling: each kernel's launches per step, and the FLOPs per step
   that torch.utils.flop_counter.FlopCounterMode counts (PyTorch's ops;
   the port's kernels, launched through ctypes, are not among them), on
   this rank's batch in the process group (P = world) and with no process
   group seen (P = 1, the same batch). The JAX tool compared compiled
   FLOPs per device; equal counts here mean that the data-parallel step
   runs no more work per rank than one process does.
4. Projection, only with ``--link-gbps`` (the caller's all-reduce
   bandwidth per card, GB/s): a bandwidth-optimal ring all-reduce of the
   step's measured all-reduce bytes B on n cards takes 2 B (n - 1) / n /
   bandwidth (per-call latency left out), set against the one-process
   step's measured time.

Usage:
  python -m x_as_supervision_tpu_torch.tools.scaling_projection \
      [--tiny] [--per-device-batch 4] [--fp32] [--link-gbps GBPS] \
      [--out report.json] [--device cpu]
  python -m torch.distributed.run --standalone --nproc_per_node P \
      -m x_as_supervision_tpu_torch.tools.scaling_projection ...
Rank 0 prints the report as one JSON line, or writes it to --out.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from unittest import mock

import torch
import torch.distributed as dist
import torch.nn as nn

from ..parallel import collectives as C
from ..parallel import mesh
from . import measure

# the cards the projection is made for (the JAX tool's)
PROJECT_CARDS = (8, 16, 64, 256)


def ring_allreduce_ms(nbytes: float, n: int, link_gbps: float) -> float:
    """A bandwidth-optimal ring all-reduce of `nbytes` on `n` cards: each
    card sends and receives 2 nbytes (n - 1) / n at `link_gbps` GB/s."""
    if n <= 1:
        return 0.0
    return 2.0 * nbytes * (n - 1) / n / (link_gbps * 1e9) * 1e3


def projection(nbytes: float, step_ms: float, images_per_step: int,
               link_gbps: float, cards=PROJECT_CARDS) -> list[dict]:
    """Per card count: the all-reduce's ms, the step's share of the step
    plus all-reduce (nothing overlapped), and the images per second."""
    rows = []
    for n in cards:
        ar = ring_allreduce_ms(nbytes, n, link_gbps)
        rows.append({"cards": n, "allreduce_ms": ar,
                     "dp_efficiency_no_overlap": step_ms / (step_ms + ar),
                     "img_s_projected": n * images_per_step
                     / (step_ms + ar) * 1e3})
    return rows


def analytic(spec, state) -> dict:
    """Sizes from the state: parameters by module, the bytes of the
    gradients the fused step all-reduces, the synced BatchNorm channels."""
    modules = {"detector": spec.detector, "physique": spec.physique,
               "discriminator": spec.discriminator}
    counts = {k: sum(p.numel() for p in m.parameters())
              for k, m in modules.items() if m is not None}
    grad_bytes = (sum(p.numel() * p.element_size() for p in state.gen_params)
                  + 2 * sum(p.numel() * p.element_size()
                            for p in state.disc_params))
    bn_channels = sum(b.num_features for m in (spec.detector, spec.physique)
                      if m is not None for b in m.modules()
                      if isinstance(b, nn.BatchNorm2d))
    return {"param_counts": counts, "param_total": sum(counts.values()),
            "grad_allreduce_bytes": grad_bytes, "bn_channels": bn_channels}


@contextlib.contextmanager
def _gradient_tally(out: dict):
    """Adds to out["calls"] and out["bytes"] the data all-reduces that
    train/state.py's C.psum_flat makes (the gradients')."""
    real = C.psum_flat

    def tallied(*groups):
        before = C.COUNTS.snapshot().get("all_reduce/data", {})
        res = real(*groups)
        after = C.COUNTS.snapshot().get("all_reduce/data", {})
        for k in ("calls", "bytes"):
            out[k] += after.get(k, 0) - before.get(k, 0)
        return res

    with mock.patch.object(C, "psum_flat", tallied):
        yield


def _no_group():
    """The step as one process runs it: no process group seen."""
    return mock.patch.object(dist, "is_initialized", lambda: False)


def _build(cfg: dict, dtype, device, seed: int):
    from .. import weights
    from ..train.factory import build_gan_spec
    from ..train.state import TrainState

    spec = build_gan_spec(cfg, dtype)
    for i, module in enumerate((spec.detector, spec.physique,
                                spec.discriminator)):
        weights.init_weights(module, seed + i)
        module.to(device)
    return spec, TrainState(spec, cfg["train_params"], steps_per_epoch=10)


def _run(state, batch, device, seed: int) -> dict:
    """A warm-up step, a timed step (its launches, collectives and
    gradient all-reduce), then a step under FlopCounterMode."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..train.state import train_step
    from ..train.trainer import step_generator

    def step(i):
        return train_step(state, batch, step_generator(seed, i, device))

    step(0)
    C.COUNTS.reset()
    grads = {"calls": 0, "bytes": 0}
    before = measure.launches()
    with _gradient_tally(grads):
        step_ms, loss = measure.time_ms(lambda: step(1)["loss_total"],
                                        device, iters=1, warmup=0)
    out = {"step_ms": step_ms, "loss_total": loss,
           "launches_per_step": measure.launches_since(before),
           "collectives_per_step": C.COUNTS.snapshot(),
           "grad_allreduce_per_step": grads}
    with FlopCounterMode(display=False) as counter:
        step(2)
    out["counted_flops_per_step"] = counter.get_total_flops()
    return out


def measure_scaling(cfg: dict, per_device_batch: int, device,
                    dtype=torch.bfloat16, seed: int = 0) -> dict:
    """Sections 1-3 of the module docstring on this rank (and, with no
    process group, twice on one process)."""
    from ..data.synthetic import SyntheticPoseDataset
    from ..train.trainer import to_device

    world, rank = mesh.process_count(), mesh.data_index()
    cams = cfg["dataset_params"]["cam_id_list"]
    spec, state = _build(cfg, dtype, device, seed)
    ds = SyntheticPoseDataset(
        num_samples=per_device_batch * world, cam_id_list=cams,
        patch_size=cfg["train_params"]["patch_width"], seed=seed)
    batch = to_device(ds.batch(rank * per_device_batch, per_device_batch),
                      device)
    grouped = _run(state, batch, device, seed)
    with _no_group():
        alone = _run(state, batch, device, seed)
    flops = (grouped["counted_flops_per_step"],
             alone["counted_flops_per_step"])
    return {
        "world": world, "rank": mesh.process_index(),
        "backend": dist.get_backend() if mesh.is_distributed() else None,
        "per_device_batch": per_device_batch, "cameras": len(cams),
        "dtype": str(dtype).replace("torch.", ""),
        "analytic": analytic(spec, state),
        "measured": grouped,
        "one_process": alone,
        "weak_scaling": {
            "launches_equal": (grouped["launches_per_step"]
                               == alone["launches_per_step"]),
            "counted_flops_ratio": flops[0] / flops[1] if flops[1] else None,
        },
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m x_as_supervision_tpu_torch.tools.scaling_projection")
    p.add_argument("--tiny", action="store_true",
                   help="the flagship config's tiny shape (tests)")
    p.add_argument("--per-device-batch", type=int, default=4,
                   help="samples of every camera on each rank")
    p.add_argument("--fp32", action="store_true",
                   help="compute in fp32 (default bf16)")
    p.add_argument("--link-gbps", type=float, default=None,
                   help="all-reduce bandwidth per card, GB/s; without it "
                        "nothing is projected")
    p.add_argument("--out", default=None,
                   help="write the report here (default: stdout)")
    measure.add_device_arg(p)
    args = p.parse_args(argv)

    from ..train.factory import flagship_config

    mesh.initialize_multihost(backend=mesh.default_backend(args.device))
    if args.link_gbps is not None and not mesh.is_distributed():
        raise ValueError("--link-gbps projects the measured collectives: "
                         "launch the tool in a process group (torchrun)")
    try:
        device = measure.resolve_device(mesh.rank_device(args.device))
        cfg = flagship_config(tiny=args.tiny)
        report = measure_scaling(
            cfg, args.per_device_batch, device,
            torch.float32 if args.fp32 else torch.bfloat16)
        report.update(config="flagship", tiny=args.tiny,
                      device=measure.device_label(device))
        ar = report["measured"]["collectives_per_step"].get(
            "all_reduce/data", {})
        report["link_gbps"] = args.link_gbps
        if args.link_gbps is not None:
            report["projection"] = projection(
                ar.get("bytes", 0), report["one_process"]["step_ms"],
                args.per_device_batch * report["cameras"], args.link_gbps)
    finally:
        mesh.shutdown()
    if report["rank"] == 0:
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
        else:
            print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
