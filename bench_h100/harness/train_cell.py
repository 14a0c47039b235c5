"""A training cell: the program's fused GAN step (``train/state.py:
train_step``) in a closed loop over a pool of device batches.

Set-up builds one train state from the seed's weights and drives it
through three steps on three different batches of the pool, through the
window's own call; they warm up every shape and give the readings that
``correct`` compares (harness/checks.py). The same state then runs the
window. After the window the program's state is freed and the reference
(reference/gan.py, float32, TF32 off) takes the same three steps from the
same weights, batches and dropout draws.
"""

from __future__ import annotations

import gc
import time

import torch

from reference import gan as R

from . import checks
from . import traffic as T
from . import weights
from . import work as W
from .bench import SHORT
from .trace import WINDOW, profile, summarize

CHECKED_STEPS = 3
# steps an epoch for the learning-rate schedule: its first milestone (epoch
# 40 in both configurations) lies far beyond any run
STEPS_PER_EPOCH = 10_000
MODULES = ("detector", "physique", "discriminator")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def step_generator(seed: int, device, i: int) -> torch.Generator:
    """The dropout draws of step i, the same for program and reference."""
    return weights.generator(seed, device, 100 + i)


def _norms(tensors) -> list[float]:
    if not tensors:
        return []
    return torch.stack([t.detach().float().norm() for t in tensors]).tolist()


def _first_grads(state) -> dict:
    """Each leaf's first gradient as its Adam took it: exp_avg after one
    step is (1 - beta1) g, beta1 = 0.5."""
    out = {}
    for opt, names, params in ((state.opt_det, state.gen_names,
                                state.gen_params),
                               (state.opt_disc, state.disc_names,
                                state.disc_params)):
        pre = "" if opt is state.opt_det else "discriminator."
        m = [opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p)) * 2.0
             for p in params]
        out.update(zip([pre + n for n in names], _norms(m)))
    return out


def port_config(config: dict) -> dict:
    return {k: config[k] for k in ("dataset_params", "model_params",
                                   "train_params")}


def program(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, step_fn=None) -> dict:
    """Set-up, the checked steps, the window and (with `trace`) a traced
    stretch of the program; `step_fn` stands in for train_step (a fault)."""
    from x_as_supervision_tpu_torch.train import state as S
    from x_as_supervision_tpu_torch.train.factory import build_gan_spec

    config, tr = cell.config, cell.traffic
    step_fn = step_fn or S.train_step
    parts = {"imports": time.perf_counter() - t_start}
    gan = weights.reference_gan(config, seed, device)
    with torch.device(device):
        spec = build_gan_spec(port_config(config), cell.dtype)
    for name in MODULES:
        module = getattr(spec, name).to(device)
        module.load_state_dict(getattr(gan, name).state_dict())
    del gan, module
    state = S.TrainState(spec, config["train_params"], STEPS_PER_EPOCH)
    sync(device)
    parts["weights"] = time.perf_counter() - t_start
    pool = T.train_pool(config, tr, seed, device)
    sync(device)
    parts["pool"] = time.perf_counter() - t_start
    names = state.gen_names + ["discriminator." + n for n in state.disc_names]
    params = state.gen_params + state.disc_params
    start = [p.detach().clone() for p in params]

    def step(i):
        return step_fn(state, pool[i % len(pool)],
                       step_generator(seed, device, i))

    losses, grad = [], None
    for i in range(CHECKED_STEPS):
        m = step(i)
        losses.append((float(m["loss_total"]), float(m["loss_disc"])))
        if i == 0:
            grad = _first_grads(state)
    delta = dict(zip(names, _norms([p - s for p, s in zip(params, start)])))
    del start
    sync(device)
    setup_s = parts["checked_steps"] = time.perf_counter() - t_start

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    i = CHECKED_STEPS
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        step(i)
        i += 1
    sync(device)
    window_s = time.perf_counter() - t0
    steps = i - CHECKED_STEPS
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    summary = None
    if trace:
        n = int(tr["traced_steps"])
        with profile() as prof:
            with torch.profiler.record_function(WINDOW):
                for _ in range(n):
                    step(i)
                    i += 1
                sync(device)
        summary = summarize(prof, n)
    images = len(config["model_params"]["cam_id_list"]) * int(
        tr["batch_per_camera"])
    del state, spec, params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"readings": {"losses": losses, "grad": grad, "delta": delta},
            "pool": pool, "setup_s": setup_s, "window_s": window_s,
            "attempted": steps, "images": steps * images,
            "peak_bytes": peak, "trace": summary, "setup_parts": parts}


def reference(cell, seed: int, pool: list, device, operands: str = "fp32",
              half_batch: bool = False) -> dict:
    """The reference's readings over the checked steps. `operands` "fp8"
    is the control; `half_batch` keeps each camera's first half of the
    rows (a fault planted in the reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gan = weights.reference_gan(cell.config, seed, device)
    gan.set_checkpoint_regions(True)
    R.set_numerics(gan, R.Numerics(operands))
    trainer = R.GanTrainer(gan, cell.config)
    start = {n: p.detach().clone() for n, p in trainer.named_params().items()}
    losses = []
    for i in range(CHECKED_STEPS):
        batch = pool[i % len(pool)]
        if half_batch:
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        out = trainer.step(batch, step_generator(seed, device, i))
        losses.append((out["loss_total"], out["loss_disc"]))
    named = trainer.named_params()
    grad = dict(zip(trainer.first_grads,
                    _norms(list(trainer.first_grads.values()))))
    delta = dict(zip(named, _norms([named[n] - start[n] for n in named])))
    del trainer, gan, start, named
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad": grad, "delta": delta}


def work(cell, peaks: dict) -> dict:
    return W.train_step_work(cell.config, int(cell.traffic["batch_per_camera"]),
                             SHORT[cell.dtype], peaks)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, step_fn=None) -> dict:
    """The program's run, then the reference's three steps and the
    numbers that decide ``correct``."""
    out = program(cell, seed, seconds, trace, device, t_start, step_fn)
    pool = out.pop("pool")
    t = time.perf_counter()
    ref = reference(cell, seed, pool, device)
    out["values"], out["where"] = checks.train_numbers(out["readings"], ref)
    out["where"]["setup_parts_s"] = out.pop("setup_parts")
    out["where"]["reference_s"] = time.perf_counter() - t
    out["failed"] = 0
    return out
