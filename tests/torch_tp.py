"""Rank jobs of the port's tensor-parallel CPU tests
(tests/test_torch_tp_ranks.py), run through tests/torch_dp.py's ``spawn``
(whose ``main`` finds them in ``JOBS`` here): gloo ranks on the CPU laid
out as parallel/mesh.py's (data, model) grid. Like torch_dp.py's jobs they
import torch, numpy and the port only, hold what they compute to the
port's own one-process answer in-process (that process's collectives see
no process group), and send back errors, verdicts and digests, not
states.
"""

from __future__ import annotations

import contextlib
import copy
import os
from unittest import mock

from torch_dp import _digests, _modules, _pending, _rows, _verdict


def _plain():
    """The one-process reference inside a rank: no process group seen."""
    import torch.distributed as dist

    return mock.patch.object(dist, "is_initialized", lambda: False)


def _err(got, want) -> float:
    """max |got - want| over max |want| (the absolute difference where
    want is all zero)."""
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale > 0 else diff


def _module_cases(rank: int, world: int) -> dict:
    """Each module kind that tensor parallelism splits, on 2 model ranks
    (data 1), against the same module whole in one process: output, input
    gradient, each parameter's gradient and each running statistic
    (gathered), each relative to its largest entry."""
    import torch

    from x_as_supervision_tpu_torch.models import discriminator as D
    from x_as_supervision_tpu_torch.models.physique import (
        PhysiqueMaskGenerator)
    from x_as_supervision_tpu_torch.models.resnet import (
        Bottleneck, set_bn_groups)
    from x_as_supervision_tpu_torch.parallel import collectives as C
    from x_as_supervision_tpu_torch.parallel import tp

    parents = [0, 0, 1, 2, 0, 4, 5, 0, 17, 8, 9, 17, 11, 12, 17, 14, 15, 7]
    par, child = parents[1:], list(range(1, 18))

    def bottleneck(groups):
        m = Bottleneck(1024, 256)
        with torch.no_grad():
            for bn in (m.bn1, m.bn2, m.bn3):
                bn.weight.uniform_(0.5, 1.5)
                bn.bias.uniform_(-0.5, 0.5)
        set_bn_groups(m, groups)
        return m, (2 * groups, 1024, 4, 4)

    def build(kind):
        torch.manual_seed(0)
        if kind.startswith("bottleneck"):
            return bottleneck(2 if kind.endswith("g2") else 1)
        if kind == "physique":
            m = PhysiqueMaskGenerator([32, 64])
            with torch.no_grad():
                for bn in m.bns:
                    bn.weight.uniform_(0.5, 1.5)
            return m, (2, 1, 16, 16)
        if kind == "sage_disc":
            m = D.GCNDiscriminatorDecouple(par, child, 64, 64, 64,
                                           use_pe=True)
            return m, (6, 18, 3)
        m = D.GCNDiscriminator(par, child, "res_gcn", 64, 64, 64,
                               use_bn=True)
        return m, (6, 18, 3)

    def run(m, x, wgt, kind):
        x = x.clone().requires_grad_()
        if "disc" in kind:
            y = m(x, torch.Generator().manual_seed(7))
        else:
            y = m(x)
        params = [p for _, p in m.named_parameters()]
        grads = torch.autograd.grad((y * wgt).sum(), [x] + params)
        return y.detach(), grads[0], dict(zip(
            [n for n, _ in m.named_parameters()], grads[1:]))

    kinds = ("bottleneck_link", "bottleneck_link_g2",
             "bottleneck_gathered_weight", "physique", "sage_disc",
             "res_gcn_disc")
    out = {}
    for kind in kinds:
        m, shape = build(kind)
        m.train()
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(shape, generator=gen) * 2.0 + 0.5
        if kind == "physique":
            x = torch.rand(shape, generator=gen)
        # a fixed weighting of the output: (B, 1) scores, one mask a
        # sample, or the Bottleneck's x-shaped output
        out_shape = {"physique": (shape[0], 1, *shape[2:])}.get(
            kind, (shape[0], 1) if "disc" in kind else shape)
        wgt = torch.randn(out_shape, generator=gen)
        ref = copy.deepcopy(m)
        with _plain():
            y_ref, gx_ref, gp_ref = run(ref, x, wgt, kind)
        cancelled = set(getattr(m, "bn_cancelled_biases", lambda: [])())
        dims = tp.shard_module(m)
        C.COUNTS.reset()
        route = (mock.patch.object(tp, "link_route",
                                   lambda c: "gathered_weight")
                 if kind == "bottleneck_gathered_weight"
                 else contextlib.nullcontext())
        with route:
            y, gx, gp = run(m, x, wgt, kind)
        errs = {"y": _err(y, y_ref), "x_grad": _err(gx, gx_ref)}
        for n, g in gp.items():
            if n in cancelled:
                continue
            whole = (C.gather_channels(g, dims[n]) if n in dims else g)
            errs["grad " + n] = _err(whole, gp_ref[n])
        ref_bufs = dict(ref.named_buffers())
        for n, v in m.named_buffers():
            if v.is_floating_point() and n in ref_bufs:
                whole = C.gather_channels(v, dims[n]) if n in dims else v
                errs[n] = _err(whole, ref_bufs[n])
        out[kind] = dict(errs=errs, split=sorted(dims),
                         collectives=C.COUNTS.snapshot())
    return out


def job_tp_modules(rank: int, world: int, workdir: str) -> dict:
    """The model-group collectives and their backward, then the module
    cases (_module_cases), on world = 2 model ranks (data 1)."""
    import torch

    from x_as_supervision_tpu_torch.parallel import collectives as C
    from x_as_supervision_tpu_torch.parallel import mesh

    mesh.make_grid(world)
    res: dict = dict(model=(mesh.model_size(), mesh.model_index()),
                     data=(mesh.data_size(), mesh.data_index()))
    # gather: rank r holds channel r of (1, 2); backward: its slice of the
    # upstream gradient
    x = torch.tensor([[rank + 1.0]], requires_grad=True)
    g = C.gather_channels(x, 1)
    (g * torch.tensor([[10.0, 100.0]])).sum().backward()
    res["gather"], res["gather_grad"] = g.detach(), x.grad.clone()
    # copy_to_model: identity; backward the ranks' gradients summed
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    (C.copy_to_model(x) * (rank + 1)).sum().backward()
    res["copy_grad"] = x.grad.clone()
    # model_slice: rank r's half; backward the halves' gradients together
    x = torch.tensor([1.0, 2.0, 3.0, 4.0], requires_grad=True)
    s = C.model_slice(x)
    (s * 10.0 ** rank).sum().backward()
    res["slice"], res["slice_grad"] = s.detach(), x.grad.clone()
    res["psum_model"] = C.psum_model(torch.tensor([rank + 1.0]))
    b = torch.tensor([float(rank)])
    res["broadcast"] = C.broadcast_model_(b).clone()
    res["modules"] = _module_cases(rank, world)
    return res


def job_tp_steps(rank: int, world: int, workdir: str) -> dict:
    """The tensor-parallel step on a (world / 2, 2) grid against the
    one-process step, for each config of the plan and step: before each
    step rank 0 loads the split state, gathered, into a whole one and
    takes the one-process step from it (no process group seen), and every
    rank takes the split step with the step's generator on its data
    index's rows; rank 0 holds the gathered state after it to the one
    process's (step_bounds.assert_step_matches). Each rank sends a digest
    of every tensor of its own state, which of them are whole
    (replicated), and how far its replicated gradients and statistics were
    from model rank 0's before the step's broadcast (tp.replica_drift).
    Only rank 0 computes the one-process step."""
    import json

    import numpy as np
    import torch

    from step_bounds import assert_step_matches
    from x_as_supervision_tpu_torch import weights
    from x_as_supervision_tpu_torch.checks import flat
    from x_as_supervision_tpu_torch.parallel import mesh, tp
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt
    from x_as_supervision_tpu_torch.train.factory import build_gan_spec
    from x_as_supervision_tpu_torch.train.state import TrainState, train_step
    from x_as_supervision_tpu_torch.train.trainer import (
        step_generator, to_device)

    with open(os.path.join(workdir, "plan.json")) as f:
        plan = json.load(f)
    out: dict = {}
    try:
        mesh.make_grid(3)
        out["uneven_grid_raises"] = False
    except ValueError:
        out["uneven_grid_raises"] = True
    mesh.make_grid(2)
    out["grid"] = dict(data=(mesh.data_size(), mesh.data_index()),
                       model=(mesh.model_size(), mesh.model_index()))

    def gan(cfg):
        spec = build_gan_spec(cfg, torch.float32)
        return spec, TrainState(spec, cfg["train_params"],
                                plan["steps_per_epoch"])

    for name, cfg in plan["configs"].items():
        tp_spec, split = gan(cfg)
        for i, module in enumerate((tp_spec.detector, tp_spec.physique,
                                    tp_spec.discriminator)):
            weights.init_weights(module, plan["seed"] + i)
        with torch.no_grad():
            # each residual branch's last BatchNorm scale 0.1 (the tests'
            # conditioning; tests/torch_dp.py:job_port_steps)
            for block in tp_spec.detector.net.backbone.modules():
                if hasattr(block, "bn2") and not hasattr(block, "bn3"):
                    block.bn2.weight.fill_(0.1)
        tp.shard_state(split)
        ref_spec, ref = gan(cfg) if rank == 0 else (None, None)
        steps = []
        whole = tp.gather_state(split, ckpt.state_dict(split))
        for i in range(plan["steps"]):
            batch = dict(np.load(os.path.join(workdir, f"batch_{i}.npz")))
            if rank == 0:
                # a copy: Adam's load_state_dict keeps the tensors it is
                # given
                ckpt.load_state(ref, copy.deepcopy(whole))
                before = _modules(ref_spec)
                with _plain():
                    want = train_step(ref, to_device(batch, "cpu"),
                                      step_generator(plan["seed"], i, "cpu"))
            tp.replica_drift()
            got = train_step(split, to_device(
                _rows(batch, mesh.data_index(), mesh.data_size()), "cpu"),
                step_generator(plan["seed"], i, "cpu"))
            drift = tp.replica_drift()
            local = flat(ckpt.state_dict(split))
            whole = tp.gather_state(split, ckpt.state_dict(split))
            whole_flat = flat(whole)
            step = dict(
                metrics={k: float(v) for k, v in got.items()},
                replica_drift=drift, digests=_digests(tp_spec, split),
                whole_keys=sorted(
                    k for k, v in local.items() if hasattr(v, "shape")
                    and tuple(v.shape) == tuple(whole_flat[k].shape)),
                split_keys=sorted(
                    k for k, v in local.items() if hasattr(v, "shape")
                    and tuple(v.shape) != tuple(whole_flat[k].shape)))
            if rank == 0:
                gathered = {f"{module}.{k}": v.detach().clone()
                            for module in tp.MODULES
                            for k, v in whole[module].items()
                            if "num_batches" not in k}
                step.update(
                    want_metrics={k: float(v) for k, v in want.items()},
                    pending=dict(zip(split.disc_names,
                                     whole["pending_disc_grads"])),
                    want_pending=_pending(ref),
                    state_verdict=_verdict(
                        assert_step_matches,
                        {k: v.numpy() for k, v in _modules(ref_spec).items()},
                        gathered, {k: v.numpy() for k, v in before.items()},
                        ref_spec, plan["lr"]))
            steps.append(step)
        out[name] = steps
    return out


def job_tp_jax_steps(rank: int, world: int, workdir: str) -> dict:
    """tests/torch_dp.py:job_jax_steps on a (world / 2, 2) grid: before
    each of the first ``tp_steps`` steps the JAX state (npz) is carried
    into a whole state and cut to this rank's shards, then the split step
    runs on this data index's rows of the JAX step's global batch; rank 0
    holds the gathered parameters and statistics after it to JAX's
    (step_bounds.assert_step_matches) and sends the gathered carried
    gradient. Every rank sends its metrics and tp.replica_drift."""
    import numpy as np
    import torch

    from step_bounds import assert_step_matches
    from x_as_supervision_tpu_torch.checks import load_train_state
    from x_as_supervision_tpu_torch.parallel import mesh, tp
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt
    from x_as_supervision_tpu_torch.train.factory import (
        build_gan_spec, flagship_config)
    from x_as_supervision_tpu_torch.train.state import TrainState, train_step
    from x_as_supervision_tpu_torch.train.trainer import to_device

    meta = dict(np.load(os.path.join(workdir, "meta.npz")))
    cfg = flagship_config(tiny=True)
    mesh.make_grid(2)
    steps = []
    for i in range(int(meta["tp_steps"])):
        spec = build_gan_spec(cfg, torch.float32)
        spec.discriminator.header.p_dropout = 0.0
        state = TrainState(spec, cfg["train_params"],
                           int(meta["steps_per_epoch"]))
        before = dict(np.load(os.path.join(workdir, f"before_{i}.npz")))
        load_train_state(spec, state, before)
        tp.shard_state(state)
        batch = dict(np.load(os.path.join(workdir, f"batch_{i}.npz")))
        tp.replica_drift()
        metrics = train_step(state, to_device(
            _rows(batch, mesh.data_index(), mesh.data_size()), "cpu"))
        step = dict(metrics={k: float(v) for k, v in metrics.items()},
                    replica_drift=tp.replica_drift(),
                    split=len(state.shard_dims))
        whole = tp.gather_state(state, ckpt.state_dict(state))
        if rank == 0:
            want = dict(np.load(os.path.join(workdir, f"after_{i}.npz")))
            gathered = {f"{m}.{k}": v for m in tp.MODULES
                        for k, v in whole[m].items()
                        if "num_batches" not in k}
            step["pending"] = dict(zip(state.disc_names,
                                       whole["pending_disc_grads"]))
            step["state_verdict"] = _verdict(
                assert_step_matches, want, gathered,
                {k[len("var/"):]: v for k, v in before.items()
                 if k.startswith("var/")},
                spec, float(meta["lr"]))
        steps.append(step)
    return {"steps": steps}


def job_tp_checkpoint(rank: int, world: int, workdir: str) -> dict:
    """(data 1, model 2): the train CLI with model_parallelism 2 from the
    config (the --coordinator flags), then a Trainer's two epochs with a
    checkpoint after each (the whole state, gathered: the digests of the
    last one's state are sent for the one-process load), and a run
    resumed from the first checkpoint against the straight one."""
    import torch

    from x_as_supervision_tpu_torch.checks import flat
    from x_as_supervision_tpu_torch.data.synthetic import (
        SyntheticPoseDataset)
    from x_as_supervision_tpu_torch.parallel import mesh, tp
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt
    from x_as_supervision_tpu_torch.train import trainer as T
    from x_as_supervision_tpu_torch.train.__main__ import main as train_main
    from x_as_supervision_tpu_torch.train.factory import flagship_config

    import hashlib

    def digests(state) -> dict:
        whole = tp.gather_state(state, ckpt.state_dict(state))
        return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy()
                                  .tobytes()).hexdigest()
                for k, v in flat(whole).items() if hasattr(v, "numpy")}

    res: dict = {}
    trainer = train_main([
        "--config", os.path.join(workdir, "cfg.json"), "--synthetic",
        "--seed", "0", "--steps", "1", "--batch_size", "4", "--device",
        "cpu", "--fp32", "--worker", "1", "--log_dir",
        os.path.join(workdir, "cli"), "--coordinator", "unused:0",
        "--num_processes", str(world), "--process_id", str(rank)])
    res["cli_history"] = trainer.history
    res["cli_grid"] = (mesh.data_size(), mesh.model_size())
    res["cli_shard"] = (trainer.loader.num_shards, trainer.loader.shard_index,
                        trainer.loader.local_batch)
    res["cli_split"] = len(trainer.state.shard_dims)

    def trainer_for(epochs, save_dir, checkpoint_path=None):
        cfg = flagship_config(tiny=True)
        cfg["train_params"].update(batch_size=4, num_epochs=epochs,
                                   checkpoint_freq=1, model_parallelism=2)
        ds = SyntheticPoseDataset(num_samples=4, cam_id_list=(0, 1),
                                  patch_size=64)
        return T.Trainer(cfg, ds, seed=3, dtype=torch.float32, device="cpu",
                         save_dir=save_dir, checkpoint_path=checkpoint_path,
                         num_workers=1)

    # two epochs of one step, a checkpoint after each; a second run resumed
    # from the first checkpoint takes the second step
    save_dir = os.path.join(workdir, "straight")
    straight = trainer_for(2, save_dir)
    straight.train()
    res["straight"] = digests(straight.state)
    res["saved_path"] = os.path.join(save_dir, "00001_ckpt")
    resumed = trainer_for(2, os.path.join(workdir, "resumed"),
                          os.path.join(save_dir, "00000_ckpt"))
    res["resumed_from"] = resumed.epochs_run
    resumed.train()
    res["resumed"] = digests(resumed.state)
    return res


def job_tp_two_ranks(rank: int, world: int, workdir: str) -> dict:
    """The jobs of two model ranks (data 1) in one spawn: job_tp_modules,
    then job_tp_checkpoint (its config in `workdir`)."""
    return {**job_tp_modules(rank, world, workdir),
            **job_tp_checkpoint(rank, world, workdir)}


JOBS = {"tp_two_ranks": job_tp_two_ranks, "tp_steps": job_tp_steps,
        "tp_jax_steps": job_tp_jax_steps}
