"""Ranks of the port's data-parallel CPU tests (tests/test_torch_parallel*.py;
the tensor-parallel ones' jobs are in tests/torch_tp.py).

``spawn(job, world, workdir)`` starts `world` processes of this file,
each ``python tests/torch_dp.py <job> <rank> <world> <port> <workdir>
<threads>``, joined in a gloo process group through ``--coordinator``-style
arguments (parallel/mesh.py:initialize_multihost), and waits for them with
a timeout; world 0 starts one process without a process group (the
one-process reference under the same thread settings). Each rank runs
``JOBS[job]`` and writes what it found to ``<workdir>/<job>_<rank>.pt``.

The ranks import torch, numpy and the port only (no JAX): what the JAX
package computed reaches them as npz files that the test wrote. They hold
whole train states to their references in-process (tests/step_bounds.py)
and send back the verdicts, the metrics, the carried discriminator
gradient and a digest of every tensor of their state (for the ranks'
bitwise comparison), not the states: a tiny flagship state with its Adam
moments is about 190 MB.
"""

from __future__ import annotations

import hashlib
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# intra-op threads of every rank and of the one-process reference by
# default: the tests run beside other workers on a few cores
THREADS = 2
# seconds a rendezvous or a collective of a rank may wait
RANK_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(job: str, world: int, workdir: str,
          timeout: float = 300, threads: int = THREADS) -> list[dict]:
    """Run `job` on `world` ranks (0: one process, no group), each with
    `threads` intra-op threads; returns each rank's result dict. A rank
    that fails or outlives `timeout` fails the caller (every rank is
    killed)."""
    import torch

    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=str(threads))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         str(port), workdir, str(threads)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(max(world, 1))]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{job} rank {r} exited {p.returncode}:\n"
                                 f"{out[-6000:]}")
    return [torch.load(os.path.join(workdir, f"{job}_{r}.pt"),
                       weights_only=False) for r in range(max(world, 1))]


# ---------------------------------------------------------------- jobs


def _modules(spec) -> dict:
    """Parameters and BatchNorm statistics of the GAN's modules, by name."""
    out = {}
    for name in ("detector", "physique", "discriminator"):
        out.update({f"{name}.{k}": v.detach().clone()
                    for k, v in getattr(spec, name).state_dict().items()
                    if "num_batches" not in k})
    return out


def _pending(state) -> dict:
    return {n: g.detach().clone()
            for n, g in zip(state.disc_names, state.pending_disc_grads)}


def _digests(spec, state) -> dict:
    """A sha256 of every tensor of the train state (the checkpoint's: the
    modules, both Adam states, the carried gradient), by path."""
    from x_as_supervision_tpu_torch.checks import flat
    from x_as_supervision_tpu_torch.train import checkpoint as ckpt

    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy()
                              .tobytes()).hexdigest()
            for k, v in flat(ckpt.state_dict(state)).items()
            if hasattr(v, "numpy")}


def _verdict(fn, *args) -> str | None:
    """None if fn(*args) passes, else its assertion's message."""
    try:
        fn(*args)
    except AssertionError as e:
        return f"{type(e).__name__}: {e}"[:2000] or "AssertionError"
    return None


def _rows(batch: dict, rank: int, world: int) -> dict:
    """This rank's rows of every array of a numpy batch (the loader's
    shard); the whole batch for world 0."""
    if world == 0:
        return batch
    out = {}
    for k, v in batch.items():
        b = len(v) // world
        out[k] = v[rank * b:(rank + 1) * b]
    return out


def _camera_rows(cams: int, b: int, rank: int, world: int):
    """Rank `rank`'s rows of a camera-major batch of `cams` cameras x
    world b samples."""
    import torch

    return torch.cat([torch.arange((c * world + rank) * b,
                                   (c * world + rank + 1) * b)
                      for c in range(cams)])


def module_cases(rank: int, world: int) -> dict:
    """Each module whose train-mode statistics are synced, on this rank's
    rows of a camera-major batch (2 cameras x 4, 2 a rank) against the
    same module on the whole batch in this process with no process group
    seen: the fused Bottleneck (the link kernel's module: bn1's two-pass
    statistics, the link's stats all-reduced) pooled and per camera,
    BatchNorm2d per camera, StatelessBN. The loss is a fixed weighting of
    the output (a sum, so each rank's part is its share); returns, per
    case and tensor, max |DP - one process| over max |one process|."""
    import copy
    from unittest import mock

    import torch
    import torch.distributed as dist

    from x_as_supervision_tpu_torch.models.discriminator import StatelessBN
    from x_as_supervision_tpu_torch.models.resnet import (
        BatchNorm2d, Bottleneck, set_bn_groups)
    from x_as_supervision_tpu_torch.parallel import collectives as C

    cams, b = 2, 2
    rows = _camera_rows(cams, b, rank, world)

    def build(kind):
        torch.manual_seed(0)
        if kind.startswith("bottleneck"):
            m = Bottleneck(1024, 256)
            with torch.no_grad():
                for bn in (m.bn1, m.bn2, m.bn3):
                    bn.weight.uniform_(0.5, 1.5)
                    bn.bias.uniform_(-0.5, 0.5)
            set_bn_groups(m, 2 if kind.endswith("g2") else 1)
            shape = (cams * b * world, 1024, 4, 4)
        elif kind == "bn_g2":
            m = BatchNorm2d(16)
            set_bn_groups(m, 2)
            shape = (cams * b * world, 16, 6, 6)
        else:
            m = StatelessBN(8)
            shape = (cams * b * world, 18, 8)
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(shape, generator=gen) * 2.0 + 0.5
        return m.train(), x, gen

    def run(m, x, wgt):
        x = x.clone().requires_grad_()
        params = list(m.parameters())
        y = m(x)
        grads = torch.autograd.grad((y * wgt).sum(), [x] + params)
        return y.detach(), grads[0], list(grads[1:])

    out = {}
    for kind in ("bottleneck_g1", "bottleneck_g2", "bn_g2", "stateless_bn"):
        m, x, gen = build(kind)
        wgt = torch.randn(x.shape, generator=gen)  # y has x's shape
        ref_m = copy.deepcopy(m)
        with mock.patch.object(dist, "is_initialized", lambda: False):
            y, gx, gp = run(ref_m, x, wgt)
        y_dp, gx_dp, gp_dp = run(m, x[rows], wgt[rows])
        (gp_dp,) = C.psum_flat(gp_dp)

        def err(got, want):
            return float((got - want).abs().max() / want.abs().max())

        errs = {"y": err(y_dp, y[rows]), "x_grad": err(gx_dp, gx[rows])}
        for (n, _), g, w in zip(m.named_parameters(), gp_dp, gp):
            if w.abs().max() > 0:
                errs["grad " + n] = err(g, w)
        for (n, v), (_, w) in zip(m.named_buffers(), ref_m.named_buffers()):
            if v.is_floating_point():
                errs[n] = err(v, w)
        out[kind] = errs
    return out


def job_basics(rank: int, world: int, workdir: str) -> dict:
    """The mesh helpers, the collectives and their backward, the seed and
    run-directory broadcasts, the train CLI's flags, and the checkpoint
    save, barrier and resume of a two-rank Trainer."""
    import torch

    from x_as_supervision_tpu_torch.parallel import collectives as C
    from x_as_supervision_tpu_torch.parallel import mesh

    res: dict = dict(count=mesh.process_count(), index=mesh.process_index(),
                     slice=mesh.process_local_batch_slice(8))
    res["modules"] = module_cases(rank, world)
    try:
        mesh.process_local_batch_slice(7)
        res["uneven_raises"] = False
    except ValueError:
        res["uneven_raises"] = True

    C.COUNTS.reset()
    # psum: forward the sum; backward the upstream gradients summed
    w = torch.tensor([1.0, 2.0], dtype=torch.float64, requires_grad=True)
    y = C.psum_data(w * (rank + 1))
    (y * (10.0 ** rank)).sum().backward()
    res["psum"], res["psum_grad"] = y.detach(), w.grad.clone()
    res["pmean"] = C.pmean_data(torch.tensor([float(rank)]))
    # ring: rank r receives rank r - 1's; backward goes the other way
    x = torch.tensor([rank + 1.0, 10.0 * (rank + 1)], requires_grad=True)
    y = C.ppermute_ring(x, 1)
    (y * (rank + 1)).sum().backward()
    res["ring"], res["ring_grad"] = y.detach(), x.grad.clone()
    # all-gather: every rank's rows in rank order; backward reduce-scatter
    x = torch.tensor([[rank + 0.0, rank + 0.5]], requires_grad=True)
    g = C.all_gather_data(x)
    (g * torch.tensor([[1.0], [100.0]]) * (rank + 1)).sum().backward()
    res["gather"], res["gather_grad"] = g.detach(), x.grad.clone()
    res["gather_stacked"] = C.all_gather_data(torch.tensor([rank + 0.0]),
                                              tiled=False)
    tree = {"a": float(rank), "b": [1.0, 2.0 * rank], "c": (3, 4.5)}
    res["mean"] = C.cross_host_mean(tree)
    res["sum"] = C.cross_host_sum(tree)
    res["flat"] = C.psum_flat([torch.ones(2) * rank, torch.ones(3)],
                              [torch.full((2, 2), 2.0)])
    res["counts"] = C.COUNTS.snapshot()

    # broadcasts: rank 1's clock is elsewhere, rank 0's answer wins
    from x_as_supervision_tpu_torch.train import trainer as T

    if rank == 1:
        real_time, real_strftime = time.time, time.strftime
        time.time = lambda: real_time() + 12345.0
        time.strftime = lambda fmt, *a: "01_01_99_00.00.00"
    try:
        res["seed"] = T.draw_seed(-1)
        cfg_path = os.path.join(workdir, "cfg.json")
        res["run_dir"] = T.create_run_dir(os.path.join(workdir, "runs"),
                                          cfg_path, -1)
    finally:
        if rank == 1:
            time.time, time.strftime = real_time, real_strftime
    mesh.barrier()
    res["run_dirs_made"] = sorted(os.listdir(os.path.join(workdir, "runs")))

    # the train CLI with the --coordinator flags (the group is up already)
    from x_as_supervision_tpu_torch.train.__main__ import main as train_main

    tlog = os.path.join(workdir, "cli")
    trainer = train_main([
        "--config", cfg_path, "--synthetic", "--seed", "0", "--steps", "2",
        "--batch_size", "4", "--device", "cpu", "--fp32", "--worker", "1",
        "--log_dir", tlog, "--coordinator", "unused:0", "--num_processes",
        str(world), "--process_id", str(rank)])
    res["cli_history"] = trainer.history
    res["cli_shard"] = (trainer.loader.num_shards, trainer.loader.shard_index,
                        trainer.loader.local_batch)
    (run,) = os.listdir(tlog)
    mesh.barrier()
    res["cli_run_files"] = sorted(os.listdir(os.path.join(tlog, run)))

    # checkpoint: rank 0 saves, the barrier, every rank resumes from it;
    # a run resumed after epoch 0 equals a straight one bitwise
    from x_as_supervision_tpu_torch.data.synthetic import (
        SyntheticPoseDataset)
    from x_as_supervision_tpu_torch.train.factory import flagship_config

    def trainer_for(epochs, save_dir, checkpoint_path=None):
        cfg = flagship_config(tiny=True)
        cfg["train_params"].update(batch_size=4, num_epochs=epochs,
                                   checkpoint_freq=1)
        ds = SyntheticPoseDataset(num_samples=8, cam_id_list=(0, 1),
                                  patch_size=64)
        return T.Trainer(cfg, ds, seed=3, dtype=torch.float32, device="cpu",
                         save_dir=save_dir, checkpoint_path=checkpoint_path,
                         num_workers=1)

    straight = trainer_for(2, os.path.join(workdir, "straight"))
    straight.train()
    first = trainer_for(1, os.path.join(workdir, "split"))
    first.train()
    path = os.path.join(workdir, "split", "00000_ckpt", "state.pt")
    res["ckpt_after_barrier"] = os.path.exists(path)
    resumed = trainer_for(2, os.path.join(workdir, "split"),
                          os.path.dirname(path))
    res["resumed_from"] = resumed.epochs_run
    resumed.train()
    res["straight"] = _digests(straight.spec, straight.state)
    res["resumed"] = _digests(resumed.spec, resumed.state)
    return res


def job_jax_steps(rank: int, world: int, workdir: str) -> dict:
    """The JAX parity steps: before each step the JAX state (npz) carried
    in, then the port's step on this rank's rows of the JAX step's global
    batch; rank 0 holds the parameters and statistics after it to JAX's
    (step_bounds.assert_step_matches)."""
    import numpy as np
    import torch

    from step_bounds import assert_step_matches
    from x_as_supervision_tpu_torch.checks import load_train_state
    from x_as_supervision_tpu_torch.train.factory import (
        build_gan_spec, flagship_config)
    from x_as_supervision_tpu_torch.train.state import TrainState, train_step
    from x_as_supervision_tpu_torch.train.trainer import to_device

    meta = dict(np.load(os.path.join(workdir, "meta.npz")))
    cfg = flagship_config(tiny=True)
    spec = build_gan_spec(cfg, torch.float32)
    spec.discriminator.header.p_dropout = 0.0
    state = TrainState(spec, cfg["train_params"],
                       int(meta["steps_per_epoch"]))
    steps = []
    for i in range(int(meta["steps"])):
        before = dict(np.load(os.path.join(workdir, f"before_{i}.npz")))
        load_train_state(spec, state, before)
        batch = dict(np.load(os.path.join(workdir, f"batch_{i}.npz")))
        metrics = train_step(state, to_device(_rows(batch, rank, world),
                                              "cpu"))
        step = dict(metrics={k: float(v) for k, v in metrics.items()},
                    pending=_pending(state), digests=_digests(spec, state))
        if rank == 0:
            want = dict(np.load(os.path.join(workdir, f"after_{i}.npz")))
            step["state_verdict"] = _verdict(
                assert_step_matches, want, _modules(spec),
                {k[len("var/"):]: v for k, v in before.items()
                 if k.startswith("var/")},
                spec, float(meta["lr"]))
        steps.append(step)
    return {"steps": steps}


def _copy_state(src_spec, src, dst_spec, dst) -> None:
    """dst := src (the modules, both Adam states, the counts, the carried
    gradient)."""
    import copy

    for name in ("detector", "physique", "discriminator"):
        getattr(dst_spec, name).load_state_dict(
            getattr(src_spec, name).state_dict())
    dst.opt_det.load_state_dict(copy.deepcopy(src.opt_det.state_dict()))
    dst.opt_disc.load_state_dict(copy.deepcopy(src.opt_disc.state_dict()))
    dst.det_updates, dst.disc_updates = src.det_updates, src.disc_updates
    dst.step, dst.epoch = src.step, src.epoch
    dst.pending_disc_grads = [g.clone() for g in src.pending_disc_grads]


def job_port_steps(rank: int, world: int, workdir: str) -> dict:
    """The data-parallel step against the one-process step, for each config
    of the plan and step: the one-process run (this process with no
    process group seen, the whole batch) takes the step, and the
    data-parallel state, set to the one-process state before it, takes it
    on this rank's rows, both with the step's own generator; rank 0 holds
    the two states after it together (step_bounds.assert_step_matches)."""
    import json
    from unittest import mock

    import numpy as np
    import torch
    import torch.distributed as dist

    from step_bounds import assert_step_matches
    from x_as_supervision_tpu_torch import weights
    from x_as_supervision_tpu_torch.train.factory import build_gan_spec
    from x_as_supervision_tpu_torch.train.state import TrainState, train_step
    from x_as_supervision_tpu_torch.train.trainer import (
        step_generator, to_device)

    with open(os.path.join(workdir, "plan.json")) as f:
        plan = json.load(f)
    out = {}
    for name, cfg in plan["configs"].items():
        ref_spec, dp_spec = (build_gan_spec(cfg, torch.float32)
                             for _ in range(2))
        for i, module in enumerate((ref_spec.detector, ref_spec.physique,
                                    ref_spec.discriminator)):
            weights.init_weights(module, plan["seed"] + i)
        with torch.no_grad():
            # each residual branch's last BatchNorm scale 0.1 (the tests'
            # conditioning; chip_smoke.py's phase 7)
            for block in ref_spec.detector.net.backbone.modules():
                if hasattr(block, "bn2") and not hasattr(block, "bn3"):
                    block.bn2.weight.fill_(0.1)
        ref, dp = (TrainState(s, cfg["train_params"],
                              plan["steps_per_epoch"])
                   for s in (ref_spec, dp_spec))
        steps = []
        for i in range(plan["steps"]):
            batch = dict(np.load(os.path.join(workdir, f"batch_{i}.npz")))
            before = _modules(ref_spec)
            _copy_state(ref_spec, ref, dp_spec, dp)
            with mock.patch.object(dist, "is_initialized", lambda: False):
                want = train_step(ref, to_device(batch, "cpu"),
                                  step_generator(plan["seed"], i, "cpu"))
            got = train_step(dp, to_device(_rows(batch, rank, world), "cpu"),
                             step_generator(plan["seed"], i, "cpu"))
            step = dict(
                metrics={k: float(v) for k, v in got.items()},
                want_metrics={k: float(v) for k, v in want.items()},
                pending=_pending(dp), want_pending=_pending(ref),
                digests=_digests(dp_spec, dp))
            if rank == 0:
                step["state_verdict"] = _verdict(
                    assert_step_matches,
                    {k: v.numpy() for k, v in _modules(ref_spec).items()},
                    _modules(dp_spec),
                    {k: v.numpy() for k, v in before.items()},
                    ref_spec, plan["lr"])
            steps.append(step)
        out[name] = steps
    return out


def job_eval(rank: int, world: int, workdir: str) -> dict:
    """The evaluator on the anchored fixture (fp32, the test's detector
    weights) over this process's batches, recorded with reduce_hosts into
    <workdir>/<case>_<world>/eval/, for each case of the plan; then the
    eval CLI (bf16) with the --coordinator flags and --reduce_hosts on a
    checkpoint of the same detector."""
    import json

    import torch

    from x_as_supervision_tpu_torch.checks import (
        AnchoredDataset, AnchoredDetector)
    from x_as_supervision_tpu_torch.data.synthetic import (
        SyntheticPoseDataset)
    from x_as_supervision_tpu_torch.models.detector import build_detector
    from x_as_supervision_tpu_torch.train.evaluator import Evaluator

    plan = json.load(open(os.path.join(workdir, "plan.json")))
    det = build_detector(plan["config"]["model_params"]["detector_params"])
    det.load_state_dict(torch.load(os.path.join(workdir, "detector.pt")))
    side = plan["side"]
    out = {}
    for case, samples in plan["cases"].items():
        cfg = json.loads(json.dumps(plan["config"]))
        cfg["dataset_params"]["dataset"]["name"] = plan["dataset"][case]
        ds = AnchoredDataset(SyntheticPoseDataset(
            num_samples=samples, cam_id_list=(0, 1), patch_size=side),
            (0, 1), float(side))
        ev = Evaluator(cfg, AnchoredDetector(det), ds,
                       os.path.join(workdir, f"{case}_{world}"),
                       img_size=float(side), device="cpu")
        tables = ev.eval(mode="best")
        path = ev.record(*tables, reduce_hosts=True)
        out[case] = dict(path=path, my_batches=ev.my_batches,
                         ratio=ev.last_ambiguity_ratio)

    from x_as_supervision_tpu_torch.eval.__main__ import main as eval_main

    args = ["--config", os.path.join(workdir, "cli.json"), "--synthetic",
            "--checkpoint", os.path.join(workdir, f"ckpt_{world}",
                                         "00000_ckpt"),
            "--device", "cpu", "--batch_size", str(plan["cli_batch"])]
    if world:
        args += ["--reduce_hosts", "--coordinator", "unused:0",
                 "--num_processes", str(world), "--process_id", str(rank)]
    ev = eval_main(args)
    out["cli"] = dict(path=ev.result_path, my_batches=ev.my_batches,
                      ratio=ev.last_ambiguity_ratio,
                      tb=ev.tb_logger is not None)
    return out


JOBS = {"basics": job_basics, "jax_steps": job_jax_steps,
        "port_steps": job_port_steps, "eval": job_eval}


def main(argv) -> None:
    job, rank, world, port, workdir, threads = (
        argv[0], int(argv[1]), int(argv[2]), int(argv[3]), argv[4],
        int(argv[5]))
    import torch

    torch.set_num_threads(threads)
    from x_as_supervision_tpu_torch.parallel import mesh

    if world:
        mesh.initialize_multihost(f"localhost:{port}", world, rank,
                                  backend="gloo", timeout_s=RANK_TIMEOUT_S)
    import torch_tp

    try:
        result = {**JOBS, **torch_tp.JOBS}[job](rank, world, workdir)
        torch.save(result, os.path.join(workdir, f"{job}_{rank}.pt"))
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
