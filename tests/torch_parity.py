"""Shared helpers of the tests that hold the PyTorch port to the JAX package:
one set of seeded weights and inputs, handed to both as numpy arrays, and a
JAX train state carried into the port; a JAX reference computed once a run
for all the test processes (``computed_once``, ``jax_init_state``); the
torch threads of a test module (``few_torch_threads``)."""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x_as_supervision_tpu.models.detector import build_detector as jax_build
from x_as_supervision_tpu.tools.convert_torch_resnet import (
    convert_full_detector,
)
from x_as_supervision_tpu_torch import weights
from step_bounds import assert_step_matches  # noqa: F401 (re-exported)
from x_as_supervision_tpu_torch.convert import (
    load_train_state,
    module_arrays,
    train_state_arrays_from_jax,
)
from x_as_supervision_tpu_torch.models.detector import (
    build_detector as torch_build,
)


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)



def smpl_from_jax(jmodel, device=None):
    """A JAX SmplModel's arrays carried into the port's SmplModel."""
    from x_as_supervision_tpu_torch.models.smpl import smpl_from_arrays

    arrays = {k: np.asarray(v) for k, v in jmodel._asdict().items()}
    return smpl_from_arrays(arrays, device)


def conditioned_pair(det_params: dict, size: int, batch: int, seed: int):
    """A JAX detector initialized by flax, carried into the port through
    weights.py, conditioned there (weights.condition_for_eval on seeded
    images) and carried back through the JAX package's
    convert_full_detector.

    Returns (jax_detector, jax_variables, port_detector, images (N, S, S, 3)
    float32 in [0, 1))."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    jdet = jax_build(det_params, dtype=jnp.float32)
    init = jdet.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
                     train=False)
    tdet = torch_build(det_params)
    tdet.load_state_dict(weights.state_dict_from_variables(
        to_numpy_tree(init)))
    weights.condition_for_eval(tdet, nchw(images))
    sd = {k: v.numpy() for k, v in tdet.state_dict().items()}
    params, stats = convert_full_detector(sd, det_params.get("num_layers", 50))
    return jdet, {"params": params, "batch_stats": stats}, tdet, images


class StateArrays(dict):
    """A train state's variables in the port's names, with its Adams'
    update counts (``counts``: {"det": t, "disc": t}), which
    step_bounds.assert_step_matches reads."""

    def __init__(self, arrays: dict, counts: dict):
        super().__init__(arrays)
        self.counts = counts


def jax_state_in_port_names(js) -> StateArrays:
    """A JAX TrainState's variables (parameters and BatchNorm statistics)
    as a flat dict of arrays in the port's names (detector., physique.,
    discriminator.): the port's convert.module_arrays; with its Adams'
    update counts where it has optimizers."""
    return StateArrays(
        module_arrays(*(to_numpy_tree(getattr(js, f)) for f in (
            "det_params", "det_stats", "phys_params", "phys_stats",
            "disc_params"))),
        {tag: int(getattr(js, f"opt_{tag}")[0].count)
         for tag in ("det", "disc") if hasattr(js, f"opt_{tag}")})


def raw_train_state(js) -> dict:
    """A live JAX TrainState as the tree an Orbax restore without a target
    returns: dicts keyed by its fields, each optimizer state a list (the
    Adam state as a dict, then the schedule's)."""
    def chain(opt):
        adam = opt[0]
        return [dict(count=adam.count, mu=adam.mu, nu=adam.nu),
                dict(count=opt[1].count)]

    return dict(det_params=js.det_params, det_stats=js.det_stats,
                phys_params=js.phys_params, phys_stats=js.phys_stats,
                disc_params=js.disc_params, opt_det=chain(js.opt_det),
                opt_disc=chain(js.opt_disc),
                pending_disc_grads=js.pending_disc_grads, step=js.step,
                epoch=js.epoch)


def train_state_arrays(js) -> dict:
    """A JAX TrainState as flat numpy arrays in the port's names, the
    layout convert.load_train_state reads (an npz of it reaches a process
    without JAX): the port's convert.train_state_arrays_from_jax."""
    return train_state_arrays_from_jax(to_numpy_tree(raw_train_state(js)))


def _state_in_float64(state) -> None:
    """A port TrainState's Adam moments and carried gradient in float64
    (its modules made float64 by .double()), after load_train_state."""
    for opt in (state.opt_det, state.opt_disc):
        for st in opt.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = st[k].double()
    state.pending_disc_grads = [g.double() for g in state.pending_disc_grads]


def carry_train_state(pspec, state, js) -> None:
    """Carry a JAX TrainState into the port: parameters and BatchNorm
    statistics into the spec's modules; both Adam states, their update
    counts and the carried discriminator gradient into the TrainState."""
    load_train_state(pspec, state, train_state_arrays(js))


class HeldSteps:
    """The port's train step from a carried JAX state against the JAX
    package's jitted step, step by step, with their ReLU near-ties decided
    on both sides as the port's float64 step decides them
    (tests/torch_ties.py). `make_spec(dtype)` builds the port's spec (its
    dropout off); ``pspec`` is the float32 one."""

    def __init__(self, make_spec, train_params: dict, steps_per_epoch: int):
        from x_as_supervision_tpu_torch.train.state import TrainState

        self.ports = {}
        for dtype in (torch.float32, torch.float64):
            spec = make_spec(dtype)
            if dtype == torch.float64:
                for m in (spec.detector, spec.physique, spec.discriminator):
                    if m is not None:
                        m.double()
            self.ports[dtype] = (spec, TrainState(spec, train_params,
                                                  steps_per_epoch))
        self.pspec = self.ports[torch.float32][0]

    def _port_run(self, arrays: dict, batch: dict, rot_draws):
        from x_as_supervision_tpu_torch.train.state import train_step
        from x_as_supervision_tpu_torch.train.trainer import to_device

        def run(dtype):
            spec, state = self.ports[dtype]
            load_train_state(spec, state, arrays)
            tbatch = to_device(batch, "cpu")
            if dtype == torch.float64:
                _state_in_float64(state)
                tbatch = {k: v.double() if v.is_floating_point() else v
                          for k, v in tbatch.items()}
            kw = {} if rot_draws is None else {"rot_draws": {
                k: v.to(dtype) for k, v in rot_draws.items()}}
            metrics = train_step(state, tbatch, **kw)
            got = {}
            for prefix in ("detector", "physique", "discriminator"):
                got.update({f"{prefix}.{k}": v.detach().clone() for k, v in
                            getattr(spec, prefix).state_dict().items()
                            if "num_batches" not in k})
            return dict(metrics={k: float(v) for k, v in metrics.items()},
                        got=got, pending={
                            n: g.double().numpy() for n, g in
                            zip(state.disc_names, state.pending_disc_grads)})
        return run

    def step(self, js, batch: dict, make_step, key, rot_draws=None):
        """One fused step of each from the JAX state `js` on `batch` (JAX's
        from `make_step()`, traced afresh, with `key`; the port's with
        `rot_draws` where given). Returns JAX's new state and the step's
        record: before, want / got (the states after it), want_metrics /
        metrics, want_pending / pending / exact_pending (the carried
        discriminator gradient; the port's float64 one) and ties."""
        from torch_ties import JaxRelus, held_run

        before = jax_state_in_port_names(js)
        got, exact, ties = held_run(self._port_run(
            train_state_arrays(js), batch, rot_draws))
        with JaxRelus(ties) as relus:
            js, jmetrics, _ = make_step()(js, batch, key, do_disc=True,
                                          do_gen=True, with_outputs=False)
        assert relus.calls == len(ties.shapes)
        return js, dict(
            before=before,
            want_metrics={k: float(v) for k, v in jmetrics.items()},
            metrics=got["metrics"], want=jax_state_in_port_names(js),
            got=got["got"],
            want_pending={k: v.numpy() for k, v in
                          weights.discriminator_state_dict(
                              to_numpy_tree(js.pending_disc_grads)).items()},
            pending=got["pending"], exact_pending=exact["pending"],
            ties=ties)


def assert_pending_matches(step: dict) -> None:
    """A HeldSteps record's carried discriminator gradient against JAX's:
    fp32 gradients of the smpl_gen loss through the discriminator, at 1e-4
    relative and 1e-5 of the largest entry of any of them (against the
    port's float64 where its own float32 rounding takes more than half of
    that: tests/torch_ties.py:assert_held)."""
    from torch_ties import assert_held

    want, got = step["want_pending"], step["pending"]
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    assert scale > 0
    for k in want:
        assert_held(got[k], want[k], step["exact_pending"][k], rtol=1e-4,
                    atol=1e-5 * scale, err_msg=k)


# torch's intra-op threads in a port test module: the tests run in several
# worker processes on a few cores beside XLA's own pool, where torch's
# default of one thread per core oversubscribes them. XAS_TEST_TORCH_THREADS
# overrides it, to run the parity tests at another count (the thread sweep
# of .claude/skills/verify/SKILL.md)
TORCH_THREADS = int(os.environ.get("XAS_TEST_TORCH_THREADS", "2"))


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Autouse in every module that imports it: torch at TORCH_THREADS
    threads for the module's tests, and OMP_NUM_THREADS the same for the
    processes they start (where the test sets none of its own)."""
    saved = torch.get_num_threads()
    saved_env = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(TORCH_THREADS)
    os.environ["OMP_NUM_THREADS"] = str(TORCH_THREADS)
    yield
    torch.set_num_threads(saved)
    if saved_env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = saved_env


def shared_dir(tmp_path_factory) -> Path:
    """A directory of this run that every xdist worker sees: the parent of
    the workers' base temporary directories (the base directory itself
    without xdist)."""
    base = tmp_path_factory.getbasetemp()
    root = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
            ) / "jax_reference"
    root.mkdir(parents=True, exist_ok=True)
    return root


def _digest(obj) -> str:
    h = hashlib.sha256()

    def feed(o):
        if isinstance(o, np.ndarray):
            h.update(f"{o.dtype}{o.shape}".encode())
            h.update(np.ascontiguousarray(o).tobytes())
        elif isinstance(o, dict):
            for k in sorted(o):
                h.update(repr(k).encode())
                feed(o[k])
        elif isinstance(o, (list, tuple)):
            for v in o:
                feed(v)
        else:
            h.update(json.dumps(o, sort_keys=True, default=repr).encode())

    feed(obj)
    return h.hexdigest()[:24]


def computed_once(tmp_path_factory, name: str, key, compute):
    """compute()'s result (picklable), computed once a run by whichever
    test process asks first and read back by the others: cached in
    shared_dir under `name` and a digest of `key` (the content that decides
    the result: configs, arrays), a file lock held while it is computed."""
    root = shared_dir(tmp_path_factory)
    stem = f"{name}-{_digest(key)}"
    path = root / f"{stem}.pkl"
    with open(root / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                return pickle.loads(path.read_bytes())
            value = compute()
            tmp = root / f"{stem}.{os.getpid()}.tmp"
            tmp.write_bytes(pickle.dumps(value))
            os.replace(tmp, path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def jax_init_state(tmp_path_factory, cfg: dict, batch: dict, opt_det,
                   opt_disc, steps_per_epoch: int, seed: int = 0,
                   jit: bool = False):
    """The JAX package's init_train_state(build_gan_spec(cfg),
    PRNGKey(seed), batch, opt_det, opt_disc) (the optimizers of
    make_optimizers(cfg's train_params, steps_per_epoch)), computed once a
    run for every module that starts from the same one (flax's init runs op
    by op: some 35 s on this CPU) and rebuilt here from its arrays into the
    state's own tree: the same values, bit for bit, as the call here; with
    `jit`, jitted (some 14 s; values within rounding of the op-by-op
    ones)."""
    from x_as_supervision_tpu.train.factory import build_gan_spec
    from x_as_supervision_tpu.train.state import init_train_state

    spec = build_gan_spec(cfg)
    batch = {k: np.asarray(v) for k, v in batch.items() if k != "act"}

    def init(key):
        return init_train_state(spec, key, batch, opt_det, opt_disc)

    leaves = computed_once(
        tmp_path_factory, "init_train_state",
        {"config": cfg, "batch": batch, "steps_per_epoch": steps_per_epoch,
         "seed": seed, "jit": jit},
        lambda: [np.asarray(v) for v in jax.tree_util.tree_leaves(
            (jax.jit(init) if jit else init)(jax.random.PRNGKey(seed)))])
    tree = jax.eval_shape(init, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree), [jnp.asarray(v) for v in leaves])
