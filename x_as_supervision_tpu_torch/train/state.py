"""Train state and the GAN train step, ported from the JAX package's
train/state.py.

One call of ``train_step`` is one iteration of the reference: an optional
discriminator update and an optional generator (detector + physique net)
update, with

  * two Adam(0.5, 0.999, eps 1e-8) optimizers whose learning rate follows
    ``multistep_schedule`` in each optimizer's own update count;
  * every parameter stepped at every update, a missing gradient taken as
    zero, as optax steps every leaf;
  * the reference's leftover-gradient carry: the generator's smpl_gen loss
    back-propagates into the discriminator's parameters, and that gradient
    is not applied at once but added to the next discriminator update. It is
    computed with ``torch.autograd.grad`` and carried explicitly in
    ``pending_disc_grads``; nothing relies on ``.grad`` accumulation.

When both updates run in one iteration (the fused step) the discriminator
phase reuses the generator phase's camera forward, and the generator's
gradients are taken at the pre-update discriminator parameters, as in the
JAX package; with ``model_params.fuse_gan_step`` false the iteration is a
discriminator-only step, then a generator-only one, as there.

Data parallelism (parallel/): in a process group each rank's losses are
its shares of the global losses (models/composed.py), and before Adam the
generator's gradients, the discriminator's and the discriminator gradient
that the generator's loss leaves to be carried are summed over the ranks in
one flat all-reduce (``C.psum_flat``). Every rank then applies the same
update, and the carried gradient is the global one. The metrics returned
are global values (one more small all-reduce). Without a process group
nothing of this runs.

Tensor parallelism (parallel/tp.py): ``tp.shard_state`` cuts the modules,
both Adams and the carried gradient to this rank's channel shards and
records the split dims in ``shard_dims``. Adam then works on the shards,
elementwise as ever; the flat all-reduce sums over the data ranks only (a
shard's gradient is local to its model rank), and the replicated
gradients and running statistics are taken from model rank 0
(``tp.sync_replicated``).

Under a profiler a call is the span ``xas.train.step``, and its phases are
spans within it (spans.py): preprocess, gen_forward and gen_backward,
disc_forward and disc_backward, allreduce (the flat all-reduce and the
replicated sync), optimizer (both Adams, the carry, the zero fills) and
metrics.
"""

from __future__ import annotations

import torch

from .. import spans as X
from ..parallel import collectives as C
from ..parallel import tp
from ..spans import span

from ..models.composed import (
    GanSpec,
    discriminator_forward,
    generator_forward,
    preprocess_batch,
)


def multistep_schedule(base_lr: float, milestones, steps_per_epoch: int,
                       gamma: float = 0.1, every: int = 1):
    """MultiStepLR(gamma) in optimizer-update units: the learning rate of
    update number `count` (0-based). A milestone at epoch m falls at update
    ceil(m * steps_per_epoch / every), since an optimizer on an `every`-step
    cadence updates once every `every` global steps; the rate drops from
    that update on, as optax.piecewise_constant_schedule has it."""
    boundaries = sorted({-(-int(m) * steps_per_epoch // every)
                         for m in (milestones or [])})

    def lr(count: int) -> float:
        value = float(base_lr)
        for b in boundaries:
            if count >= b:
                value *= gamma
        return value

    return lr


def _adam(params):
    return torch.optim.Adam(params, lr=0.0, betas=(0.5, 0.999), eps=1e-8)


class TrainState:
    """The GAN's modules (through the spec), its two optimizers and their
    update counts, the carried discriminator gradient, the step and the
    number of finished epochs."""

    def __init__(self, spec: GanSpec, train_params: dict,
                 steps_per_epoch: int, disc_every: int = 1,
                 gen_every: int = 1):
        self.spec = spec
        # {"<module>.<key>": dim} of the tensors split over the model ranks
        # (parallel/tp.py:shard_state); empty: the whole state
        self.shard_dims: dict = {}
        self.bind_params()
        milestones = train_params.get("epoch_milestones", [])
        self.lr_det = multistep_schedule(
            float(train_params["lr_kp_detector"]), milestones,
            steps_per_epoch, every=gen_every)
        self.lr_disc = multistep_schedule(
            float(train_params.get("lr_discriminator", 0.0)), milestones,
            steps_per_epoch, every=disc_every)
        self.det_updates = 0
        self.disc_updates = 0
        self.pending_disc_grads = [torch.zeros_like(p)
                                   for p in self.disc_params]
        self.step = 0
        self.epoch = 0

    def bind_params(self) -> None:
        """Collect the modules' parameters (the generator's: the detector's
        and the physique net's; the discriminator's) and build both Adams
        on them, fresh."""
        spec = self.spec
        gen = [("detector." + n, p)
               for n, p in spec.detector.named_parameters()]
        if spec.physique is not None:
            gen += [("physique." + n, p)
                    for n, p in spec.physique.named_parameters()]
        disc = (list(spec.discriminator.named_parameters())
                if spec.discriminator is not None else [])
        self.gen_names = [n for n, _ in gen]
        self.gen_params = [p for _, p in gen]
        self.disc_names = [n for n, _ in disc]
        self.disc_params = [p for _, p in disc]
        self.opt_det = _adam(self.gen_params)
        self.opt_disc = _adam(self.disc_params) if self.disc_params else None


def _filled(grads, params):
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def _apply(opt, params, grads, lr: float) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    for p in params:
        p.grad = None


def _grads(loss, params):
    return _filled(torch.autograd.grad(loss, params, allow_unused=True),
                   params)


def _gen_losses(state: TrainState, batch, generator, outputs=None,
                rot_u=None):
    with span(X.GEN_FORWARD):
        losses, decode = generator_forward(state.spec, batch, generator,
                                           outputs, rot_u)
        total = sum(v.mean() for v in losses.values())
    with span(X.GEN_BACKWARD):
        grads = _grads(total, state.gen_params + state.disc_params)
    n = len(state.gen_params)
    return total, losses, decode, grads[:n], grads[n:]


def _metrics(total, losses, loss_disc=None) -> dict:
    metrics = {"loss_total": total.detach()}
    metrics.update({f"loss/{k}": v.detach().mean() for k, v in losses.items()})
    if loss_disc is not None:
        metrics["loss_disc"] = loss_disc.detach()
    return metrics


def _global(metrics: dict) -> dict:
    """The metrics (this rank's shares) summed over the ranks in one
    all-reduce: the global values. The dict itself without a process
    group."""
    if not C.is_distributed() or not metrics:
        return metrics
    keys = sorted(metrics)
    total = C.psum_data(torch.stack([metrics[k].float() for k in keys]))
    return dict(zip(keys, total.unbind()))


def _update_disc(state: TrainState, grads) -> None:
    grads = [g + c for g, c in zip(grads, state.pending_disc_grads)]
    _apply(state.opt_disc, state.disc_params, grads,
           state.lr_disc(state.disc_updates))
    state.disc_updates += 1


def _update_gen(state: TrainState, grads) -> None:
    _apply(state.opt_det, state.gen_params, grads,
           state.lr_det(state.det_updates))
    state.det_updates += 1


def train_step(state: TrainState, batch: dict,
               generator: torch.Generator | None = None,
               do_disc: bool = True, do_gen: bool = True,
               with_outputs: bool = False, rot_draws: dict | None = None):
    """One iteration on `batch` (tensors on the modules' device); returns
    the scalar metrics (loss_total, loss/<name>, loss_disc; global values)
    as tensors, and
    with `with_outputs` (metrics, outputs): the visualization outputs of
    both phases (models/composed.py), the discriminator's first, as the
    JAX package merges them. `generator` drives the discriminators'
    dropout and use_aug's rotations; `rot_draws` ({"gen": u, "disc": u})
    gives the rotations' uniforms instead (models/composed.py)."""
    with span(X.TRAIN_STEP):
        spec = state.spec
        has_disc = spec.discriminator is not None
        with span(X.TRAIN_PREPROCESS):
            batch = preprocess_batch(batch, spec)
        rot_gen, rot_disc = ((rot_draws or {}).get(k)
                             for k in ("gen", "disc"))
        metrics: dict = {}
        d_out = {} if with_outputs else None
        g_out = {} if with_outputs else None
        if do_disc and do_gen and has_disc and spec.fuse_gan_step:
            # fused: generator gradients at the pre-update discriminator,
            # then the discriminator phase on the same camera forward
            total, losses, decode, g_gen, g_disc = _gen_losses(
                state, batch, generator, g_out, rot_gen)
            with span(X.DISC_FORWARD):
                loss_disc = discriminator_forward(
                    spec, batch, generator, precomputed_decode=decode,
                    outputs=d_out, rot_u=rot_disc)
            with span(X.DISC_BACKWARD):
                d_grads = _grads(loss_disc, state.disc_params)
            with span(X.ALLREDUCE):
                g_gen, g_disc, d_grads = C.psum_flat(g_gen, g_disc, d_grads)
                tp.sync_replicated(state, g_gen, d_grads, g_disc)
            with span(X.OPTIMIZER):
                _update_disc(state, d_grads)
                _update_gen(state, g_gen)
                state.pending_disc_grads = g_disc
            with span(X.METRICS):
                metrics = _metrics(total, losses, loss_disc)
        else:
            if do_disc and has_disc:
                with span(X.DISC_FORWARD):
                    loss_disc = discriminator_forward(
                        spec, batch, generator, outputs=d_out,
                        rot_u=rot_disc)
                with span(X.DISC_BACKWARD):
                    d_grads = _grads(loss_disc, state.disc_params)
                with span(X.ALLREDUCE):
                    (d_grads,) = C.psum_flat(d_grads)
                    tp.sync_replicated(state, [], d_grads, [])
                with span(X.OPTIMIZER):
                    _update_disc(state, d_grads)
                    state.pending_disc_grads = [torch.zeros_like(p)
                                                for p in state.disc_params]
                with span(X.METRICS):
                    metrics["loss_disc"] = loss_disc.detach()
            if do_gen:
                total, losses, _, g_gen, g_disc = _gen_losses(
                    state, batch, generator, g_out, rot_gen)
                with span(X.ALLREDUCE):
                    g_gen, g_disc = C.psum_flat(g_gen, g_disc)
                    tp.sync_replicated(state, g_gen, [], g_disc)
                with span(X.OPTIMIZER):
                    _update_gen(state, g_gen)
                    state.pending_disc_grads = [
                        c + g for c, g in zip(state.pending_disc_grads,
                                              g_disc)]
                with span(X.METRICS):
                    metrics.update(_metrics(total, losses))
        state.step += 1
        with span(X.METRICS):
            metrics = _global(metrics)
        if with_outputs:
            return metrics, {**d_out, **g_out}
        return metrics
