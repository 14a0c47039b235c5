"""Tensor parallelism over the grid's ``model`` ranks: the port's counterpart
of the JAX package's parallel/tp.py.

The rule is the JAX package's channel partition, on the torch layouts:

  * a conv's weight is split along its output channels: dim 0 of
    nn.Conv2d's (Cout, Cin, kh, kw) and of the physique's Conv3x3, dim 1 of
    nn.ConvTranspose2d's (Cin, Cout, kh, kw) (JAX: the last dim of
    (kh, kw, Cin, Cout));
  * a Linear's weight along its outputs, dim 0 of (out, in) (JAX: dim 1 of
    the Dense kernel (in, out));
  * a 1-D per-channel vector of at least MIN_VECTOR channels (BatchNorm's
    scale, shift and running statistics, biases, the normalizations'
    affines) along its one dim;

each only where the size divides m; anything else is replicated on every
model rank. The rule keys on rank and shape, as JAX's does, so the Adam
moments and the carried discriminator gradient get their parameter's.

Where JAX leaves the collectives to GSPMD, the port writes them out as
Megatron's column-parallel pair (parallel/collectives.py): a layer whose
weight is split takes the whole, model-replicated activation through
``copy_to_model``, computes its output-channel shard, runs a split
per-channel op (a BatchNorm of >= 64 channels) on the shard, its statistics
over the data ranks only, and ``gather_channels`` puts the channels back
together; a replicated per-channel op after a split layer runs after the
gather. Every non-linear op between the gathers runs on whole tensors, so
it needs no collective, and the model ranks compute the same function as
one process: the split changes where a channel is computed, never what.
The layers read from their own parameters whether they are split: a
weight whose output dim is smaller than the layer's declared width is a
shard.

Gradients of split parameters are local to their model rank, and the
step sums them over the data ranks only. A replicated parameter's gradient
is the same on every model rank up to the order of a kernel's atomic sums
(the decode, the upsample's backward), so the step takes model rank 0's
(``sync_replicated``), and with it the replicated running statistics.
How far a rank's own values were from rank 0's before that broadcast is
kept (``replica_drift``), so a rank that computes them otherwise is seen,
not only overwritten.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from . import collectives as C
from . import mesh

MIN_VECTOR = 64  # per-channel vectors below this stay replicated
MODULES = ("detector", "physique", "discriminator")


def tp_spec(tensor, m: int, out_dim: int = 0) -> int | None:
    """The dim of `tensor` to split over m model ranks, or None
    (replicated): `out_dim` (the output channels) of a 4-D conv weight or a
    2-D Linear weight, dim 0 of a 1-D vector of at least MIN_VECTOR
    channels, each where it divides m."""
    if m <= 1:
        return None
    shape = tuple(tensor.shape)
    if len(shape) in (2, 4) and shape[out_dim] % m == 0:
        return out_dim
    if len(shape) == 1 and shape[0] >= MIN_VECTOR and shape[0] % m == 0:
        return 0
    return None


def module_shardings(module: nn.Module, m: int) -> dict:
    """{state_dict key: dim or None} of `module`'s parameters and
    persistent buffers under tp_spec, with each tensor's output dim read
    from the module that holds it."""
    owners = dict(module.named_modules())
    out = {}
    for key, t in module.state_dict(keep_vars=True).items():
        owner, _, leaf = key.rpartition(".")
        deconv = (isinstance(owners[owner], nn.ConvTranspose2d)
                  and leaf == "weight")
        out[key] = tp_spec(t, m, 1 if deconv else 0)
    return out


def state_shardings(spec, m: int) -> dict:
    """{"<module>.<key>": dim or None} of the GAN's modules (the detector,
    the physique net and the discriminator, where there is one): every
    parameter and running statistic. An Adam moment and a carried gradient
    take their parameter's entry."""
    out = {}
    for name in MODULES:
        module = getattr(spec, name)
        if module is not None:
            out.update({f"{name}.{k}": d for k, d in
                        module_shardings(module, m).items()})
    return out


def take_shard(t: torch.Tensor, dim: int | None,
               m: int | None = None, index: int | None = None):
    """Model rank `index`'s (this rank's) shard of the whole `t` along
    `dim`; `t` where dim is None or its size does not divide m (a tensor
    of other widths, which a restore then refuses)."""
    m = mesh.model_size() if m is None else m
    index = mesh.model_index() if index is None else index
    if dim is None or t.shape[dim] % m:
        return t
    n = t.shape[dim] // m
    return t.narrow(dim, index * n, n)


def _cut(t: torch.Tensor, dim: int | None) -> torch.Tensor:
    """This rank's shard of t, in memory of its own (a view would keep the
    whole tensor alive)."""
    piece = take_shard(t, dim)
    return piece if piece is t else piece.clone()


def _param_dims(state) -> tuple[list, list]:
    """The split dims of the generator's and the discriminator's parameter
    lists, in the state's (and its Adams') order."""
    dims = state.shard_dims
    return ([dims.get(n) for n in state.gen_names],
            [dims.get("discriminator." + n) for n in state.disc_names])


def _map_adam(opt_sd: dict, dims: list, fn) -> dict:
    """An Adam state_dict with fn(tensor, dim) applied to each moment (a
    new dict; the live optimizer's tensors are not touched)."""
    state = {}
    for i, st in opt_sd["state"].items():
        st = dict(st)
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                st[k] = fn(st[k], dims[i])
        state[i] = st
    return dict(opt_sd, state=state)


def _map_state(sd: dict, state, fn, modules_only: bool = False) -> dict:
    """A state_dict() (train/checkpoint.py's layout) with fn(tensor, dim)
    applied to every tensor that `state`'s split dims name, dim None for
    the rest: the modules', and unless `modules_only` both Adams' moments
    and the carried gradient (new dicts and lists; `sd` is not changed)."""
    out = dict(sd)
    for name in MODULES:
        if sd.get(name):
            out[name] = {k: fn(v, state.shard_dims.get(f"{name}.{k}"))
                         for k, v in sd[name].items()}
    if modules_only:
        return out
    gen, disc = _param_dims(state)
    for key, dims in (("opt_det", gen), ("opt_disc", disc)):
        if sd.get(key):
            out[key] = _map_adam(sd[key], dims, fn)
    out["pending_disc_grads"] = [fn(g, d) for g, d in zip(
        sd["pending_disc_grads"], disc)]
    return out


def shard_raw(raw: dict, state, modules_only: bool = False) -> dict:
    """A whole checkpoint dict (train/checkpoint.py:state_dict's layout)
    cut to this rank's shards under `state`'s split dims: the modules',
    and unless `modules_only` both Adams' and the carried gradient."""
    if not state.shard_dims:
        return raw
    return _map_state(raw, state, _cut, modules_only)


def shard_module(module: nn.Module, m: int | None = None) -> dict:
    """Cut `module`'s split parameters and running statistics to this
    rank's shards in place, over m model ranks (the grid's by default);
    returns {state_dict key: dim} of the split ones. A parameter becomes a
    new Parameter, so an optimizer built before holds the whole one."""
    m = mesh.model_size() if m is None else m
    owners = dict(module.named_modules())
    dims = {}
    for key, dim in module_shardings(module, m).items():
        if dim is None:
            continue
        owner_name, _, leaf = key.rpartition(".")
        owner = owners[owner_name]
        t = getattr(owner, leaf)
        piece = take_shard(t.detach(), dim, m).clone()
        if leaf in owner._parameters:
            owner._parameters[leaf] = nn.Parameter(
                piece, requires_grad=t.requires_grad)
        else:
            owner._buffers[leaf] = piece
        dims[key] = dim
    return dims


def shard_state(state, m: int | None = None) -> None:
    """Cut `state` (train/state.py:TrainState, whole on every rank) to this
    rank's shards in place, over m model ranks (the grid's by default):
    every split parameter and running statistic of its modules, both
    Adams' moments and the carried discriminator gradient; the optimizers
    are rebuilt on the new parameters with their state. Nothing with
    m = 1."""
    m = mesh.model_size() if m is None else m
    if m == 1:
        return
    full = dict(opt_det=state.opt_det.state_dict(),
                opt_disc=(state.opt_disc.state_dict()
                          if state.opt_disc is not None else {}),
                pending_disc_grads=state.pending_disc_grads)
    dims = {}
    for name in MODULES:
        module = getattr(state.spec, name)
        if module is not None:
            dims.update({f"{name}.{k}": d for k, d in
                         shard_module(module, m).items()})
    state.shard_dims = dims
    state.bind_params()
    raw = shard_raw(dict(full, detector={}, physique={}, discriminator={}),
                    state)
    state.opt_det.load_state_dict(raw["opt_det"])
    if state.opt_disc is not None:
        state.opt_disc.load_state_dict(raw["opt_disc"])
    state.pending_disc_grads = raw["pending_disc_grads"]


def _gather_many(tensors: list, dims: list) -> list:
    """gather_channels of each shard along its dim (no autograd), through
    one all-gather of one flat buffer per dtype and device, not one per
    tensor."""
    m = mesh.model_size()
    out = list(tensors)
    buckets: dict = {}
    for i, t in enumerate(tensors):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        sizes = [tensors[i].numel() for i in idx]
        parts = [p.split(sizes)
                 for p in C.gather_channels(flat, 0).chunk(m)]
        for k, i in enumerate(idx):
            out[i] = torch.cat([part[k].view(tensors[i].shape)
                                for part in parts], dims[i])
    return out


def gather_state(state, sd: dict) -> dict:
    """`sd` (train/checkpoint.py:state_dict of a split `state`) with every
    shard gathered into the whole tensor: what one process would hold. A
    collective: every model rank calls it, in the same order. `sd` itself
    where nothing is split."""
    if not state.shard_dims:
        return sd
    shards, dims = [], []

    def stand_in(t, dim):
        if dim is None:
            return t
        shards.append(t)
        dims.append(dim)
        return len(shards) - 1

    marked = _map_state(sd, state, stand_in)
    whole = _gather_many(shards, dims)
    return _map_state(marked, state,
                      lambda v, dim: v if dim is None else whole[v])


def sync_replicated(state, gen_grads: list, disc_grads: list,
                    carried: list) -> None:
    """Model rank 0's values of the replicated gradients (the generator's,
    the discriminator's and the carried one, in place) and of the
    replicated running statistics, on every model rank, in one broadcast
    (see the module docstring); how far this rank's were from them is kept
    for replica_drift. Nothing without a grid."""
    if mesh.model_size() == 1:
        return
    gen, disc = _param_dims(state)
    tensors = [(n, g) for n, g, d in zip(state.gen_names, gen_grads, gen)
               if d is None]
    tensors += [(n, g) for grads in (disc_grads, carried)
                for n, g, d in zip(state.disc_names, grads, disc)
                if d is None]
    for name in ("detector", "physique"):
        module = getattr(state.spec, name)
        if module is None:
            continue
        for key, v in module.state_dict(keep_vars=True).items():
            if ("running" in key and v.is_floating_point()
                    and f"{name}.{key}" not in state.shard_dims):
                tensors.append((f"{name}.{key}", v))
    if not tensors:
        return
    sizes = [t.numel() for _, t in tensors]
    mine = torch.cat([t.detach().reshape(-1).float() for _, t in tensors])
    buf = C.broadcast_model_(mine.clone())
    # a conv bias that a train-mode BatchNorm follows has a gradient of
    # rounding only, which no relative reading holds
    cancelled = ({"physique." + n for n in
                  state.spec.physique.bn_cancelled_biases()}
                 if state.spec.physique is not None else set())
    _note_drift(mine, buf, sizes, [n not in cancelled for n, _ in tensors])
    with torch.no_grad():
        for (_, t), part in zip(tensors, buf.split(sizes)):
            t.copy_(part.view_as(t))


# the replicated tensors' largest distance from model rank 0's before
# sync_replicated's broadcast (a device scalar, no host sync), over the
# syncs since the last replica_drift()
_DRIFT: list = []


def _note_drift(mine: torch.Tensor, rank0: torch.Tensor, sizes: list,
                held: list) -> None:
    """Keep the max over the `held` tensors of max |mine - rank0| /
    max |rank0| (the absolute difference where rank 0's tensor is all
    zero)."""
    lengths = torch.tensor(sizes, device=mine.device)
    diff = torch.segment_reduce((mine - rank0).abs(), "max", lengths=lengths)
    scale = torch.segment_reduce(rank0.abs(), "max", lengths=lengths)
    rel = torch.where(scale > 0, diff / scale.clamp_min(1e-30), diff)
    rel = torch.where(torch.tensor(held, device=mine.device), rel, 0).max()
    _DRIFT[:] = [torch.maximum(_DRIFT[0], rel) if _DRIFT else rel]


def replica_drift() -> float | None:
    """How far this rank's replicated gradients and running statistics
    were from model rank 0's before the broadcasts since the last call,
    relative to each tensor's largest entry (0.0 where they were bitwise
    equal; the physique's BatchNorm-cancelled conv biases left out); None
    where no broadcast ran. Resets the reading."""
    return float(_DRIFT.pop()) if _DRIFT else None


def link_route(cout_shard: int) -> str:
    """How a Bottleneck's link runs on a Cout shard: ``"shard"``, the
    kernel launched at the shard's width, where the kernel takes it (Cout
    % 64 == 0, ops/conv_bn.py); else ``"gathered_weight"``: conv2's whole
    weight gathered, the kernel launched at the whole width and its
    outputs sliced to the shard (GSPMD's treatment of the Pallas call,
    which it cannot split; e.g. layer3's 256 planes over 8 model ranks)."""
    return "shard" if cout_shard % 64 == 0 else "gathered_weight"


def full_param(p: torch.Tensor, n: int) -> torch.Tensor:
    """A per-channel vector of n channels whole: its shard gathered where
    it is split (backward: this rank's slice), else p."""
    return p if p.shape[0] == n else C.gather_channels(p, 0)


def full_channels(x: torch.Tensor, n: int, dim: int = 1) -> torch.Tensor:
    """An activation of n channels whole: its channel shard gathered where
    it holds fewer, else x."""
    return x if x.shape[dim] == n else C.gather_channels(x, dim)
