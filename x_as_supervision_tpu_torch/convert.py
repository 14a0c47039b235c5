"""A JAX train state carried into the port, with numpy only.

``train_state_arrays_from_jax(raw)`` maps the JAX package's train state,
as an Orbax restore without a target returns it (the JAX package's
train/checkpoint.py:_restore_raw), to flat arrays in the port's names;
``load_train_state`` loads those arrays into the port's modules and
TrainState. scripts/jax_checkpoint_to_torch.py runs both where JAX is and
writes the port's own checkpoint, which then serves, scores, finetunes and
resumes wherever the port runs.

The raw tree is a dict keyed by the JAX TrainState's fields:
``det_params``, ``det_stats``, ``phys_params``, ``phys_stats``,
``disc_params`` (empty dicts where the model has no physique net or no
discriminator), ``opt_det``, ``opt_disc``, ``pending_disc_grads``, ``step``
and ``epoch`` (int32 scalars). Each optimizer state is optax.adam's chain
as a list: first the Adam state ``{'count', 'mu', 'nu'}`` (``mu`` and
``nu`` shaped as the parameters they follow: ``{'detector', 'physique'}``
for the generator), then the schedule's state (``{'count'}``, or None).
Leaves are arrays of any kind that ``np.asarray`` reads. The detector's
variable tree is the same with ``per_camera_bn``, ``fuse_bn`` (the link's
``_StatsBN`` keeps nn.BatchNorm's names) and the phase head, so one mapping
(weights.py) serves them all.

The flat arrays:

  * ``var/<module>.<name>``: parameters and BatchNorm running statistics
    of the detector, physique net and discriminator;
  * ``mu/det/<name>``, ``nu/det/<name>``: the generator's Adam moments by
    TrainState.gen_names (``detector.*``, ``physique.*``);
    ``mu/disc/<name>``, ``nu/disc/<name>``: the discriminator's, by
    TrainState.disc_names;
  * ``count/det``, ``count/disc``: the Adams' update counts;
  * ``pending/<name>``: the carried discriminator gradient;
  * ``step``, ``epoch`` (optional in ``load_train_state``).

Every leaf of the raw tree that carries state is mapped: a leaf that no
port tensor takes raises, as does a port tensor that no array fills.
"""

from __future__ import annotations

import numpy as np
import torch

from . import weights

_FIELDS = ("det_params", "det_stats", "phys_params", "phys_stats",
           "disc_params", "opt_det", "opt_disc", "pending_disc_grads",
           "step", "epoch")


class _Tracked(dict):
    """A nested dict that records the path of every leaf read from it."""

    def __init__(self, tree: dict, path: tuple, seen: set):
        super().__init__(tree)
        self._path, self._seen = path, seen

    def __getitem__(self, key):
        value = super().__getitem__(key)
        path = self._path + (key,)
        if isinstance(value, dict):
            return _Tracked(value, path, self._seen)
        self._seen.add(path)
        return value

    def get(self, key, default=None):
        return self[key] if key in self else default


def _numpy(tree):
    """The tree with dicts for its mappings, lists for its sequences, None
    as an empty dict and numpy arrays for its leaves."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return np.asarray(tree)


def _leaves(tree: dict, path: tuple = ()) -> set:
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _leaves(v, path + (k,))
        else:
            out.add(path + (k,))
    return out


def _np(sd: dict, params_only: bool = False) -> dict:
    """A state_dict as numpy arrays; without the BatchNorm statistics
    where `params_only` (an Adam moment follows parameters only)."""
    return {k: v.numpy() for k, v in sd.items()
            if "num_batches" not in k
            and not (params_only and "running_" in k)}


def _generator(det: dict, det_stats: dict, phys: dict, phys_stats: dict,
               params_only: bool = False) -> dict:
    sd = {"detector." + k: v for k, v in _np(
        weights.state_dict_from_variables(
            {"params": det, "batch_stats": det_stats}), params_only).items()}
    if phys:
        sd.update({"physique." + k: v for k, v in _np(
            weights.physique_state_dict(
                {"params": phys, "batch_stats": phys_stats}),
            params_only).items()})
    return sd


def _discriminator(params: dict) -> dict:
    return _np(weights.discriminator_state_dict(params)) if params else {}


def module_arrays(det_params: dict, det_stats: dict, phys_params: dict,
                  phys_stats: dict, disc_params: dict) -> dict:
    """The JAX modules' variables (trees of arrays; empty where the model
    has no physique net or discriminator) as numpy arrays in the port's
    names: ``detector.<name>``, ``physique.<name>``,
    ``discriminator.<name>``."""
    out = _generator(det_params, det_stats, phys_params, phys_stats)
    out.update({"discriminator." + k: v
                for k, v in _discriminator(disc_params).items()})
    return out


def train_state_arrays_from_jax(raw: dict) -> dict:
    """The JAX train state `raw` (module docstring) as the port's flat
    arrays."""
    missing = [f for f in _FIELDS if f not in raw]
    if missing:
        raise ValueError(f"not a JAX train state: no {missing}")
    raw = _numpy(raw)
    seen: set = set()
    tracked = {f: _Tracked(raw[f], (f,), seen) if isinstance(raw[f], dict)
               else raw[f] for f in _FIELDS}
    out = {"var/" + k: v for k, v in module_arrays(
        *(tracked[f] for f in _FIELDS[:5])).items()}
    for tag, field in (("det", "opt_det"), ("disc", "opt_disc")):
        adam = raw[field][0]
        moments = _Tracked(adam, (field, 0), seen)
        out[f"count/{tag}"] = np.asarray(int(moments["count"]))
        for m in ("mu", "nu"):
            tree = moments.get(m, {})
            if tag == "det":
                # the statistics only give the mapping its shapes
                sd = _generator(tree["detector"], raw["det_stats"],
                                tree.get("physique", {}), raw["phys_stats"],
                                params_only=True)
            else:
                sd = _discriminator(tree)
            out.update({f"{m}/{tag}/{k}": v for k, v in sd.items()})
    out.update({"pending/" + k: v for k, v in
                _discriminator(tracked["pending_disc_grads"]).items()})
    out["step"] = np.asarray(int(raw["step"]))
    out["epoch"] = np.asarray(int(raw["epoch"]))

    carried = set()
    for f in _FIELDS[:5] + ("pending_disc_grads",):
        carried |= _leaves(raw[f], (f,))
    for field in ("opt_det", "opt_disc"):
        carried |= _leaves(raw[field][0], (field, 0))
    left = sorted("/".join(map(str, p)) for p in carried - seen)
    if left:
        raise ValueError(f"{len(left)} leaves of the JAX state map to no "
                         f"tensor of the port: {left[:8]}")
    return out


def load_train_state(spec, state, arrays: dict) -> None:
    """Load a train state given as flat arrays (module docstring) into
    `spec`'s modules and `state`: each module's parameters and running
    statistics, both Adams' moments and update counts, the carried
    discriminator gradient, and the step and epoch where given. Every
    tensor of the modules (but BatchNorm's num_batches_tracked) must be
    given, and every ``var/`` array must name one of them."""
    def t(key):
        return torch.as_tensor(np.asarray(arrays[key])).clone()

    for prefix in ("detector", "physique", "discriminator"):
        module = getattr(spec, prefix)
        head = f"var/{prefix}."
        given = {k[len(head):]: t(k) for k in arrays if k.startswith(head)}
        if module is None:
            if given:
                raise ValueError(f"arrays for a {prefix} the model lacks")
            continue
        missing, unexpected = module.load_state_dict(given, strict=False)
        missing = [k for k in missing if "num_batches" not in k]
        if missing or unexpected:
            raise ValueError(f"{prefix}: missing {missing[:8]}, "
                             f"unexpected {unexpected[:8]}")
    for tag, opt, names, params in (
            ("det", state.opt_det, state.gen_names, state.gen_params),
            ("disc", state.opt_disc, state.disc_names, state.disc_params)):
        count = int(np.asarray(arrays[f"count/{tag}"]))
        for n, p in zip(names, params):
            opt.state[p] = {"step": torch.tensor(float(count)),
                            "exp_avg": t(f"mu/{tag}/{n}"),
                            "exp_avg_sq": t(f"nu/{tag}/{n}")}
    state.det_updates = int(np.asarray(arrays["count/det"]))
    state.disc_updates = int(np.asarray(arrays["count/disc"]))
    state.pending_disc_grads = [t(f"pending/{n}") for n in state.disc_names]
    if "step" in arrays:
        state.step = int(np.asarray(arrays["step"]))
    if "epoch" in arrays:
        state.epoch = int(np.asarray(arrays["epoch"]))
