"""The ReLU decisions of a gradient parity test between the port and the
JAX package: their near-ties, found with the port's float64 run as the
arbiter, and decided as the exact value decides them on both sides.

A ReLU or leaky ReLU decides, per element, on the sign of its input, and its
gradient steps there. Two float32 computations of one input differ by their
rounding, so an input whose exact value lies within that rounding of 0
falls on either side in either package, and every gradient upstream of it
then differs by the step: a discontinuity, not rounding, which no tolerance
on the gradients absorbs. Which side it falls on changes with the summation
order, and so with the number of threads of torch or XLA. The tests hold
such a near-tie instead of hoping it falls the same way:

  * ``PortRelus`` records, in a ``with`` block, the input of every ReLU
    (``F.relu``: the detector, the discriminators) and leaky ReLU
    (``models/physique.py:leaky_relu``) that the port computes, and decides
    the elements it is given as it is told;
  * ``find_ties`` compares a float32 run's records with a float64 run's
    from the same state (the exact value, to float32's eye). An element is
    a near-tie where its exact input lies within ``TIE_FACTOR`` times the
    float32 run's largest rounding on its channel of 0 (a channel's
    rounding follows its conditioning: BatchNorm divides a near-constant
    channel by a small deviation), so every element the float32 run
    decided against the exact sign is one;
  * ``JaxRelus`` does in the JAX package what ``PortRelus`` does in the
    port, while a function is traced (flax.linen.relu and leaky_relu, in
    trace order, checked call by call against the port's shapes). JAX's
    own decision inside a jitted step cannot be read, so the test sets it:
    both sides decide the near-ties as the exact value does, and every
    downstream quantity is compared under that decision.

A call of the port is numbered in forward order; a call inside a backward
(a rematerialized segment recomputed) is the forward call with the bitwise
same input, and is decided as it was.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

# an exact input within this many times the float32 run's largest rounding
# on its channel of 0 is a near-tie: another float32 summation order, of
# about the same rounding, may put it on either side
TIE_FACTOR = 2.0


def positive_side(x, kind: str):
    """Where a ReLU (x > 0) or a leaky ReLU (x >= 0, as both packages
    have it) passes its input; numpy or torch."""
    return x > 0 if kind == "relu" else x >= 0


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


class PortRelus:
    """Within a ``with`` block: the port's ReLUs and leaky ReLUs record
    their forward calls (``inputs``: float64 copies, ``kinds``), and decide
    the elements of ``forced`` ({call: (flat indices, positive)}) as given
    instead of by their input's sign: the forward passes the input there
    (positive) or its slope times it, and the gradient steps with it."""

    def __init__(self, forced: dict | None = None):
        self.forced = {c: (torch.as_tensor(i, dtype=torch.long),
                           torch.as_tensor(p, dtype=torch.bool))
                       for c, (i, p) in (forced or {}).items()}
        self.inputs: list[torch.Tensor] = []
        self.kinds: list[str] = []
        self._raw: list[torch.Tensor] = []
        self.applied: set = set()

    def _call(self, x: torch.Tensor, kind: str) -> int:
        x = x.detach()
        if _in_backward():
            for c, raw in enumerate(self._raw):
                if (raw.shape == x.shape and raw.dtype == x.dtype
                        and torch.equal(raw, x)):
                    return c
            raise AssertionError("a ReLU recomputed in the backward matches "
                                 "no forward call")
        self._raw.append(x.clone())
        self.inputs.append(x.double().clone())
        self.kinds.append(kind)
        return len(self._raw) - 1

    def _decide(self, x, kind: str, slope: float, plain):
        call = self._call(x, kind)
        if call not in self.forced:
            return plain()
        index, positive = self.forced[call]
        mask = positive_side(x, kind).flatten()
        mask[index] = positive
        self.applied.add(call)
        return torch.where(mask.view(x.shape), x, x * slope)

    def __enter__(self):
        from x_as_supervision_tpu_torch.models import physique

        self._saved = F.relu, physique.leaky_relu
        relu, leaky = self._saved

        def patched_relu(x, inplace=False):
            return self._decide(x, "relu", 0.0,
                                lambda: relu(x, inplace=inplace))

        def patched_leaky(x, negative_slope=0.01):
            return self._decide(x, "leaky", negative_slope,
                                lambda: leaky(x, negative_slope))

        F.relu, physique.leaky_relu = patched_relu, patched_leaky
        return self

    def __exit__(self, *exc):
        from x_as_supervision_tpu_torch.models import physique

        F.relu, physique.leaky_relu = self._saved
        return False


def _nhwc(shape) -> tuple:
    """The JAX package's shape of a port activation: NHWC for 4-D."""
    shape = tuple(shape)
    if len(shape) == 4:
        b, c, h, w = shape
        return b, h, w, c
    return shape


def _nhwc_index(flat: np.ndarray, shape) -> np.ndarray:
    """Flat NCHW indices of a 4-D port activation as flat NHWC indices."""
    if len(shape) != 4:
        return flat
    b, c, h, w = np.unravel_index(flat, shape)
    return np.ravel_multi_index((b, h, w, c), _nhwc(shape))


def _channel_rounding(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The largest |a - b| over each element's channel (dim 1 of NCHW, the
    last dim otherwise), broadcast to a's shape."""
    e = (a - b).abs()
    if e.dim() == 4:
        return e.amax(dim=(0, 2, 3), keepdim=True).expand_as(e)
    return e.reshape(-1, e.shape[-1]).amax(0).expand_as(e)


@dataclass
class Ties:
    """The near-ties of a step: ``port`` and ``jax`` ({call: (flat indices,
    positive)}, NCHW and the JAX package's layout) decide each as the exact
    value does; ``shapes`` and ``kinds`` are the port's calls'."""

    port: dict = field(default_factory=dict)
    jax: dict = field(default_factory=dict)
    shapes: list = field(default_factory=list)
    kinds: list = field(default_factory=list)


def find_ties(fp32: PortRelus, fp64: PortRelus,
              factor: float = TIE_FACTOR) -> Ties:
    """The near-ties of a float32 and a float64 run of the same step from
    the same state (which must have made the same calls). Every element
    that the float32 run decided against the exact sign is one: its
    rounding there exceeds its margin."""
    shapes = [tuple(t.shape) for t in fp32.inputs]
    assert shapes == [tuple(t.shape) for t in fp64.inputs]
    assert fp32.kinds == fp64.kinds
    ties = Ties(shapes=shapes, kinds=list(fp32.kinds))
    for call, (a, b) in enumerate(zip(fp32.inputs, fp64.inputs)):
        kind = fp32.kinds[call]
        band = factor * _channel_rounding(a, b)
        near = b.abs() <= band
        index = torch.nonzero(near.flatten()).flatten()
        if not len(index):
            continue
        exact = b.flatten()[index]
        positive = positive_side(exact, kind)
        ties.port[call] = (index, positive)
        ties.jax[call] = (_nhwc_index(index.numpy(), shapes[call]),
                          positive.numpy())
    return ties


class JaxRelus:
    """Within a ``with`` block: flax.linen.relu and leaky_relu, as the JAX
    package's modules call them while a function is traced (a fresh jit, or
    op by op), are numbered in call order and checked against the port's
    calls (`ties.shapes`, `ties.kinds`), and the near-ties of `ties` are
    decided as given. ``calls`` counts them."""

    def __init__(self, ties: Ties):
        self.ties = ties
        self.calls = 0

    def _decide(self, x, kind: str, slope: float, plain):
        import jax.numpy as jnp

        call = self.calls
        self.calls += 1
        assert call < len(self.ties.shapes), "more ReLUs in JAX than the port"
        want = _nhwc(self.ties.shapes[call])
        assert (kind, tuple(x.shape)) == (self.ties.kinds[call], want), (
            call, kind, x.shape, self.ties.kinds[call], want)
        if call not in self.ties.jax:
            return plain()
        index, positive = self.ties.jax[call]
        mask = positive_side(x, kind).reshape(-1).at[index].set(positive)
        return jnp.where(mask.reshape(x.shape), x, x * slope)

    def __enter__(self):
        import flax.linen as fnn

        self._saved = fnn.relu, fnn.leaky_relu
        relu, leaky = self._saved

        def patched_relu(x):
            return self._decide(x, "relu", 0.0, lambda: relu(x))

        def patched_leaky(x, negative_slope=0.01):
            return self._decide(x, "leaky", negative_slope,
                                lambda: leaky(x, negative_slope))

        fnn.relu, fnn.leaky_relu = patched_relu, patched_leaky
        return self

    def __exit__(self, *exc):
        import flax.linen as fnn

        fnn.relu, fnn.leaky_relu = self._saved
        return False


def held_run(port_run):
    """`port_run(dtype)` (the port's step in `dtype` from one state; its
    result) in float32 and in float64, recorded, then in float32 again with
    the near-ties decided as the exact value decides them where there are
    any. Returns (the held float32 result, the float64 result, Ties)."""
    r32, r64 = PortRelus(), PortRelus()
    with r32:
        got = port_run(torch.float32)
    with r64:
        exact = port_run(torch.float64)
    assert all(x.dtype == torch.float64 for x in r64._raw)
    ties = find_ties(r32, r64)
    if ties.port:
        held = PortRelus(ties.port)
        with held:
            got = port_run(torch.float32)
        assert held.applied == set(ties.port), (held.applied, ties.port)
    return got, exact, ties


def _excess_ratio(got, want, rtol: float, atol: float) -> float:
    """max over elements of |got - want| / (atol + rtol |want|): at most 1
    where np.testing.assert_allclose(got, want, rtol, atol) passes."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    bound = atol + rtol * np.abs(want)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(diff == 0, 0.0, diff / bound)
    return float(np.max(ratio, initial=0.0))


def assert_held(got, want, exact, rtol: float, atol: float,
                err_msg: str = "") -> None:
    """The port's float32 `got` held to JAX's `want` at (rtol, atol), where
    the port's own float32 rounding (its distance from the exact value
    `exact`, the port's float64 run) takes at most half of that bound.
    Where it takes more, two float32 summation orders of that tensor may
    part by more than the bound (a sum of large cancelling terms), and each
    side is held to the exact value at (rtol, atol) instead: the float64
    run's error model, which bounds the two apart by twice it."""
    if _excess_ratio(got, exact, rtol, atol) <= 0.5:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=err_msg)
        return
    np.testing.assert_allclose(got, exact, rtol=rtol, atol=atol,
                               err_msg=f"{err_msg} (the port's float32 "
                                       f"against its float64)")
    np.testing.assert_allclose(want, exact, rtol=rtol, atol=atol,
                               err_msg=f"{err_msg} (JAX's float32 against "
                                       f"the port's float64)")
