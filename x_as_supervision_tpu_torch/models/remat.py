"""Rematerialization: a checkpoint region keeps only its inputs for the
backward and runs its forward again there, as the JAX package's
``jax.checkpoint`` regions do (models/composed.py says which regions each
``model_params.remat`` mode makes).

``checkpoint`` is torch.utils.checkpoint's non-reentrant form, the one that
``torch.autograd.grad`` (the train step's only gradient call) supports. The
recompute runs every train-mode BatchNorm of the region again; in JAX the
running statistics are an output of the checkpointed function and move
once. Here the recompute runs inside ``recomputing()``'s context, which
``checkpoint`` enters through its ``context_fn`` on the thread that
recomputes, and models/resnet.py:update_running_stats leaves the running
statistics alone while it is set; it also opens the recompute's span,
``xas.remat.recompute`` (spans.py). The batch statistics that normalize are
recomputed as before. Collectives in a region (the synced statistics, the
tensor-parallel gathers) are issued again in the recompute, as
``jax.checkpoint`` reissues them: every rank recomputes the same regions in
the same order.
"""

from __future__ import annotations

import contextlib
import threading

from torch.utils import checkpoint as _ckpt

from ..spans import RECOMPUTE, span

_state = threading.local()


def recomputing() -> bool:
    """True inside a checkpoint region's recompute on this thread."""
    return getattr(_state, "depth", 0) > 0


@contextlib.contextmanager
def _recompute():
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        with span(RECOMPUTE):
            yield
    finally:
        _state.depth -= 1


def _contexts():
    # (the first forward's context, the recompute's)
    return contextlib.nullcontext(), _recompute()


def checkpoint(fn, *args):
    """fn(*args), its activations recomputed in the backward."""
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            context_fn=_contexts)
