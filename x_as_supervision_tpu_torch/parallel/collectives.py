"""The collectives of the data-parallel step over ``torch.distributed``: the
port's counterpart of the JAX package's parallel/collectives.py.

Each is the identity (and calls nothing) without a process group, so a
one-process run computes exactly what it computed before data parallelism
existed. In a group (of any size) they call ``torch.distributed``: NCCL
between cards, gloo on the CPU or between two ranks on one card (gloo
all-reduces and broadcasts CUDA tensors, but has no CUDA all-gather).

The rule the step follows: each rank's loss is its share of the global
loss, so that the shares sum to it (a mean over the global batch of equal
shards is the local mean over P, ``data_share``), and gradients are summed
over the ranks (``psum_flat``). The autograd-aware collectives follow the
same rule in their backward: a value computed from a sum over the ranks
feeds every rank's share, so its gradient is the sum over the ranks of the
upstream gradients.

``COUNTS`` records the calls and bytes each op kind moved (the payload: an
all-reduce's tensor, an all-gather's output), forward and backward, since
its last ``reset``; it takes the place of the JAX package's
``hlo_collective_bytes``, which reads them out of the compiled XLA program.
``data_parallel_shard_map`` and ``psum_model`` have no counterpart yet:
the port has no explicit-SPMD region and no model axis until tensor
parallelism (parallel/tp.py) is ported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import is_distributed, process_count, process_index


class CollectiveCounts:
    """Calls and bytes of the port's collectives by op kind."""

    def __init__(self):
        self.by_op: dict = {}

    def reset(self) -> None:
        self.by_op = {}

    def add(self, op: str, nbytes: int) -> None:
        d = self.by_op.setdefault(op, {"calls": 0, "bytes": 0})
        d["calls"] += 1
        d["bytes"] += int(nbytes)

    def snapshot(self) -> dict:
        return {op: dict(v) for op, v in sorted(self.by_op.items())}


COUNTS = CollectiveCounts()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks in place (no autograd); returns it."""
    COUNTS.add("all_reduce", _nbytes(t))
    dist.all_reduce(t)
    return t


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone())


def psum_data(x: torch.Tensor) -> torch.Tensor:
    """Sum of x over the ranks (the JAX package's psum over ``data``).
    Backward: the upstream gradients summed over the ranks."""
    if not is_distributed():
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _PSum.apply(x)
    return all_reduce_(x.detach().clone())


def pmean_data(x: torch.Tensor) -> torch.Tensor:
    """Mean of x over the ranks. Backward: the upstream gradients summed
    over the ranks, over P (psum_data's rule)."""
    if not is_distributed():
        return x
    return psum_data(x) / process_count()


def data_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a mean over the global batch, from x, the mean
    over its own rows: x / P (the shards are equal). x itself without a
    process group."""
    if not is_distributed():
        return x
    return x / process_count()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: int, tiled: bool):
        ctx.axis, ctx.tiled = axis, tiled
        parts = [torch.empty_like(x) for _ in range(process_count())]
        dist.all_gather(parts, x.contiguous())
        COUNTS.add("all_gather", _nbytes(x) * len(parts))
        return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone())
        r = process_index()
        if ctx.tiled:
            n = g.shape[ctx.axis] // process_count()
            return g.narrow(ctx.axis, r * n, n), None, None
        return g.select(ctx.axis, r), None, None


def all_gather_data(x: torch.Tensor, axis: int = 0,
                    tiled: bool = True) -> torch.Tensor:
    """Every rank's x, concatenated along `axis` in rank order (``tiled``)
    or stacked on a new `axis`. Backward: this rank's slice of the
    upstream gradients summed over the ranks (a reduce-scatter). gloo has
    no all-gather of CUDA tensors."""
    if not is_distributed():
        return x if tiled else x.unsqueeze(axis)
    return _AllGather.apply(x, axis, tiled)


def _ring(x: torch.Tensor, shift: int) -> torch.Tensor:
    n, r = process_count(), process_index()
    out = torch.empty_like(x)
    if shift % n == 0:
        out.copy_(x)
        return out
    ops = [dist.P2POp(dist.isend, x.contiguous(), (r + shift) % n),
           dist.P2POp(dist.irecv, out, (r - shift) % n)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COUNTS.add("ppermute", _nbytes(x))
    return out


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift: int):
        ctx.shift = shift
        return _ring(x, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, -ctx.shift), None


def ppermute_ring(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Rank r's x on rank (r + shift) mod P (the JAX package's ring
    ppermute over ``data``). Backward: the upstream gradient sent back the
    other way, -shift."""
    if not is_distributed():
        return x
    return _Ring.apply(x, shift)


def psum_flat(*groups: list) -> tuple:
    """Each list of tensors summed over the ranks, through one all-reduce
    of one flat buffer per dtype and device (not one call per tensor); the
    lists themselves without a process group."""
    if not is_distributed():
        return groups
    flat = [t for g in groups for t in g]
    out: list = [None] * len(flat)
    buckets: dict = {}
    for i, t in enumerate(flat):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        buf = all_reduce_(torch.cat([flat[i].detach().reshape(-1)
                                     for i in idx]))
        for i, part in zip(idx, buf.split([flat[i].numel() for i in idx])):
            out[i] = part.view_as(flat[i])
    res, k = [], 0
    for g in groups:
        res.append(out[k:k + len(g)])
        k += len(g)
    return tuple(res)


def _leaves(tree, out: list):
    if isinstance(tree, dict):
        return {k: _leaves(tree[k], out) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves(v, out) for v in tree)
    out.append(float(tree))
    return len(out) - 1


def _fill(shape, values):
    if isinstance(shape, dict):
        return {k: _fill(v, values) for k, v in shape.items()}
    if isinstance(shape, (list, tuple)):
        return type(shape)(_fill(v, values) for v in shape)
    return values[shape]


def cross_host_sum(tree):
    """A tree (dicts, lists, tuples) of host numbers summed over the
    processes, as floats (float64, one all-reduce); the tree itself
    without a process group."""
    if not is_distributed():
        return tree
    leaves: list = []
    shape = _leaves(tree, leaves)
    device = ("cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu")
    vec = all_reduce_(torch.tensor(leaves, dtype=torch.float64,
                                   device=device))
    return _fill(shape, vec.cpu().tolist())


def cross_host_mean(tree):
    """A tree of host numbers averaged over the processes (the JAX
    package's cross_host_mean, in float64 where it gathers float32)."""
    if not is_distributed():
        return tree
    p = process_count()
    total = cross_host_sum(tree)
    leaves: list = []
    shape = _leaves(total, leaves)
    return _fill(shape, [v / p for v in leaves])
