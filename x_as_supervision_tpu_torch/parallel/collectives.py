"""The collectives of the data- and tensor-parallel step over
``torch.distributed``: the port's counterpart of the JAX package's
parallel/collectives.py.

Each is the identity (and calls nothing) without a process group, so a
one-process run computes exactly what it computed before data parallelism
existed. In a group (of any size) they call ``torch.distributed``: NCCL
between cards, gloo on the CPU or between two ranks on one card.

Two groups (parallel/mesh.py's grid): the **data** group, the ranks that
split the global batch and hold the same channel shard, carries every
reduction over the batch (``psum_data``, ``all_reduce_``, ``psum_flat``,
``data_share``, ``cross_host_*``); with model_parallelism 1 it is the whole
world. The **model** group, the ranks that read the same rows and split the
channels, carries tensor parallelism's collectives (``psum_model``,
``copy_to_model``, ``gather_channels``, ``model_slice``,
``broadcast_model_``); without a grid each of those is the identity.

The rule the step follows: each rank's loss is its share of the global
loss, so that the shares sum to it (a mean over the global batch of equal
shards is the local mean over the data ranks, ``data_share``), and
gradients are summed over the data ranks (``psum_flat``). The
autograd-aware collectives follow the same rule in their backward: a value
computed from a sum over the ranks feeds every rank's share, so its
gradient is the sum over the ranks of the upstream gradients. Tensor
parallelism is Megatron's column-parallel pair: a sharded layer's input
passes ``copy_to_model`` (identity; backward the sum of the model ranks'
partial input gradients) and its output channel shard ``gather_channels``
(all-gather; backward this rank's slice, since every model rank computes
the same downstream).

``COUNTS`` records the calls and bytes each op kind moved, by group
(``all_reduce/data``, ``all_gather/model``, ...; the payload: an
all-reduce's tensor, an all-gather's output), forward and backward, since
its last ``reset``; it takes the place of the JAX package's
``hlo_collective_bytes``, which reads them out of the compiled XLA program.
``data_parallel_shard_map`` has no counterpart: its one JAX caller,
tools/scaling_projection.py, is not ported.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import mesh
from .mesh import data_index, data_size, is_distributed


class CollectiveCounts:
    """Calls and bytes of the port's collectives by op kind and group."""

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


def _group(name: str):
    return {"data": mesh.data_group, "model": mesh.model_group}[name]()


def _size(name: str) -> int:
    return data_size() if name == "data" else mesh.model_size()


def _index(name: str) -> int:
    return data_index() if name == "data" else mesh.model_index()


def all_reduce_(t: torch.Tensor, group: str = "data") -> torch.Tensor:
    """Sum `t` over the ranks of `group` ("data" or "model") in place (no
    autograd); returns it."""
    COUNTS.add(f"all_reduce/{group}", _nbytes(t))
    dist.all_reduce(t, group=_group(group))
    return t


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t in dense memory (its channels-last strides kept), for a collective
    that works in place."""
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return t
    return t.contiguous()


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: str):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(_dense(g).clone(), ctx.group), None


def _psum(x: torch.Tensor, group: str) -> torch.Tensor:
    if x.requires_grad and torch.is_grad_enabled():
        return _PSum.apply(x, group)
    return all_reduce_(x.detach().clone(), group)


def psum_data(x: torch.Tensor) -> torch.Tensor:
    """Sum of x over the data ranks (the JAX package's psum over
    ``data``). Backward: the upstream gradients summed over them."""
    if not is_distributed():
        return x
    return _psum(x, "data")


def pmean_data(x: torch.Tensor) -> torch.Tensor:
    """Mean of x over the data ranks. Backward: the upstream gradients
    summed over them, over their number (psum_data's rule)."""
    if not is_distributed():
        return x
    return psum_data(x) / data_size()


def psum_model(x: torch.Tensor) -> torch.Tensor:
    """Sum of x over the model ranks (the JAX package's psum over
    ``model``); x itself without a grid. Backward: the upstream gradients
    summed over them."""
    if mesh.model_size() == 1:
        return x
    return _psum(x, "model")


def data_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a mean over the global batch, from x, the mean
    over its own rows: x / (data ranks) (the shards are equal). x itself
    without a process group."""
    if not is_distributed():
        return x
    return x / data_size()


def _gather_cat(x: torch.Tensor, dim: int, group: str) -> torch.Tensor:
    """Every rank of `group`'s x concatenated along `dim` in rank order, a
    new tensor (not a view) in x's memory format. A channels-last 4-D x
    is moved as its NHWC view (no copy before the collective). gloo
    all-gathers CUDA tensors in some versions of torch and not in others,
    so between two ranks on one card the parts are summed into a zeroed
    whole instead (each entry has one part that is not zero, so the sum
    is exact; counted as the all-gather it stands for)."""
    n, r = _size(group), _index(group)
    nhwc = (x.dim() == 4 and dim == 1 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))
    fmt = torch.channels_last if nhwc else torch.contiguous_format
    comm, cdim = (x.permute(0, 2, 3, 1), 3) if nhwc else (x.contiguous(), dim)
    shape = list(x.shape)
    shape[dim] *= n
    if x.is_cuda and dist.get_backend(_group(group)) == "gloo":
        out = x.new_zeros(shape).contiguous(memory_format=fmt)
        whole = out.permute(0, 2, 3, 1) if nhwc else out
        whole.narrow(cdim, r * comm.shape[cdim], comm.shape[cdim]).copy_(comm)
        COUNTS.add(f"all_gather/{group}", _nbytes(out))
        dist.all_reduce(whole, group=_group(group))
        return out
    parts = [torch.empty_like(comm) for _ in range(n)]
    dist.all_gather(parts, comm, group=_group(group))
    COUNTS.add(f"all_gather/{group}", _nbytes(x) * n)
    if not nhwc:
        return torch.cat(parts, dim)
    out = x.new_empty(shape).contiguous(memory_format=fmt)
    torch.cat(parts, cdim, out=out.permute(0, 2, 3, 1))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: int, tiled: bool):
        ctx.axis, ctx.tiled = axis, tiled
        if tiled:
            return _gather_cat(x, axis, "data")
        return _gather_cat(x.unsqueeze(axis), axis, "data")

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone())
        r = data_index()
        if ctx.tiled:
            n = g.shape[ctx.axis] // data_size()
            return g.narrow(ctx.axis, r * n, n), None, None
        return g.select(ctx.axis, r), None, None


def all_gather_data(x: torch.Tensor, axis: int = 0,
                    tiled: bool = True) -> torch.Tensor:
    """Every data rank's x, concatenated along `axis` in rank order
    (``tiled``) or stacked on a new `axis`. Backward: this rank's slice of
    the upstream gradients summed over the data ranks (a
    reduce-scatter)."""
    if not is_distributed():
        return x if tiled else x.unsqueeze(axis)
    return _AllGather.apply(x, axis, tiled)


def _ring(x: torch.Tensor, shift: int) -> torch.Tensor:
    n, r, m = data_size(), data_index(), mesh.model_size()
    out = torch.empty_like(x)
    if shift % n == 0:
        out.copy_(x)
        return out
    # the data ranks of this rank's model index, by global rank
    peer = lambda d: (d % n) * m + mesh.model_index()  # noqa: E731
    ops = [dist.P2POp(dist.isend, x.contiguous(), peer(r + shift)),
           dist.P2POp(dist.irecv, out, peer(r - shift))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COUNTS.add("ppermute/data", _nbytes(x))
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
    """Data rank r's x on data rank (r + shift) mod P (the JAX package's
    ring ppermute over ``data``). Backward: the upstream gradient sent back
    the other way, -shift."""
    if not is_distributed():
        return x
    return _Ring.apply(x, shift)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(_dense(g).clone(), "model")


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: x, the input of a layer whose output channels are
    split over the model ranks. Backward: each model rank's input gradient
    comes from its own channels only, so they are summed over the model
    ranks. x itself without a grid."""
    if mesh.model_size() == 1 or not (x.requires_grad
                                      and torch.is_grad_enabled()):
        return x
    return _CopyToModel.apply(x)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return _gather_cat(x, dim, "model")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, mesh.model_index() * ctx.n, ctx.n), None


def gather_channels(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Megatron's g: the model ranks' channel shards of x concatenated
    along `dim`, the whole tensor on every model rank. Backward: this
    rank's slice of the upstream gradient (every model rank computes the
    same downstream, so nothing is summed). x itself without a grid."""
    if mesh.model_size() == 1:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherChannels.apply(x, dim)
    return _gather_cat(x.detach(), dim, "model")


class _ModelSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int):
        n = x.shape[dim] // mesh.model_size()
        ctx.dim, ctx.shape, ctx.n = dim, x.shape, n
        return x.narrow(dim, mesh.model_index() * n, n)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, mesh.model_index() * ctx.n, ctx.n).copy_(g)
        return all_reduce_(full, "model"), None


def model_slice(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This model rank's slice of x (the whole on every model rank) along
    `dim`: a replicated bias of a layer whose output channels are split.
    Backward: the slices' gradients put together over the model ranks, the
    whole gradient on every rank. x itself without a grid."""
    if mesh.model_size() == 1:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _ModelSlice.apply(x, dim)
    n = x.shape[dim] // mesh.model_size()
    return x.narrow(dim, mesh.model_index() * n, n)


def broadcast_model_(t: torch.Tensor) -> torch.Tensor:
    """Model rank 0's t on every model rank, in place; nothing without a
    grid. The replicated state's guard: model ranks compute their
    replicated values alike, but not bit for bit where a kernel adds in a
    run-dependent order."""
    if mesh.model_size() > 1:
        COUNTS.add("broadcast/model", _nbytes(t))
        dist.broadcast(t, src=mesh.data_index() * mesh.model_size(),
                       group=mesh.model_group())
    return t


def psum_flat(*groups: list) -> tuple:
    """Each list of tensors summed over the data ranks, through one
    all-reduce of one flat buffer per dtype and device (not one call per
    tensor); the lists themselves without a process group."""
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
    """A tree (dicts, lists, tuples) of host numbers summed over the data
    ranks, as floats (float64, one all-reduce); the tree itself without a
    process group."""
    if not is_distributed():
        return tree
    leaves: list = []
    shape = _leaves(tree, leaves)
    device = ("cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu")
    vec = all_reduce_(torch.tensor(leaves, dtype=torch.float64,
                                   device=device))
    return _fill(shape, vec.cpu().tolist())


def cross_host_mean(tree):
    """A tree of host numbers averaged over the data ranks (the JAX
    package's cross_host_mean, in float64 where it gathers float32)."""
    if not is_distributed():
        return tree
    p = data_size()
    total = cross_host_sum(tree)
    leaves: list = []
    shape = _leaves(total, leaves)
    return _fill(shape, [v / p for v in leaves])
