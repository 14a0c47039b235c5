"""The process group and this rank's place in it: the port's counterpart of
the JAX package's parallel/mesh.py.

The JAX package trains with one jitted step over a ``data`` mesh axis, the
batch sharded and the state replicated; GSPMD turns every reduction over
the batch axis into a global collective. The port runs one process per card
(launched by torchrun, or by the JAX CLIs' ``--coordinator`` flags), each
with the same modules, and the code that reduces over the batch calls the
collectives of parallel/collectives.py itself: the BatchNorm statistics,
the losses that are not linear in the batch, the gradients. A run of P
processes computes what one process computes at the global batch.

There is no mesh object. ``make_mesh``, ``shard_batch`` and
``replicate_state`` have no torch meaning: their jobs fall to the loader's
shard (data/loader.py's ``num_shards`` and ``shard_index``: each rank
builds only its rows of each global batch) and to identical initialization
on every rank from the seed that rank 0 broadcasts. Without a process group
every function here is the one-process answer and calls no collective.

Tensor parallelism (``train_params.model_parallelism`` = m, parallel/tp.py)
lays the ranks out as ``make_mesh``'s (data, model) device grid: rank r is
(data r // m, model r % m). ``make_grid(m)`` builds the process groups of
that grid, one data group per model index (the ranks that hold the same
channel shard and split the batch) and one model group per data index (the
ranks that read the same rows and split the channels). The data group
carries every reduction over the batch (parallel/collectives.py); with m = 1
it is the whole world and no group is made.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

# seconds a rendezvous or a collective may wait for the other ranks before
# it raises
DEFAULT_TIMEOUT_S = 600


def is_distributed() -> bool:
    """Whether a process group is up (of any size)."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def local_rank() -> int:
    """This process's index among the processes of its host: torchrun's
    LOCAL_RANK, else the rank modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_index() % max(1, torch.cuda.device_count())


def default_backend(device=None) -> str:
    """NCCL for ranks on CUDA cards (one card per rank), gloo for ranks on
    the CPU. Two ranks that share one card need gloo: NCCL refuses two ranks
    on one device, so where a host's ranks (torchrun's
    ``LOCAL_WORLD_SIZE``) outnumber its cards the answer is gloo."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "gloo" if local > torch.cuda.device_count() else "nccl"


def rank_device(device=None):
    """The device this rank runs on: `device` when given, else, in a
    process group on a host with cards, ``cuda:<local rank>`` (modulo the
    cards, where more ranks than cards share them); else None
    (serve.resolve_device: the card)."""
    if device is not None:
        return device
    if is_distributed() and torch.cuda.is_available():
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return None


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group; returns whether there is one.

    With `coordinator` (``host:port`` or a ``tcp://`` URL; the JAX CLIs'
    ``--coordinator``), `num_processes` and `process_id` name the group;
    else torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) does. With neither it is a no-op: one
    process, no group. A group of one (torchrun with one process) is a
    group: the data-parallel code paths and their collectives run.

    `backend` defaults to default_backend(). Under NCCL the rank's card is
    made the current device first. A rendezvous that fails or does not
    complete within `timeout_s` raises: a run never carries on as one
    process."""
    if is_distributed():
        return True
    if coordinator:
        if coordinator == "auto":
            raise ValueError("coordinator 'auto' reads TPU metadata; pass "
                             "host:port, or launch with torchrun")
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and "
                             "--process_id")
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world, rank = int(num_processes), int(process_id)
    elif "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        init = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    backend = backend or default_backend()
    if backend == "nccl":
        os.environ.setdefault("LOCAL_RANK", str(rank % max(
            1, torch.cuda.device_count())))
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend, init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the process group (and its grid), where there is one."""
    global _GRID
    _GRID = None
    if is_distributed():
        dist.destroy_process_group()


@dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, model) grid of make_grid: m model
    ranks per data index, and the two process groups this rank is in."""

    m: int
    data_group: object
    model_group: object


_GRID: Grid | None = None


def make_grid(m: int) -> None:
    """Lay the ranks out as a (world / m, m) grid (the JAX package's
    ``make_mesh(model_parallelism=m)``): rank r is (data r // m, model
    r % m). Raises where m does not divide the world, one process counting
    as a world of one. Every rank creates every group, in the same order
    (torch.distributed's rule); m = 1 makes none (the data group is the
    world)."""
    global _GRID
    world = process_count()
    if m < 1 or world % m:
        raise ValueError(f"{world} processes not divisible by model={m}")
    _GRID = None
    if m == 1:
        return
    rank = process_index()
    mine = {}
    for j in range(m):
        ranks = list(range(j, world, m))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine["data"] = group
    for d in range(world // m):
        ranks = list(range(d * m, (d + 1) * m))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine["model"] = group
    _GRID = Grid(m, mine["data"], mine["model"])


def _grid() -> Grid | None:
    return _GRID if is_distributed() else None


def model_size() -> int:
    """m: the ranks that split each layer's channels (1 without a grid)."""
    grid = _grid()
    return grid.m if grid is not None else 1


def model_index() -> int:
    """This rank's channel shard: rank % m."""
    return process_index() % model_size()


def data_size() -> int:
    """The ranks that split the global batch: world / m."""
    return process_count() // model_size()


def data_index() -> int:
    """This rank's rows of the global batch: rank // m."""
    return process_index() // model_size()


def data_group():
    """The process group of this rank's data ranks (None: the world)."""
    grid = _grid()
    return grid.data_group if grid is not None else None


def model_group():
    """The process group of this rank's model ranks (None without a
    grid)."""
    grid = _grid()
    return grid.model_group if grid is not None else None


def process_local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(local batch size, offset) of this process's rows of each global
    batch, as the loader shards it (DistributedSampler's equal shards over
    the data ranks; the m model ranks of one data index read the same
    rows)."""
    n = data_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n}")
    local = global_batch // n
    return local, data_index() * local


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s `obj` (any picklable host object) on every rank; `obj`
    itself without a process group."""
    if not is_distributed():
        return obj
    from .collectives import COUNTS

    box = [obj]
    dist.broadcast_object_list(box, src=src)
    COUNTS.add("broadcast/world", 0)
    return box[0]


def barrier() -> None:
    """Wait until every rank arrives; nothing without a process group."""
    if is_distributed():
        from .collectives import COUNTS

        COUNTS.add("barrier/world", 0)
        dist.barrier()
