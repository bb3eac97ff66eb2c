"""Device groups and the sharded Gaussian state for multi-GPU training —
port of ``gs_tpu/parallel/mesh.py``.

The Gaussians (the capacity axis of every per-Gaussian tensor of a
``TrainState``: parameters, Adam moments, densification statistics, the
alive mask) are split into k equal shards, shard d holding rows
[d C/k, (d+1) C/k), as the JAX package shards them on its ``gauss`` mesh
axis; cameras, images and the exposure stay replicated. A group is the
set of shards and the collectives between them. Each process holds its
*local* shards, concatenated in shard order, as one ``TrainState``:

* :class:`ProcessGroup`, one shard per process over ``torch.distributed``
  (NCCL between CUDA devices, gloo between CPU processes): what the train
  CLI builds for ``--mesh N`` and ``--multihost``;
* :class:`LocalGroup`, all k shards in one process, where a collective is
  a concatenation or a sum over a list: what the tests and
  ``chip_smoke.py`` use to run the k-shard computation on one device (the
  role the JAX tests give ``xla_force_host_platform_device_count``).

``parallel/render_mc.py`` is written once against both: its phases loop
over the local shards and meet at the collectives below.

Every collective of the training step enqueues on the current stream and
reads nothing back to the host, so a CUDA graph can capture it
(``train/graph.py``): on NCCL the gathers are ``all_gather_into_tensor``
into one preallocated tensor and the packet gather's backward is
``reduce_scatter_tensor``. A group's captures use its
``capture_error_mode``: a "global" capture forbids unsafe CUDA calls in
every thread of the process, NCCL's watchdog thread among them, which
queries the events of earlier collectives; "thread_local" forbids them in
the capturing thread only. Captured and eager collectives (densify's
gathers, ``num_alive``, the banded evaluation) share one communicator,
which NCCL allows (``NCCL_GRAPH_MIXING_SUPPORT``, on by default); every
eager collective between blocks follows the last replay on the same
stream. NCCL destroys a communicator only after every graph that captured
its collectives is gone, so a ``ProcessGroup`` ends with :meth:`close`.

A ``models/packed_state.py::PackedState`` shards the same way: its [R, C]
blocks (parameters and Adam moments) split on their column axis, every
[C] tensor on its only axis (``gs_tpu/parallel/mesh.py:40-63``), so a
process's shards sit side by side in its blocks' columns.
"""
from __future__ import annotations

import os
import weakref

import torch

from ..models.gaussian_model import TrainState, grow_capacity
from ..models.packed_state import PackedState, grow_capacity_packed

# the TrainState fields with a capacity axis; the rest are replicated
SHARDED_FIELDS = ("params", "alive", "m", "v", "grad_accum", "denom",
                  "max_radii2D")
# the PackedState fields whose capacity axis is their columns
PACKED_BLOCKS = ("packed", "m", "v")


class LocalGroup:
    """k shards in one process on ``device``."""

    capture_error_mode = "global"

    def __init__(self, k: int, device="cuda"):
        if k < 1:
            raise ValueError(f"a group needs at least one shard, got {k}")
        self.size = k
        self.rank = 0
        self.local = list(range(k))
        self.device = torch.device(device)

    @property
    def is_main(self) -> bool:
        return True

    def gather(self, xs):
        """The k shards' tensors, concatenated on dim 0 in shard order:
        the all-gather of the packets. Autograd hands each shard its rows
        of the gradient, summed over every band that read them."""
        return torch.cat(list(xs))

    def gather_bands(self, xs):
        """The k bands' tensors stacked on a new dim 0: the all-gather of
        the rendered bands."""
        return torch.stack(list(xs))

    def gather_values(self, xs):
        """Like :meth:`gather_bands`, outside autograd (statistics)."""
        return torch.stack([x.detach() for x in xs])

    def sum(self, xs):
        """The sum over shards of each local shard's tensor, replicated,
        outside autograd."""
        return torch.stack([x.detach() for x in xs]).sum(0)

    def every(self, flag: bool) -> bool:
        """Whether ``flag`` holds in every process of the group."""
        return bool(flag)


def _all_gather(x, group):
    """The group's ``x`` concatenated on dim 0, in rank order, into one
    new tensor (one ``all_gather_into_tensor``: capturable on NCCL)."""
    import torch.distributed as dist
    x = x.contiguous()
    out = x.new_empty((group.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x)
    return out


class _GatherSum(torch.autograd.Function):
    """all_gather on dim 0. Its backward hands each rank the sum over ranks
    of the gradient of its own rows: each rank's band read every packet,
    and the owner of a packet gets the sum of their contributions
    (reduce-scatter on NCCL; all-reduce and slice on gloo)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        group = ctx.group
        g = g.contiguous()
        if group.backend == "nccl":
            out = g.new_empty((g.shape[0] // group.size,) + tuple(g.shape[1:]))
            dist.reduce_scatter_tensor(out, g)
        else:
            total = g.clone()
            dist.all_reduce(total)
            out = total.chunk(group.size)[group.rank].contiguous()
        return out, None


class _GatherOwn(torch.autograd.Function):
    """all_gather stacked on a new dim 0. Every rank computes the same loss
    from the same gathered image, so each rank's cotangent of the whole
    frame is already the full one: the backward hands a rank the slice of
    its own band, with no collective (a sum over ranks would be k times
    too large)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x.unsqueeze(0), group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.group.rank].contiguous(), None


class ProcessGroup:
    """One shard per process of the initialised ``torch.distributed`` group
    (its world size and rank), on ``device``. End it with :meth:`close`."""

    capture_error_mode = "thread_local"

    def __init__(self, device):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroup needs torch.distributed "
                               "initialised (parallel/mesh.py::init_from_env)")
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.local = [self.rank]
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        # the step graphs (train/graph.py) that captured this group's
        # collectives, released by ``close``
        self.graphs = weakref.WeakSet()

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def gather(self, xs):
        (x,) = xs
        return _GatherSum.apply(x, self)

    def gather_bands(self, xs):
        (x,) = xs
        return _GatherOwn.apply(x, self)

    def gather_values(self, xs):
        (x,) = xs
        return _all_gather(x.detach().unsqueeze(0), self)

    def sum(self, xs):
        import torch.distributed as dist
        (x,) = xs
        total = x.detach().contiguous().clone()
        dist.all_reduce(total)
        return total

    def every(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank (an eager collective: every
        rank calls it)."""
        import torch.distributed as dist
        t = torch.tensor([0 if flag else 1], dtype=torch.int32,
                         device=self.device)
        dist.all_reduce(t)
        return int(t) == 0

    def barrier(self):
        import torch.distributed as dist
        dist.barrier()

    def close(self):
        """Destroy the ``torch.distributed`` group. NCCL destroys a
        communicator only once every CUDA graph that captured one of its
        collectives is gone, and waits for that (forever, if a graph is
        kept alive): the graphs in ``graphs`` are released first."""
        import torch.distributed as dist
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for g in list(self.graphs):
            g.release()
        dist.destroy_process_group()


def init_from_env(device_type: str) -> ProcessGroup:
    """Initialise ``torch.distributed`` from the environment and return the
    group: the JAX package's ``GS_TPU_COORD`` (host:port of rank 0),
    ``GS_TPU_NPROCS`` and ``GS_TPU_PROCID`` (``gs_tpu/apps/train.py:105-
    118``), or a launcher's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
    ``RANK`` (torchrun, or the train CLI's own ``--mesh N`` spawn). NCCL for
    ``cuda`` (device ``LOCAL_RANK``, else rank mod the visible cards),
    gloo for ``cpu``. Raises when the environment names no group or the
    group cannot form."""
    import torch.distributed as dist
    env = os.environ
    if env.get("GS_TPU_COORD"):
        missing = [v for v in ("GS_TPU_NPROCS", "GS_TPU_PROCID")
                   if v not in env]
        if missing:
            raise ValueError(f"GS_TPU_COORD is set but {missing} are not")
        url = f"tcp://{env['GS_TPU_COORD']}"
        world, rank = int(env["GS_TPU_NPROCS"]), int(env["GS_TPU_PROCID"])
    elif all(v in env for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                                "RANK")):
        url = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        raise ValueError(
            "--multihost needs its environment: GS_TPU_COORD (host:port), "
            "GS_TPU_NPROCS and GS_TPU_PROCID, or a launcher's MASTER_ADDR, "
            "MASTER_PORT, WORLD_SIZE and RANK")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda group needs a CUDA device")
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        device, backend = torch.device("cuda", local), "nccl"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"no process group on {device_type!r}")
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank)
    # every rank meets once here, so a rank that cannot join fails now
    dist.all_reduce(torch.zeros(1, device=device))
    return ProcessGroup(device)


def _check_capacity(capacity: int, k: int):
    if capacity % k:
        raise ValueError(f"capacity {capacity} not divisible by the group's "
                         f"{k} shards")


def padded_capacity(capacity: int, k: int) -> int:
    """The smallest multiple of k at or above ``capacity``."""
    return -(-capacity // k) * k


def pad_state(state, k: int):
    """``state`` (a TrainState or a PackedState) grown (dead slots at the
    end) to a capacity that k shards split evenly, as
    ``gs_tpu/train/loop.py:138-146``."""
    cap = padded_capacity(state.capacity, k)
    if cap == state.capacity:
        return state
    grow = (grow_capacity_packed if isinstance(state, PackedState)
            else grow_capacity)
    return grow(state, cap)


def _map_sharded(fn, state):
    """``fn(x, axis)`` on every tensor of ``state`` with a capacity axis
    (``axis``: 1 for a packed block, else 0); the rest as they are."""
    packed = isinstance(state, PackedState)
    out = {}
    for name in state._fields:
        x = getattr(state, name)
        if packed and name in PACKED_BLOCKS:
            x = fn(x, 1)
        elif name in SHARDED_FIELDS:
            x = (type(x)(*[fn(t, 0) for t in x])
                 if not packed and name in ("params", "m", "v")
                 else fn(x, 0))
        out[name] = x
    return type(state)(**out)


def shard_state(state, group):
    """The whole (replicated) ``state`` -> this process's local shards,
    concatenated: the slots of shards ``group.local``. The capacity must
    divide into the group's shards."""
    _check_capacity(state.capacity, group.size)
    if len(group.local) == group.size:
        return state
    n = state.capacity // group.size
    idx = torch.cat([torch.arange(d * n, (d + 1) * n) for d in group.local])

    def take(x, axis):
        return x.index_select(axis, idx.to(x.device)).contiguous()

    return _map_sharded(take, state)


def gather_state(state, group):
    """This process's local shards -> the whole state, on every process
    (every process of the group must call it)."""
    if len(group.local) == group.size:
        return state

    def gather(x, axis):
        y = x.to(torch.uint8) if x.dtype == torch.bool else x
        y = group.gather_values([y])                 # [k, *local shape]
        if axis:
            y = y.permute(1, 0, 2)                   # [R, k, n]
        y = y.reshape(x.shape[:axis] + (-1,) + x.shape[axis + 1:])
        return y.to(x.dtype)

    return _map_sharded(gather, state)
