"""Data parallelism over torch.distributed: rays sharded, parameters
replicated.

The JAX package's data parallelism is one process over a device mesh: the
batch is placed with a sharding and jit partitions the step, the gradient
all-reduce implicit.  The port's is multi-process, one process a card,
launched with `python -m torch.distributed.run --nproc_per_node N -m
sanerf_hq_tpu_torch ...`: every rank holds the whole field, takes its
contiguous slice of each batch array that the JAX rule shards, and the
steps all-reduce the gradients before Adam (train/steps.py), so that every
rank holds the same parameters and Adam state.  A `Mesh` here names the
process group's layout; it holds no devices.  NCCL on the card, gloo on the
CPU; nothing falls back from one to the other.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_main_process() -> bool:
    return rank() == 0


def barrier():
    if is_distributed():
        dist.barrier()


def init_process_group_from_env(device: torch.device) -> torch.device:
    """Join the process group that `torch.distributed.run` describes
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this
    rank's device: `cuda:{LOCAL_RANK}` over NCCL on the card, the CPU over
    gloo.  Without WORLD_SIZE in the environment the device is returned as
    given; with a group already joined, this rank's device."""
    if "WORLD_SIZE" not in os.environ:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if is_distributed():
        return device
    world, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if device.type == "cuda":
        dist.init_process_group("nccl", rank=rank_, world_size=world,
                                device_id=device)
    else:
        dist.init_process_group("gloo", rank=rank_, world_size=world)
    return device


class Mesh(NamedTuple):
    """The layout of the process group: `shape[axis]` ranks along each
    axis, this process at `coords[axis]`."""
    shape: dict
    coords: dict


class Sharding(NamedTuple):
    mesh: Mesh
    axis: Optional[str]  # None: replicated


def make_mesh(shape: Sequence[int] = (-1,),
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """The mesh over every rank of the process group (one rank without
    one); -1 in shape takes the ranks the other axes leave, as in JAX
    make_mesh.  The collectives run over the whole group, so the first
    (data) axis must span it: other axes have size 1."""
    n = world_size()
    shape = list(shape)
    known = int(np.prod([s for s in shape if s > 0]))
    shape = [n // known if s == -1 else s for s in shape]
    if shape[0] != n or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)}: its first axis must "
                         f"hold all {n} ranks of the process group")
    coords = np.unravel_index(rank(), shape)
    return Mesh(dict(zip(axis_names, shape)),
                {a: int(c) for a, c in zip(axis_names, coords)})


def data_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Shard the leading (ray) dimension over `axis`."""
    return Sharding(mesh, axis)


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_slice(sharding: Sharding, n: int) -> Optional[slice]:
    """This rank's rows of an array with leading dim n under the JAX rule
    (n > 1 and divisible by the axis size), or None: the array stays
    whole."""
    if sharding is None or sharding.axis is None:
        return None
    w = sharding.mesh.shape[sharding.axis]
    if n <= 1 or n % w:
        return None
    k = n // w
    r = sharding.mesh.coords[sharding.axis]
    return slice(r * k, (r + 1) * k)


def shard_rays(mesh: Mesh, batch: dict, axis: str = "data") -> dict:
    """A batch's arrays placed as JAX's shard_rays places them: an array
    whose leading dim is > 1 and divisible by the axis size gives this
    rank its contiguous slice; scalars and indivisible arrays stay whole."""
    sh = data_sharding(mesh, axis)

    def put(x):
        if getattr(x, "ndim", 0) < 1:
            return x
        sl = shard_slice(sh, x.shape[0])
        return x if sl is None else x[sl]

    return {k: put(v) for k, v in batch.items()}


@torch.no_grad()
def broadcast_params(model: torch.nn.Module):
    """Rank 0's parameters and buffers to every rank (no-op without a
    process group)."""
    if not is_distributed():
        return
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=0)


class _GatherRays(torch.autograd.Function):
    """All-gather of per-ray outputs on the ray axis.  Every rank computes
    the same loss of the gathered tensor, so its gradient there is the
    same on every rank; backward keeps this rank's rows, times the world
    size, so that the gradients' mean over ranks is the unsharded
    gradient."""

    @staticmethod
    def forward(ctx, x, world: int, r: int):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        ctx.rows, ctx.world, ctx.r = x.shape[0], world, r
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        n = ctx.rows
        return g[ctx.r * n:(ctx.r + 1) * n] * ctx.world, None, None


def gather_rays(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The rows of every rank along `sharding`'s axis, in rank order;
    differentiable (see _GatherRays)."""
    return _GatherRays.apply(x, sharding.mesh.shape[sharding.axis],
                             sharding.mesh.coords[sharding.axis])


def allreduce_grads(params):
    """Replace each parameter's .grad by its mean over the ranks: one SUM
    all-reduce of the grads flattened in parameter order, then / world
    (gloo has no AVG).  Parameters without a grad are skipped; every rank
    runs the same graph, so the set is the same on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world_size()
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def allreduce_mean(values: dict) -> dict:
    """{name: scalar tensor} averaged over the ranks in one all-reduce."""
    keys = sorted(values)
    v = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(v)
    v /= world_size()
    return dict(zip(keys, v.unbind()))
