"""Process groups for data-parallel and point-sharded training.

Port of ``mmdet3d_gaussian_tpu/parallel/mesh.py``.  The JAX package shards
the global batch over a ``Mesh(('data',))`` and lets GSPMD make every
reduction global; the port runs one process a card (``torchrun``), each on
its contiguous rows of the global batch, and makes the same reductions
global with explicit collectives: the BatchNorm sums, the loss normalizers,
the logged losses and the gradients.  Data parallel uses only
``all_reduce`` and ``broadcast``, which gloo also takes on CUDA tensors, so
the same code runs under NCCL (one rank a card) and under gloo (the CPU
tests, or two ranks on one card, which NCCL refuses).  A failed collective
raises.

Point sharding (:func:`init_mesh`, JAX's ``Mesh(('data', 'points'))``)
splits the world into a data group and a points group a rank, rank =
d P + p; every collective names the group it runs over (a
:class:`Group`'s ``pg``; None is the world).  The sparse pillar merge adds
``all_to_all_single`` and ``all_gather`` (:func:`all_to_all`,
:func:`all_gather_replicated`).
"""
from __future__ import annotations

import datetime
import os
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist
from torch import nn


class Group(NamedTuple):
    """This process's place in a group of ranks: its rank in the group, the
    number of ranks, its device and the ``torch.distributed`` process group
    (None: the default group, every rank of the job)."""
    rank: int
    world: int
    device: torch.device
    pg: Any = None

    def first(self) -> int:
        """The global rank of the group's rank 0."""
        return 0 if self.pg is None else dist.get_global_rank(self.pg, 0)


class PointMesh(NamedTuple):
    """A ``(data, points)`` grid of ranks (JAX's ``Mesh(devices.reshape(
    data, points), ('data', 'points'))``): this rank's data group (the
    ranks that hold the same point slice of other samples), its points
    group (the ranks that hold slices of the same samples) and the world."""
    data: Group
    points: Group
    world: Group


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     device: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout: Optional[datetime.timedelta] = None) -> Group:
    """Join the job and return its :class:`Group`.

    Rank, world size and local rank come from the arguments or else from
    torchrun's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; the rendezvous
    is ``init_method`` (a ``file://`` store, say) or else torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``).  The device is
    ``cuda:LOCAL_RANK`` unless ``device='cpu'``; the backend NCCL on a card
    and gloo on the CPU unless ``backend`` names one.  A process that has
    joined a job already gets that job's group."""
    local = int(os.environ.get('LOCAL_RANK', 0))
    if device is not None and torch.device(device).type == 'cpu':
        dev = torch.device('cpu')
    else:
        if not torch.cuda.is_available():
            raise RuntimeError('CUDA is not available; pass device="cpu" to '
                               'train on the CPU')
        dev = torch.device('cuda', local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        rank = int(os.environ['RANK']) if rank is None else rank
        world_size = (int(os.environ['WORLD_SIZE']) if world_size is None
                      else world_size)
        backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
        kw = {} if timeout is None else dict(timeout=timeout)
        dist.init_process_group(backend, init_method=init_method or 'env://',
                                rank=rank, world_size=world_size, **kw)
    return Group(dist.get_rank(), dist.get_world_size(), dev)


def init_mesh(data: int, points: int, world: Group) -> PointMesh:
    """Split the job ``world`` (from :func:`init_distributed`) into a
    ``data`` x ``points`` grid, rank = d ``points`` + p: a points group is
    ``points`` consecutive ranks, as JAX's ``reshape(data, points)`` of
    the device list.  Every rank builds every group, in the same order
    (``new_group`` is collective)."""
    if data * points != world.world:
        raise ValueError(f'a {data} x {points} grid needs {data * points} '
                         f'ranks, the job has {world.world}')
    d, p = divmod(world.rank, points)
    data_pg = points_pg = None
    for q in range(points):
        pg = dist.new_group([e * points + q for e in range(data)])
        if q == p:
            data_pg = pg
    for e in range(data):
        pg = dist.new_group([e * points + q for q in range(points)])
        if e == d:
            points_pg = pg
    return PointMesh(Group(d, data, world.device, data_pg),
                     Group(p, points, world.device, points_pg), world)


def shard_points(batch: Dict[str, Any], mesh: PointMesh) -> Dict[str, Any]:
    """This rank's part of a global batch, JAX's ``P('data', 'points')``:
    the data rank's contiguous samples (:func:`shard_batch`), and of
    ``points`` and ``points_mask`` the points rank's contiguous slice
    ``[p N / P, (p + 1) N / P)`` of the point axis; the other entries
    (ground truth) keep ``P('data')``."""
    out = shard_batch(batch, mesh.data)
    p, n_ranks = mesh.points.rank, mesh.points.world
    for k in ('points', 'points_mask'):
        n = out[k].shape[1]
        if n % n_ranks:
            raise ValueError(f'{k}: {n} points do not split over {n_ranks} '
                             f'points ranks')
        m = n // n_ranks
        out[k] = out[k][:, p * m:(p + 1) * m]
    return out


def all_reduce_sum(tensors: Sequence[torch.Tensor], group: Group
                   ) -> List[torch.Tensor]:
    """The sums over ``group``'s ranks of ``tensors`` (any shapes, on the
    group's device), by one ``all_reduce`` of a flat f32 buffer that holds
    them all; -> new f32 tensors of their shapes (contiguous)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group.pg)
    out, pos = [], 0
    for t in tensors:
        out.append(flat[pos:pos + t.numel()].view(t.shape))
        pos += t.numel()
    return out


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum over the ranks of the
    output's gradients: each rank's input feeds every rank's output, and
    each rank's output feeds a loss of its own (a BatchNorm's sums)."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        y = x.detach().clone()
        dist.all_reduce(y, group=pg)
        return y

    @staticmethod
    def backward(ctx, gy):
        g = gy.detach().clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


def all_reduce_with_grad(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable."""
    return _AllReduce.apply(x, group.pg)


class _AllReduceReplicated(_AllReduce):
    """Sum over the ranks whose consumers are replicas: every rank of the
    group computes the same function of the sum (the point-sharded trunk
    on the merged canvas), so each rank's output gradient is already the
    whole gradient of the one loss, and the backward passes it through.
    :class:`_AllReduce`'s backward would sum those copies and count the
    loss once a rank, multiplying the inputs' gradients by the group's
    size."""

    @staticmethod
    def backward(ctx, gy):
        return gy, None


def all_reduce_replicated(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable, for
    consumers that every rank of the group runs alike
    (:class:`_AllReduceReplicated`)."""
    return _AllReduceReplicated.apply(x, group.pg)


def all_reduce_max(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``'s ranks (no
    gradient)."""
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group.pg)
    return y


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` in equal blocks of dim 0: block q of this
    rank's input goes to rank q, which puts it at block r (this rank) of
    its output.  The transpose is the same exchange of the output's
    gradient."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        y = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(y, x.contiguous(), group=pg)
        return y

    @staticmethod
    def backward(ctx, gy):
        g = torch.empty_like(gy, memory_format=torch.contiguous_format)
        dist.all_to_all_single(g, gy.contiguous(), group=ctx.pg)
        return g, None


def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """(R, ...) -> (R, ...): block q of ``x`` to rank q, block q of the
    result from rank q (JAX's ``all_to_all(split_axis=0, concat_axis=0,
    tiled=False)``); differentiable; integer tensors travel as they
    are."""
    if x.shape[0] != group.world:
        raise ValueError(f'all_to_all: {x.shape[0]} blocks for '
                         f'{group.world} ranks')
    return _AllToAll.apply(x, group.pg)


class _AllGatherReplicated(torch.autograd.Function):
    """Every rank's tile concatenated on ``dim`` in rank order.  Its
    transpose sums each rank's gradient of tile q onto rank q (a reduce
    scatter); here every rank of the group consumes the gathered tensor
    alike (the replicated canvas), so each rank's gradient is already the
    whole one and this rank's tile of it is its input's gradient, as
    :class:`_AllReduceReplicated` passes its gradient through."""

    @staticmethod
    def forward(ctx, x, dim, pg, world, rank):
        ctx.dim, ctx.rank, ctx.world = dim, rank, world
        x = x.contiguous()
        tiles = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(tiles, x, group=pg)
        return torch.cat(tiles, dim)

    @staticmethod
    def backward(ctx, gy):
        n = gy.shape[ctx.dim] // ctx.world
        return (gy.narrow(ctx.dim, ctx.rank * n, n), None, None, None,
                None)


def all_gather_replicated(x: torch.Tensor, group: Group, dim: int = 0
                          ) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim`` in rank order (JAX's tiled
    ``all_gather``), differentiable for consumers that every rank of the
    group runs alike (:class:`_AllGatherReplicated`)."""
    return _AllGatherReplicated.apply(x, dim, group.pg, group.world,
                                      group.rank)


def shard_batch(batch: Dict[str, Any], group: Group) -> Dict[str, Any]:
    """This rank's contiguous rows ``[r B / R, (r + 1) B / R)`` of every
    entry of a global batch of B samples (JAX's ``P('data')`` split)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % group.world:
            raise ValueError(f'{k}: a batch of {b} does not split over '
                             f'{group.world} ranks')
        n = b // group.world
        out[k] = v[group.rank * n:(group.rank + 1) * n]
    return out


def replicate(module: nn.Module, group: Group) -> None:
    """Broadcast the group's rank 0's parameters and buffers to every rank
    of ``group``, one ``broadcast`` a dtype."""
    by_type: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_type.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for tensors in by_type.values():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.broadcast(flat, group.first(), group=group.pg)
            pos = 0
            for t in tensors:
                t.copy_(flat[pos:pos + t.numel()].view(t.shape))
                pos += t.numel()


def rank_offset(count: torch.Tensor, group: Group
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's place in the global order of a batch-wide count: ->
    (the sum of ``count`` over the ranks before this one, the sum over all
    ranks), 0-d int64 tensors on ``count``'s device, by one ``all_reduce``
    of a world-length int64 vector that holds ``count`` at this rank's
    index (exact; nothing is read back to the host).

    Ranks hold contiguous samples (:func:`shard_batch`) and the voxel and
    site keys sort with the batch index first, so the global key order is
    rank order: a rank's live ids ``i`` are the global ids ``before +
    i``."""
    vec = torch.zeros(group.world, dtype=torch.int64, device=count.device)
    vec[group.rank] = count.reshape(()).to(torch.int64)
    dist.all_reduce(vec, group=group.pg)
    return vec[:group.rank].sum(), vec.sum()


def barrier(group: Group) -> None:
    """Wait until every rank of ``group`` is here (an ``all_reduce`` of
    one value, read back)."""
    t = torch.zeros(1, device=group.device)
    dist.all_reduce(t, group=group.pg)
    t.item()


def sync_batchnorms(module: nn.Module, group: Optional[Group]) -> None:
    """Make every BatchNorm of ``module`` (``BatchNorm2d`` and
    ``MaskedBatchNorm``) take its training statistics over ``group``'s
    ranks (None: this rank's rows alone), and hand ``group`` to every
    submodule whose capacity belongs to the global batch (one that sets
    ``global_capacity``: the voxelizing trunks and the sparse encoder)."""
    from ..models.backbones import BatchNorm2d
    from ..models.voxel_encoders import MaskedBatchNorm
    for m in module.modules():
        if isinstance(m, (BatchNorm2d, MaskedBatchNorm)) \
                or getattr(m, 'global_capacity', False):
            m.group = group


def world_of(group: Optional[Group]) -> int:
    """The number of ranks that share a global batch (1 without a
    group)."""
    return 1 if group is None else group.world
