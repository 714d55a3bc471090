"""Process groups for data-parallel training.

Port of ``mmdet3d_gaussian_tpu/parallel/mesh.py``.  The JAX package shards
the global batch over a ``Mesh(('data',))`` and lets GSPMD make every
reduction global; the port runs one process a card (``torchrun``), each on
its contiguous rows of the global batch, and makes the same reductions
global with explicit collectives: the BatchNorm sums, the loss normalizers,
the logged losses and the gradients.  It uses only ``all_reduce`` (sum)
and ``broadcast``, which gloo also takes on CUDA tensors, so the same code
runs under NCCL (one rank a card) and under gloo (the CPU tests, or two
ranks on one card, which NCCL refuses).  A failed collective raises.
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
    """This process's place in a data-parallel job (the default
    ``torch.distributed`` group): its rank, the number of ranks and its
    device."""
    rank: int
    world: int
    device: torch.device


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


def all_reduce_sum(tensors: Sequence[torch.Tensor], group: Group
                   ) -> List[torch.Tensor]:
    """The sums over the ranks of ``tensors`` (any shapes, on the group's
    device), by one ``all_reduce`` of a flat f32 buffer that holds them
    all; -> new f32 tensors of their shapes (contiguous)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    out, pos = [], 0
    for t in tensors:
        out.append(flat[pos:pos + t.numel()].view(t.shape))
        pos += t.numel()
    return out


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum over the ranks of the
    output's gradients: each rank's input feeds every rank's output."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, gy):
        g = gy.detach().clone()
        dist.all_reduce(g)
        return g


def all_reduce_with_grad(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable."""
    return _AllReduce.apply(x)


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
    """Broadcast rank 0's parameters and buffers to every rank, one
    ``broadcast`` a dtype."""
    by_type: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_type.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for tensors in by_type.values():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.broadcast(flat, 0)
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
    dist.all_reduce(vec)
    return vec[:group.rank].sum(), vec.sum()


def barrier(group: Group) -> None:
    """Wait until every rank is here (an ``all_reduce`` of one value, read
    back)."""
    t = torch.zeros(1, device=group.device)
    dist.all_reduce(t)
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
