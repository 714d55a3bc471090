"""Inclusive prefix scans of 1-D int32 tensors, and first-k selection.

The JAX package blocks these scans into 128-lane rows because XLA lowers a
long 1-D scan serially on a TPU; on the GPU ``torch.cumsum`` /
``torch.cummax`` are already parallel scans.
"""
from __future__ import annotations

import torch

__all__ = ['cumsum_i32', 'cummax_i32', 'compact_indices']


def cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of a 1-D int32 tensor."""
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def cummax_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cummax of a 1-D int32 tensor."""
    return torch.cummax(x.to(torch.int32), 0).values


def compact_indices(mask: torch.Tensor, k: int):
    """Positions of the first ``k`` True entries along the last dim of
    ``mask``, ascending.  Returns ``(idx, valid)``, each (..., k): idx int64
    (``n - 1`` where invalid), valid bool.

    Static shapes with no host sync (``torch.nonzero`` would sync): the
    inclusive count of each True entry is its output slot + 1, so True
    entries with a slot below ``k`` scatter their position there; every
    other entry writes slot ``k``, which is sliced off."""
    n = mask.shape[-1]
    rank = torch.cumsum(mask.to(torch.int32), -1, dtype=torch.int32) - 1
    slot = torch.where(mask & (rank < k), rank, k).long()
    pos = torch.arange(n, device=mask.device).expand_as(slot)
    table = torch.full(mask.shape[:-1] + (k + 1,), n - 1, dtype=torch.long,
                       device=mask.device)
    idx = table.scatter_(-1, slot, pos)[..., :k]
    total = rank[..., -1:] + 1 if n else rank.new_zeros(mask.shape[:-1]
                                                        + (1,))
    valid = torch.arange(k, device=mask.device) < total
    return torch.where(valid, idx, n - 1), valid
