"""Inclusive prefix scans of 1-D int32 tensors.

The JAX package blocks these scans into 128-lane rows because XLA lowers a
long 1-D scan serially on a TPU; on the GPU ``torch.cumsum`` /
``torch.cummax`` are already parallel scans.
"""
from __future__ import annotations

import torch

__all__ = ['cumsum_i32', 'cummax_i32']


def cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of a 1-D int32 tensor."""
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def cummax_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cummax of a 1-D int32 tensor."""
    return torch.cummax(x.to(torch.int32), 0).values
