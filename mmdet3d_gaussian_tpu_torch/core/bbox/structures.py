"""3D box helpers (LiDAR frame: bottom-centre (x, y, z), dims (dx, dy, dz),
yaw about +z).

Port of the parts of ``mmdet3d_gaussian_tpu/core/bbox/structures.py`` that
prediction and target assignment use.
"""
from __future__ import annotations

import math

import torch


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = math.pi) -> torch.Tensor:
    """Map angle into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def nearest_bev(boxes: torch.Tensor) -> torch.Tensor:
    """7-dim boxes -> axis-aligned BEV boxes (x1, y1, x2, y2): yaw snapped
    to the nearest multiple of pi/2, dx / dy swapped on odd multiples
    (mmdet3d ``LiDARInstance3DBoxes.nearest_bev``)."""
    yaw = limit_period(boxes[..., 6], 0.5, math.pi)
    swap = yaw.abs() > math.pi / 4
    dx = torch.where(swap, boxes[..., 4], boxes[..., 3])
    dy = torch.where(swap, boxes[..., 3], boxes[..., 4])
    half = torch.stack([dx, dy], dim=-1) / 2
    return torch.cat([boxes[..., 0:2] - half, boxes[..., 0:2] + half], -1)


def iou_aligned_2d(boxes1: torch.Tensor, boxes2: torch.Tensor,
                   eps: float = 1e-6, mode: str = 'iou') -> torch.Tensor:
    """Pairwise IoU (or IoF) of axis-aligned (x1, y1, x2, y2) boxes:
    (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    a1 = boxes1[..., :, None, :]
    a2 = boxes2[..., None, :, :]
    area1 = ((boxes1[..., 2] - boxes1[..., 0])
             * (boxes1[..., 3] - boxes1[..., 1]))
    area2 = ((boxes2[..., 2] - boxes2[..., 0])
             * (boxes2[..., 3] - boxes2[..., 1]))
    ix = (torch.minimum(a1[..., 2], a2[..., 2])
          - torch.maximum(a1[..., 0], a2[..., 0]))
    iy = (torch.minimum(a1[..., 3], a2[..., 3])
          - torch.maximum(a1[..., 1], a2[..., 1]))
    inter = ix.clamp(min=0) * iy.clamp(min=0)
    if mode == 'iou':
        denom = area1[..., :, None] + area2[..., None, :] - inter
    elif mode == 'iof':
        denom = area1[..., :, None]
    else:
        raise ValueError(f'unknown mode {mode!r}')
    return inter / denom.clamp(min=eps)
