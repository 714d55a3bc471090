"""3D box helpers (LiDAR frame: bottom-centre (x, y, z), dims (dx, dy, dz),
yaw about +z).

Port of the parts of ``mmdet3d_gaussian_tpu/core/bbox/structures.py`` that
prediction, target assignment and the PV-RCNN RoI stage use.
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


def rotation_2d(points: torch.Tensor, angle) -> torch.Tensor:
    """Rotate ``(..., 2)`` points by ``angle`` (broadcastable) about the
    origin."""
    c, s = torch.cos(angle), torch.sin(angle)
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def rotation_3d_in_axis(points: torch.Tensor, angle,
                        axis: int = 2) -> torch.Tensor:
    """Rotate ``(..., 3)`` points about one coordinate axis."""
    c, s = torch.cos(angle), torch.sin(angle)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    if axis == 2:
        return torch.stack([c * x - s * y, s * x + c * y, z], dim=-1)
    if axis == 0:
        return torch.stack([x, c * y - s * z, s * y + c * z], dim=-1)
    if axis == 1:
        return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)
    raise ValueError(f'axis must be 0/1/2, got {axis}')


# unit-square corners in BEV (x, y), counter-clockwise
BEV_CORNER_TEMPLATE = ((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5))


def corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """The 8 corners of bottom-centred 7-dim boxes -> ``(..., 8, 3)``:
    the bottom face counter-clockwise, then the top face."""
    tmpl = torch.tensor([[x, y, z] for z in (0.0, 1.0)
                         for x, y in BEV_CORNER_TEMPLATE],
                        dtype=boxes.dtype, device=boxes.device)
    corners = tmpl * boxes[..., None, 3:6]
    corners = rotation_3d_in_axis(corners, boxes[..., None, 6], axis=2)
    return corners + boxes[..., None, 0:3]


def points_in_boxes_bev(points_xy: torch.Tensor,
                        boxes: torch.Tensor) -> torch.Tensor:
    """``(P, 2)`` points x ``(G, 7)`` boxes -> ``(P, G)`` bool: inside
    the box's rotated BEV rectangle (z ignored)."""
    d = points_xy[:, None, :] - boxes[None, :, 0:2]
    yaw = boxes[None, :, 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    local_x = c * d[..., 0] + s * d[..., 1]
    local_y = -s * d[..., 0] + c * d[..., 1]
    return ((local_x.abs() <= boxes[None, :, 3] / 2)
            & (local_y.abs() <= boxes[None, :, 4] / 2))


def points_in_boxes_3d(points: torch.Tensor,
                       boxes: torch.Tensor) -> torch.Tensor:
    """``(P, 3)`` x ``(G, 7)`` -> ``(P, G)`` bool, full 3D membership."""
    in_bev = points_in_boxes_bev(points[:, 0:2], boxes)
    z0 = boxes[None, :, 2]
    z1 = z0 + boxes[None, :, 5]
    in_z = (points[:, None, 2] >= z0) & (points[:, None, 2] <= z1)
    return in_bev & in_z
