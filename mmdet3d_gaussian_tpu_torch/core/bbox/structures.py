"""3D box helpers (LiDAR frame: bottom-centre (x, y, z), dims (dx, dy, dz),
yaw about +z)."""
from __future__ import annotations

import math

import torch


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = math.pi) -> torch.Tensor:
    """Map angle into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period
