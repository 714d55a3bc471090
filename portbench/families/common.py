"""What the families share: batches on the device, the live pillars of a
batch, the program's optimizer built from a configuration."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def live_pillars(batch: Dict[str, np.ndarray], model: Dict):
    """Live pillars of each frame of a numpy batch (points in range)."""
    pcr, vs = model['point_cloud_range'], model['voxel_size']
    out = []
    for pts, m in zip(batch['points'], batch['points_mask']):
        q = pts[m]
        ijk = np.floor((q[:, :3] - np.asarray(pcr[:3], np.float32))
                       / np.asarray(vs, np.float32)).astype(np.int64)
        grid = np.floor((np.asarray(pcr[3:]) - np.asarray(pcr[:3]))
                        / np.asarray(vs) + 0.5).astype(np.int64)
        ok = ((ijk >= 0) & (ijk < grid)).all(-1)
        out.append(int(len(np.unique(ijk[ok, 1] * grid[0] + ijk[ok, 0]))))
    return out


def program_optimizer(cfg: Dict):
    """The port's AdamW for the configuration's ``train`` entry."""
    from mmdet3d_gaussian_tpu_torch.parallel.train_state import \
        make_optimizer_from_cfg
    t = cfg['train']
    return make_optimizer_from_cfg(
        dict(optimizer=t['optimizer'], grad_clip=t['grad_clip'],
             lr_config=t['lr_config'], momentum_config=t['momentum_config']),
        int(t['total_steps']))
