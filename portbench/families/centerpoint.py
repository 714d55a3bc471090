"""CenterPoint (pillars, nuScenes): the port's ``CenterPointDetector`` and
the reference ``reference.centerpoint``."""
from __future__ import annotations

from typing import Dict

import torch

from ..reference.centerpoint import CenterPoint


def reference(cfg: Dict, device) -> CenterPoint:
    with torch.device(device):
        return CenterPoint(cfg['model'], cfg['head'])


def program(cfg: Dict, device, weights):
    from mmdet3d_gaussian_tpu_torch.engine.detector import \
        CenterPointDetector
    det = CenterPointDetector(cfg['model'], cfg['head'], device=device)
    det.trunk.load_state_dict(weights, strict=True)
    return det


def reference_predict(model: CenterPoint, batch: Dict):
    """-> (final (boxes, scores, labels, valid), candidates)."""
    return model.predict(batch['points'], batch['points_mask'])
