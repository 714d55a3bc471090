"""PointPillars with the GD anchor head: the port's
``PointPillarsDetector`` and the reference ``reference.pointpillars``."""
from __future__ import annotations

from typing import Dict

import torch

from ..reference.pointpillars import PointPillars
from .common import program_optimizer


def reference(cfg: Dict, device) -> PointPillars:
    with torch.device(device):
        return PointPillars(cfg['model'], cfg['head'])


def program(cfg: Dict, device, weights):
    from mmdet3d_gaussian_tpu_torch.engine.detector import \
        PointPillarsDetector
    det = PointPillarsDetector(cfg['model'], cfg['head'], device=device)
    det.trunk.load_state_dict(weights, strict=True)
    return det


def init_train(det, cfg: Dict):
    return det.init_train(optimizer=program_optimizer(cfg))


def reference_loss(model: PointPillars, batch: Dict, anchors):
    outs = model(batch['points'], batch['points_mask'], training=True)
    return model.loss(outs, batch, anchors)[0]


def reference_anchors(model: PointPillars, device):
    return model.anchors(device)
