"""PointPillars with the GD anchor head: the port's
``PointPillarsDetector`` and the reference ``reference.pointpillars``."""
from __future__ import annotations

from typing import Dict

import torch

from ..flops import conv, trunk
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


def forward_flops(cfg: Dict, b: int, points_per_frame: int) -> float:
    """FLOPs of a forward pass (``portbench/flops.py``): the hard
    encoder's linear layer over the whole pillar table, SECOND and
    SECONDFPN, the head's 1 x 1 convolutions."""
    model = cfg['model']
    enc = model['encoder_cfg']
    feat = enc['feat_channels'][0]
    body, (h, w, c) = trunk(model, b)
    rows = model['max_voxels_per_sample'] * b \
        * model['max_points_per_voxel']
    pfn = 2 * rows * (enc['in_channels'] + 6) * feat
    hc = model['head_cfg']
    outs = hc['num_anchors'] * (hc['num_classes'] + 7 + 2)
    head = b * conv(h, w, c, outs, 1)
    return float(pfn + body + head)
