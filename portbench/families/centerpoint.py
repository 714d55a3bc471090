"""CenterPoint (pillars, nuScenes): the port's ``CenterPointDetector`` and
the reference ``reference.centerpoint``."""
from __future__ import annotations

from typing import Dict

import torch

from ..flops import conv, grid, trunk
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


def forward_flops(cfg: Dict, b: int, points_per_frame: int) -> float:
    """FLOPs of a forward pass (``portbench/flops.py``): the dynamic
    encoder's linear layer over every point row, SECOND and SECONDFPN,
    the shared 3 x 3 convolution and each task's towers."""
    model = cfg['model']
    enc = model['encoder_cfg']
    feat = enc['feat_channels'][0]
    body, (h, w, c) = trunk(model, b)
    pfn = 2 * b * points_per_frame * (enc['in_channels'] + 6) * feat
    hd = cfg['head']
    f = hd['out_size_factor']
    gh, gw = grid(model)
    hh, hw = gh // f, gw // f
    per = [2, 1, 3] + ([1, 2] if hd.get('yaw_mode') else [2]) \
        + ([2] if hd.get('with_vel') else [])
    head = conv(hh, hw, c, 64, 3)
    for t in hd['tasks']:
        for out in per + [t['num_classes']]:
            head += conv(hh, hw, 64, 64, 3) + conv(hh, hw, 64, out, 3)
    head *= b
    return float(pfn + body + head)
