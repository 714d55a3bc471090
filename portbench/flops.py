"""The model FLOPs of a step, counted from the configuration's shapes:
convolutions, transposed convolutions and linear layers, a multiply-add
as two operations, biases and elementwise work left out; the backward
pass as twice the forward.  Layers as the configuration states them (the
anchor head's 72 output channels, not a padded width)."""
from __future__ import annotations

from typing import Dict


def conv(h, w, cin, cout, k):
    """A k x k convolution with an (h, w) output."""
    return 2 * h * w * cin * cout * k * k


def _grid(model):
    pcr, vs = model['point_cloud_range'], model['voxel_size']
    return (int(round((pcr[4] - pcr[1]) / vs[1])),
            int(round((pcr[3] - pcr[0]) / vs[0])))


def trunk(model: Dict, b: int):
    """-> (FLOPs of SECOND and SECONDFPN for a batch of b, (h, w, c) of the
    neck's output)."""
    bb, nk = model['backbone_cfg'], model['neck_cfg']
    h, w = _grid(model)
    cin, total, levels = bb['in_channels'], 0, []
    for ch, num, s in zip(bb['out_channels'], bb['layer_nums'],
                          bb['layer_strides']):
        h, w = h // s, w // s
        total += conv(h, w, cin, ch, 3) + num * conv(h, w, ch, ch, 3)
        levels.append((h, w, ch))
        cin = ch
    out_hw = None
    for (h, w, c), cout, s in zip(levels, nk['out_channels'],
                                  nk['upsample_strides']):
        if s >= 1:   # transposed conv, kernel = stride (1: a 1x1 conv)
            s = int(s)
            total += conv(h, w, c, cout, 1) * s * s
            out_hw = (h * s, w * s)
        else:
            k = int(round(1 / s))
            total += conv(h // k, w // k, c, cout, k)
            out_hw = (h // k, w // k)
    return b * total, (*out_hw, sum(nk['out_channels']))


def forward(cfg: Dict, b: int, points_per_frame: int) -> float:
    """FLOPs of one forward pass over a batch of ``b`` frames padded to
    ``points_per_frame`` points."""
    model = cfg['model']
    enc = model['encoder_cfg']
    feat = enc['feat_channels'][0]
    body, (h, w, c) = trunk(model, b)
    if cfg['family'] == 'pointpillars':
        # the hard encoder's linear layer over the whole pillar table
        rows = model['max_voxels_per_sample'] * b \
            * model['max_points_per_voxel']
        pfn = 2 * rows * (enc['in_channels'] + 6) * feat
        hc = model['head_cfg']
        outs = hc['num_anchors'] * (hc['num_classes'] + 7 + 2)
        head = b * conv(h, w, c, outs, 1)
    else:
        # the dynamic encoder's linear layer over every point row
        pfn = 2 * b * points_per_frame * (enc['in_channels'] + 6) * feat
        hd = cfg['head']
        f = hd['out_size_factor']
        gh, gw = _grid(model)
        hh, hw = gh // f, gw // f
        per = [2, 1, 3] + ([1, 2] if hd.get('yaw_mode') else [2]) \
            + ([2] if hd.get('with_vel') else [])
        head = conv(hh, hw, c, 64, 3)
        for t in hd['tasks']:
            for out in per + [t['num_classes']]:
                head += conv(hh, hw, 64, 64, 3) + conv(hh, hw, 64, out, 3)
        head *= b
    return float(pfn + body + head)


def step(cfg: Dict, b: int, points_per_frame: int, train: bool) -> float:
    """FLOPs of a train step (forward and a backward of twice its work)
    or of a predict."""
    f = forward(cfg, b, points_per_frame)
    return 3 * f if train else f
