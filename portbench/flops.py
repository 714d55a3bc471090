"""The model FLOPs of a step, counted from the configuration's shapes:
convolutions, transposed convolutions and linear layers, a multiply-add
as two operations, biases and elementwise work left out; the backward
pass as twice the forward.  Layers as the configuration states them (the
anchor head's 72 output channels, not a padded width).  Each model family
counts its own forward pass (``forward_flops`` in ``families/<family>.py``)
with the helpers here; nothing here names a family."""
from __future__ import annotations

from typing import Dict


def conv(h, w, cin, cout, k):
    """A k x k convolution with an (h, w) output."""
    return 2 * h * w * cin * cout * k * k


def grid(model):
    """(rows, columns) of the configuration's BEV grid."""
    pcr, vs = model['point_cloud_range'], model['voxel_size']
    return (int(round((pcr[4] - pcr[1]) / vs[1])),
            int(round((pcr[3] - pcr[0]) / vs[0])))


def trunk(model: Dict, b: int):
    """-> (FLOPs of SECOND and SECONDFPN for a batch of b, (h, w, c) of the
    neck's output)."""
    bb, nk = model['backbone_cfg'], model['neck_cfg']
    h, w = grid(model)
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
    ``points_per_frame`` points: the ``forward_flops`` of the
    configuration's family (``families/<family>.py``), which counts its
    own layers with :func:`conv` and :func:`trunk`."""
    from . import families
    return families.get(cfg['family']).forward_flops(cfg, b,
                                                     points_per_frame)


def step(cfg: Dict, b: int, points_per_frame: int, train: bool) -> float:
    """FLOPs of a train step (forward and a backward of twice its work)
    or of a predict."""
    f = forward(cfg, b, points_per_frame)
    return 3 * f if train else f
