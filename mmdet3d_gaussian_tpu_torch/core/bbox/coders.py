"""Anchor-delta box coder and direction-classifier targets.

Port of ``mmdet3d_gaussian_tpu/core/bbox/coders.py``:
``DeltaXYZWLHRBBoxCoder`` (mmdet3d semantics: xy normalized by the anchor's
BEV diagonal, z by its height with z at the box centre, log dims, raw yaw
delta), ``add_sin_difference`` and ``get_direction_target``.
"""
from __future__ import annotations

import math

import torch

from ...registry import BBOX_CODERS
from .structures import limit_period


@BBOX_CODERS.register_module()
class DeltaXYZWLHRBBoxCoder:

    def __init__(self, code_size: int = 7):
        self.code_size = code_size

    def encode(self, anchors: torch.Tensor, gt: torch.Tensor):
        """anchors, gt (..., 7+) -> deltas (..., 7+)."""
        xa, ya, za, wa, la, ha, ra = anchors[..., :7].unbind(-1)
        xg, yg, zg, wg, lg, hg, rg = gt[..., :7].unbind(-1)
        za = za + ha / 2
        zg = zg + hg / 2
        diag = torch.sqrt(la ** 2 + wa ** 2)
        out = torch.stack([(xg - xa) / diag, (yg - ya) / diag,
                           (zg - za) / ha, torch.log(wg / wa),
                           torch.log(lg / la), torch.log(hg / ha), rg - ra],
                          dim=-1)
        if gt.shape[-1] > 7:
            out = torch.cat([out, gt[..., 7:] - anchors[..., 7:]], -1)
        return out

    def decode(self, anchors: torch.Tensor, deltas: torch.Tensor):
        """anchors, deltas (..., 7+) -> boxes (..., 7+)."""
        out = torch.stack(self.decode_parts(anchors[..., :7].unbind(-1),
                                            deltas[..., :7].unbind(-1)),
                          dim=-1)
        if deltas.shape[-1] > 7:
            out = torch.cat([out, deltas[..., 7:] + anchors[..., 7:]], -1)
        return out

    @staticmethod
    def decode_parts(anchors, deltas):
        """Component-wise decode: ``anchors`` / ``deltas`` are length-7
        sequences of same-shape tensors (x, y, z, w, l, h, r)."""
        xa, ya, za, wa, la, ha, ra = anchors
        xt, yt, zt, wt, lt, ht, rt = deltas
        za = za + ha / 2
        diag = torch.sqrt(la ** 2 + wa ** 2)
        lg = torch.exp(lt) * la
        wg = torch.exp(wt) * wa
        hg = torch.exp(ht) * ha
        return (xt * diag + xa, yt * diag + ya, zt * ha + za - hg / 2,
                wg, lg, hg, rt + ra)


def add_sin_difference(pred: torch.Tensor, target: torch.Tensor):
    """Yaw channel -> sin-difference pair: pred_r' = sin(rp) cos(rt),
    target_r' = cos(rp) sin(rt)."""
    rp, rt = pred[..., 6:7], target[..., 6:7]
    pred = torch.cat([pred[..., :6], torch.sin(rp) * torch.cos(rt),
                      pred[..., 7:]], -1)
    target = torch.cat([target[..., :6], torch.cos(rp) * torch.sin(rt),
                        target[..., 7:]], -1)
    return pred, target


def get_direction_target(anchors: torch.Tensor, reg_targets: torch.Tensor,
                         dir_offset: float = -math.pi / 2,
                         num_bins: int = 2) -> torch.Tensor:
    """Direction-bin class target (int32) from gt yaw = anchor yaw + yaw
    delta."""
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = limit_period(rot_gt - dir_offset, 0, 2 * math.pi)
    dir_cls = torch.floor(offset_rot / (2 * math.pi / num_bins))
    return dir_cls.clamp(0, num_bins - 1).to(torch.int32)
