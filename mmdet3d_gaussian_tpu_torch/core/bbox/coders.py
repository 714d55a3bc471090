"""Anchor-delta box coder (decode only in this port so far).

Port of ``mmdet3d_gaussian_tpu/core/bbox/coders.py::DeltaXYZWLHRBBoxCoder``
(mmdet3d semantics: xy normalized by the anchor's BEV diagonal, z by its
height with z at the box centre, log dims, raw yaw delta).
"""
from __future__ import annotations

import torch

from ...registry import BBOX_CODERS


@BBOX_CODERS.register_module()
class DeltaXYZWLHRBBoxCoder:

    def __init__(self, code_size: int = 7):
        self.code_size = code_size

    def decode(self, anchors: torch.Tensor, deltas: torch.Tensor):
        """anchors, deltas (..., 7+) -> boxes (..., 7+)."""
        xa, ya, za, wa, la, ha, ra = anchors[..., :7].unbind(-1)
        xt, yt, zt, wt, lt, ht, rt = deltas[..., :7].unbind(-1)
        za = za + ha / 2
        diag = torch.sqrt(la ** 2 + wa ** 2)
        xg = xt * diag + xa
        yg = yt * diag + ya
        zg = zt * ha + za
        lg = torch.exp(lt) * la
        wg = torch.exp(wt) * wa
        hg = torch.exp(ht) * ha
        rg = rt + ra
        zg = zg - hg / 2
        out = torch.stack([xg, yg, zg, wg, lg, hg, rg], dim=-1)
        if deltas.shape[-1] > 7:
            out = torch.cat([out, deltas[..., 7:] + anchors[..., 7:]], -1)
        return out
