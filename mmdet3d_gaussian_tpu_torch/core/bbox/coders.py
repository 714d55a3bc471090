"""Box coders and direction-classifier targets.

Port of ``mmdet3d_gaussian_tpu/core/bbox/coders.py``:
``DeltaXYZWLHRBBoxCoder`` (mmdet3d semantics: xy normalized by the anchor's
BEV diagonal, z by its height with z at the box centre, log dims, raw yaw
delta), ``add_sin_difference``, ``get_direction_target``, and the
CenterPoint cell coders ``CenterPointBBoxCoder`` / ``CenterPointBBoxYawCoder``
with ``snap_yaw_to_direction``, and the anchor-free ``PointBBoxYawCoder``.
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


def snap_yaw_to_direction(yaw, dir_sin, dir_cos, dims):
    """Snap a raw regressed yaw to the quadrant of the sin/cos direction
    branch: yaw += round((dir - yaw) / (pi/2)) * pi/2, the BEV dims swapped
    on odd quarter-turns.  -> (yaw, dims (..., 3))."""
    direction = torch.atan2(dir_sin, dir_cos)
    num_rot90 = torch.floor((direction - yaw) / (math.pi / 2) + 0.5)
    yaw = yaw + num_rot90 * (math.pi / 2)
    odd = torch.remainder(num_rot90.abs(), 2) == 1
    w = torch.where(odd, dims[..., 1], dims[..., 0])
    l = torch.where(odd, dims[..., 0], dims[..., 1])  # noqa: E741
    return yaw, torch.stack([w, l, dims[..., 2]], dim=-1)


@BBOX_CODERS.register_module()
class PointBBoxYawCoder:
    """Anchor-free point-prior coder (reference
    ``point_bbox_yaw_coders.py``): xy = pred * stride + prior centre, BEV
    dims scaled by stride (height not scaled), z passed through raw, yaw
    snapped against the sin/cos direction branch."""

    def __init__(self, code_size: int = 9):
        self.code_size = code_size

    def encode(self, target_boxes: torch.Tensor) -> torch.Tensor:
        """(..., 7+) -> (..., 9+): box7 + (sin yaw, cos yaw) + extras."""
        yaw = target_boxes[..., 6]
        return torch.cat([target_boxes[..., :7], torch.sin(yaw)[..., None],
                          torch.cos(yaw)[..., None], target_boxes[..., 7:]],
                         dim=-1)

    def decode(self, priors: torch.Tensor, pred: torch.Tensor,
               correct_yaw: bool = True) -> torch.Tensor:
        """priors (..., 3) = (cx, cy, stride); pred (..., code_size)."""
        stride = priors[..., 2:3]
        xy = pred[..., 0:2] * stride + priors[..., 0:2]
        z = pred[..., 2]
        dims = torch.exp(pred[..., 3:6])
        dims = torch.cat([dims[..., :2] * stride, dims[..., 2:]], dim=-1)
        yaw = pred[..., 6]
        if correct_yaw:
            yaw, dims = snap_yaw_to_direction(yaw, pred[..., 7],
                                              pred[..., 8], dims)
        return torch.cat([xy, z[..., None], dims, yaw[..., None],
                          pred[..., 9:]], dim=-1)


@BBOX_CODERS.register_module()
class CenterPointBBoxCoder:
    """CenterPoint encode / decode on BEV cells of ``voxel_size *
    out_size_factor``.  Code layout: (dx, dy, z, log w, log l, log h,
    sin r, cos r[, vx, vy]); dx, dy are the in-cell offsets and z the
    gravity-centre height."""

    def __init__(self, pc_range, voxel_size, out_size_factor: int,
                 code_size: int = 9, post_center_range=None,
                 max_num: int = 500, score_threshold: float = 0.0):
        self.pc_range = tuple(pc_range)
        self.voxel_size = tuple(voxel_size)
        self.out_size_factor = out_size_factor
        self.code_size = code_size
        self.post_center_range = post_center_range
        self.max_num = max_num
        self.score_threshold = score_threshold

    def _cell(self):
        return (self.voxel_size[0] * self.out_size_factor,
                self.voxel_size[1] * self.out_size_factor)

    def _base(self, boxes):
        """-> (cell ix int32, cell iy int32, the 8 base code columns)."""
        cx, cy = self._cell()
        fx = (boxes[..., 0] - self.pc_range[0]) / cx
        fy = (boxes[..., 1] - self.pc_range[1]) / cy
        ix = torch.floor(fx).to(torch.int32)
        iy = torch.floor(fy).to(torch.int32)
        code = torch.cat([
            (fx - ix.to(fx.dtype))[..., None],
            (fy - iy.to(fy.dtype))[..., None],
            boxes[..., 2:3] + boxes[..., 5:6] * 0.5,
            torch.log(boxes[..., 3:6].clamp(min=1e-7)),
            torch.sin(boxes[..., 6:7]), torch.cos(boxes[..., 6:7])], -1)
        return ix, iy, code

    def encode(self, boxes):
        """boxes (..., 7+) -> (cell ix, cell iy, code (..., code_size))."""
        ix, iy, code = self._base(boxes)
        return ix, iy, torch.cat([code, boxes[..., 7:]], -1)

    def _centre(self, codes, ix, iy):
        """-> (x, y, bottom z, dims (..., 3)) of codes at integer cells."""
        cx, cy = self._cell()
        x = (codes[..., 0] + ix) * cx + self.pc_range[0]
        y = (codes[..., 1] + iy) * cy + self.pc_range[1]
        dims = torch.exp(codes[..., 3:6])
        return x, y, codes[..., 2] - dims[..., 2] * 0.5, dims

    def decode_cells(self, codes, ix, iy):
        """codes (..., code_size) at integer cells -> boxes (..., 7+)."""
        x, y, z, dims = self._centre(codes, ix, iy)
        yaw = torch.atan2(codes[..., 6], codes[..., 7])
        return torch.cat([x[..., None], y[..., None], z[..., None], dims,
                          yaw[..., None], codes[..., 8:]], -1)


@BBOX_CODERS.register_module()
class CenterPointBBoxYawCoder(CenterPointBBoxCoder):
    """Raw-yaw regression beside a sin/cos *direction* branch; decode snaps
    the yaw to the direction's quadrant (:func:`snap_yaw_to_direction`).
    Code layout: (dx, dy, z, log w, log l, log h, yaw, sin dir, cos dir,
    ...)."""

    def encode(self, boxes):
        ix, iy, base = self._base(boxes)
        return ix, iy, torch.cat([base[..., :6], boxes[..., 6:7],
                                  base[..., 6:8], boxes[..., 7:]], -1)

    def decode_cells(self, codes, ix, iy, correct_yaw: bool = True):
        x, y, z, dims = self._centre(codes, ix, iy)
        yaw = codes[..., 6]
        if correct_yaw:
            yaw, dims = snap_yaw_to_direction(yaw, codes[..., 7],
                                              codes[..., 8], dims)
        return torch.cat([x[..., None], y[..., None], z[..., None], dims,
                          yaw[..., None], codes[..., 9:]], -1)
