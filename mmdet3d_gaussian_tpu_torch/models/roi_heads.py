"""PV-RCNN's RoI stage: the keypoint mask head, RoI-grid pooling, the box
head, and RoI assignment, sampling and targets.

Port of ``mmdet3d_gaussian_tpu/models/roi_heads.py``, every function over
a leading sample dim (the JAX package vmaps one sample at a time):

* :class:`PointwiseMaskHead` — keypoint foreground segmentation: targets
  by point in box with an ignore ring of enlarged boxes, a focal loss
  normalized by the positives.
* :class:`Batch3DRoIGridExtractor` — G^3 grid points in each rotated RoI
  pooled from the (segmentation-weighted) keypoints by
  :class:`~.middle_encoders.GuidedSAModuleMSG`.
* :class:`PVRCNNBboxHead` — shared FCs, then the IoU-quality logit and the
  RoI-canonical box deltas.  Its dropout runs only when the caller hands
  a ``torch.Generator`` (the JAX module's dropout needs a ``dropout`` rng
  that no caller passes, so it never runs there).
* :func:`assign_and_sample` (exact 3D IoU, per-class matching, positives
  then hard then easy negatives in a fixed number of slots),
  :func:`roi_canonical_targets`, :func:`decode_roi_boxes` and
  :func:`corner_loss_lidar`.

Plain PyTorch, as the JAX package computes all of it outside Pallas.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.bbox.coders import DeltaXYZWLHRBBoxCoder
from ..core.bbox.structures import (corners_3d, points_in_boxes_3d,
                                    rotation_3d_in_axis)
from ..ops.nms import top_k
from ..ops.rotated_iou import iou_3d
from ..registry import MODELS
from .middle_encoders import GuidedSAModuleMSG, LinearBN

TWO_PI = 2 * np.pi


# ---------------------------------------------------------------- mask head
@MODELS.register_module()
class PointwiseMaskHead(nn.Module):

    def __init__(self, in_channels: int = 640, num_classes: int = 3,
                 mlps: Sequence[int] = (256, 256), extra_width: float = 0.2,
                 class_agnostic: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.extra_width = extra_width
        self.class_agnostic = class_agnostic
        self.mlps = nn.ModuleList()
        c = in_channels
        for ch in mlps:
            self.mlps.append(LinearBN(c, ch))
            c = ch
        self.seg_out = nn.Linear(c, 1 if class_agnostic else num_classes)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(..., C) -> logits (..., 1 or num_classes)."""
        y = feats
        for layer in self.mlps:
            y = layer(y)
        return self.seg_out(y)

    def get_targets(self, keypoints, gt_bboxes, gt_labels, gt_valid):
        """keypoints (B, M, 3), padded gts (B, G, ...) -> (B, M) int32: the
        class of the first gt box holding the point, num_classes for
        background, -1 in the ring of the enlarged boxes."""
        enlarged = torch.cat([
            gt_bboxes[..., 0:2], gt_bboxes[..., 2:3] - self.extra_width,
            gt_bboxes[..., 3:6] + 2 * self.extra_width, gt_bboxes[..., 6:]],
            -1)
        out = []
        for kp, boxes, big, labels, valid in zip(keypoints, gt_bboxes,
                                                 enlarged, gt_labels,
                                                 gt_valid):
            inside = points_in_boxes_3d(kp, boxes) & valid[None, :]
            inside_enl = points_in_boxes_3d(kp, big) & valid[None, :]
            fg = inside.any(-1)
            ring = inside_enl.any(-1) & ~fg
            first = torch.argmax(inside.to(torch.uint8), -1)
            tgt = torch.where(fg, labels[first].to(torch.int32),
                              self.num_classes)
            out.append(torch.where(ring, -1, tgt).to(torch.int32))
        return torch.stack(out)

    def loss(self, seg_logits, seg_targets, loss_seg, group=None):
        """Focal loss, weights normalized by the positives (under
        ``group``, a ``parallel.mesh.Group``, the positives of every
        rank's keypoints)."""
        flat = seg_logits.reshape(-1, seg_logits.shape[-1])
        tgt = seg_targets.reshape(-1)
        pos = (tgt > -1) & (tgt < self.num_classes)
        neg = tgt == self.num_classes
        weights = (pos | neg).float()
        num_pos = pos.sum().float()
        if group is not None:
            from ..parallel.mesh import all_reduce_sum
            num_pos, = all_reduce_sum([num_pos], group)
        weights = weights / torch.maximum(num_pos, weights.new_ones(()))
        if self.class_agnostic:
            cls_tgt = torch.where(pos, 0, 1)     # 1 = bg of the 1-ch sigmoid
        else:
            cls_tgt = torch.where(tgt < 0, self.num_classes, tgt)
        return loss_seg(flat, cls_tgt, weights, avg_factor=1.0)


# ------------------------------------------------------------ RoI grid pool
@MODELS.register_module()
class Batch3DRoIGridExtractor(nn.Module):

    def __init__(self, in_channels: int = 128,
                 pool_radius: Sequence[float] = (0.8, 1.6),
                 samples: Sequence[int] = (16, 16),
                 mlps: Sequence[Sequence[int]] = ((64, 64), (64, 64)),
                 grid_size: int = 6, mode: str = 'max'):
        super().__init__()
        self.grid_size = grid_size
        self.grid_pool = GuidedSAModuleMSG(in_channels, pool_radius, samples,
                                           mlps, pool_method=mode)
        self.out_channels = grid_size ** 3 * self.grid_pool.out_channels

    def dense_grid_points(self, rois: torch.Tensor) -> torch.Tensor:
        """rois (..., 7) -> (..., G^3, 3) rotated grid points; z spans the
        box from its bottom (rois are bottom-centred)."""
        g = self.grid_size
        idx = np.stack(np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                                   indexing='ij'), -1).reshape(-1, 3)
        frac = (torch.as_tensor(idx, dtype=torch.float32,
                                device=rois.device) + 0.5) / g
        frac = torch.cat([frac[:, :2] - 0.5, frac[:, 2:]], -1)
        local = frac * rois[..., None, 3:6]
        rot = rotation_3d_in_axis(local, rois[..., None, 6], axis=2)
        return rot + rois[..., None, 0:3]

    def forward(self, keypoint_feats, keypoints, rois, rois_valid):
        """keypoint_feats (B, M, C), keypoints (B, M, 3), rois (B, R, 7)
        -> (B, R, G^3 * C_out), zero for invalid rois."""
        b, r, _ = rois.shape
        query = self.dense_grid_points(rois).reshape(b, -1, 3)
        mask = torch.ones(keypoints.shape[:2], dtype=torch.bool,
                          device=keypoints.device)
        pooled = self.grid_pool(keypoints, keypoint_feats, query, mask)
        return pooled.reshape(b, r, -1) * rois_valid[..., None]


# ---------------------------------------------------------------- box head
def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``Dropout``: keep with probability 1 - rate and scale by its
    inverse; the identity without a generator."""
    if generator is None or rate <= 0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


@MODELS.register_module()
class PVRCNNBboxHead(nn.Module):

    def __init__(self, in_channels: int = 128 * 216,
                 num_classes: int = 3, class_agnostic: bool = True,
                 shared_fc: Sequence[int] = (256, 256),
                 cls_fc: Sequence[int] = (256, 256),
                 reg_fc: Sequence[int] = (256, 256), dropout: float = 0.3,
                 code_size: int = 7):
        """``in_channels``: the flattened grid features, G^3 x C."""
        super().__init__()
        self.dropout = dropout

        def tower(widths, cin):
            layers = nn.ModuleList()
            for ch in widths:
                layers.append(LinearBN(cin, ch))
                cin = ch
            return layers, cin
        self.shared, c = tower(shared_fc, in_channels)
        self.cls, cc = tower(cls_fc, c)
        self.reg, rc = tower(reg_fc, c)
        self.cls_out = nn.Linear(cc, 1 if class_agnostic else num_classes)
        self.reg_out = nn.Linear(rc, code_size)

    def forward(self, grid_feats, valid=None,
                generator: Optional[torch.Generator] = None):
        """grid_feats (B, R, G^3 C), valid (B, R) -> cls (B, R, 1), reg
        (B, R, 7).  BatchNorm statistics leave the invalid rois out.
        Dropout after every shared layer but the last and after the first
        layer of each branch, only with ``generator``."""
        y = grid_feats
        for i, layer in enumerate(self.shared):
            y = layer(y, valid)
            if i < len(self.shared) - 1:
                y = dropout(y, self.dropout, generator)
        c, r = y, y
        for i, layer in enumerate(self.cls):
            c = layer(c, valid)
            if i == 0:
                c = dropout(c, self.dropout, generator)
        for i, layer in enumerate(self.reg):
            r = layer(r, valid)
            if i == 0:
                r = dropout(r, self.dropout, generator)
        return self.cls_out(c), self.reg_out(r)


# ------------------------------------------ assignment, sampling, targets
class RoISamples(NamedTuple):
    rois: torch.Tensor          # (B, R, 7)
    roi_labels: torch.Tensor    # (B, R) predicted class of each roi
    gt_of_roi: torch.Tensor     # (B, R, 7) matched gt (arbitrary if not pos)
    ious: torch.Tensor          # (B, R)
    is_pos: torch.Tensor        # (B, R) bool
    valid: torch.Tensor         # (B, R) bool


def assign_and_sample(proposals, proposal_labels, proposal_valid,
                      gt_bboxes, gt_labels, gt_valid, num_samples: int = 128,
                      pos_iou_thr: float = 0.55, hard_neg_thr: float = 0.1,
                      pos_fraction: float = 0.5) -> RoISamples:
    """Each proposal matches the gt of its predicted class with the largest
    exact 3D IoU; then ``num_samples`` slots are filled by rank: up to
    ``num_samples * pos_fraction`` positives (IoU >= ``pos_iou_thr``, the
    rest discarded), hard negatives (IoU >= ``hard_neg_thr``), easy ones,
    each band by IoU, ties to the lower index.  (B, P, ...) -> (B, R,
    ...)."""
    iou = torch.stack([iou_3d(p, g) for p, g in zip(proposals,
                                                    gt_bboxes)])
    same = proposal_labels[..., :, None] == gt_labels[..., None, :]
    iou = torch.where(same & gt_valid[..., None, :], iou, 0.0)
    max_iou, argmax = iou.max(-1)
    max_iou = torch.where(proposal_valid, max_iou, -1.0)

    is_pos = max_iou >= pos_iou_thr
    is_hard = (max_iou >= hard_neg_thr) & ~is_pos & proposal_valid
    is_easy = (max_iou >= 0) & (max_iou < hard_neg_thr) & proposal_valid
    max_pos = int(num_samples * pos_fraction)
    pos_rank = torch.cumsum(is_pos.to(torch.int32), -1) - 1
    kept_pos = is_pos & (pos_rank < max_pos)
    score = torch.where(kept_pos, 3000.0 + max_iou,
                        torch.where(is_hard, 2000.0 + max_iou,
                                    torch.where(is_easy, 1000.0 + max_iou,
                                                -1.0)))
    score = torch.where(is_pos & ~kept_pos, -1.0, score)
    top, order = top_k(score, num_samples)
    sel_valid = top > 0

    def take(x):
        idx = order.reshape(order.shape + (1,) * (x.dim() - 2))
        return x.gather(1, idx.expand(order.shape + x.shape[2:]))
    gt_idx = argmax.gather(1, order)
    gt_of_roi = gt_bboxes.gather(1, gt_idx[..., None].expand(
        -1, -1, gt_bboxes.shape[-1]))
    return RoISamples(rois=take(proposals), roi_labels=take(proposal_labels),
                      gt_of_roi=gt_of_roi,
                      ious=torch.maximum(take(max_iou),
                                         max_iou.new_zeros(())),
                      is_pos=take(kept_pos) & sel_valid, valid=sel_valid)


def _roi_anchor(rois: torch.Tensor) -> torch.Tensor:
    """The RoI's own frame: zero centre and yaw, its sizes."""
    return torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:6],
                      torch.zeros_like(rois[..., 6:7])], -1)


def roi_canonical_targets(samples: RoISamples,
                          coder: DeltaXYZWLHRBBoxCoder,
                          cls_pos_thr: float = 0.75,
                          cls_neg_thr: float = 0.25):
    """-> (soft label, label weight, box targets in the RoI's frame, reg
    weight): the IoU-interval label, the gt rotated into the RoI's frame,
    its yaw flipped by pi when opposite and clipped to [-pi/2, pi/2]."""
    iou = samples.ious
    label = (iou > cls_pos_thr).float()
    interval = (iou >= cls_neg_thr) & (iou <= cls_pos_thr)
    label = torch.where(interval, iou * 2 - 0.5, label)
    label_weights = samples.valid.float()

    rois, gt = samples.rois, samples.gt_of_roi
    roi_ry = torch.remainder(rois[..., 6], TWO_PI)
    ct = rotation_3d_in_axis(gt[..., 0:3] - rois[..., 0:3], -roi_ry, axis=2)
    ry = torch.remainder(torch.remainder(gt[..., 6], TWO_PI) - roi_ry,
                         TWO_PI)
    opposite = (ry > np.pi * 0.5) & (ry < np.pi * 1.5)
    ry = torch.where(opposite, torch.remainder(ry + np.pi, TWO_PI), ry)
    ry = torch.where(ry > np.pi, ry - TWO_PI, ry)
    ry = torch.minimum(torch.maximum(ry, ry.new_tensor(-np.pi / 2)),
                       ry.new_tensor(np.pi / 2))
    gt_ct = torch.cat([ct, gt[..., 3:6], ry[..., None]], -1)
    bbox_targets = coder.encode(_roi_anchor(rois), gt_ct)
    return label, label_weights, bbox_targets, samples.is_pos.float()


def decode_roi_boxes(rois: torch.Tensor, deltas: torch.Tensor,
                     coder: DeltaXYZWLHRBBoxCoder) -> torch.Tensor:
    """RoI-frame deltas -> world boxes."""
    local = coder.decode(_roi_anchor(rois), deltas)
    roi_ry = torch.remainder(rois[..., 6], TWO_PI)
    xyz = rotation_3d_in_axis(local[..., 0:3], roi_ry, axis=2)
    xyz = xyz + rois[..., 0:3]
    yaw = local[..., 6] + roi_ry
    return torch.cat([xyz, local[..., 3:6], yaw[..., None]], -1)


def corner_loss_lidar(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                      delta: float = 1.0) -> torch.Tensor:
    """Huber loss of the corner distances, the smaller of the gt and the
    gt turned by pi -> (N,)."""
    pc = corners_3d(pred_boxes)
    gc = corners_3d(gt_boxes)
    flip = torch.cat([gt_boxes[..., :6], gt_boxes[..., 6:7] + math.pi,
                      gt_boxes[..., 7:]], -1)
    gcf = corners_3d(flip)
    d = torch.minimum(torch.linalg.vector_norm(pc - gc, dim=-1),
                      torch.linalg.vector_norm(pc - gcf, dim=-1))
    quad = torch.minimum(d, d.new_tensor(delta))
    return (0.5 * quad ** 2 + delta * (d - quad)).mean(-1)
