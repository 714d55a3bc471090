"""Anchor -> GT assignment (MaxIoU), batched, static shapes.

Port of ``mmdet3d_gaussian_tpu/core/bbox/assigners.py``:
:func:`bbox_overlaps_nearest_3d`, :class:`MaxIoUAssigner` and
:func:`assign_per_class_vectorized`, with a leading batch dimension written
out (the JAX package vmaps one sample at a time).  Codes follow mmdet: per
anchor ``assigned_gt`` is -1 ignore, 0 negative, g+1 matched to gt g.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .structures import iou_aligned_2d, nearest_bev


class AssignResult(NamedTuple):
    assigned_gt: torch.Tensor   # (..., A) int32: -1 ignore / 0 neg / g+1
    max_overlaps: torch.Tensor  # (..., A) f32
    labels: torch.Tensor        # (..., A) int32 label of the matched gt, -1


def bbox_overlaps_nearest_3d(boxes1, boxes2, mode: str = 'iou'):
    """Axis-aligned nearest-BEV IoU of 7-dim boxes:
    (..., N, 7) x (..., M, 7) -> (..., N, M)."""
    return iou_aligned_2d(nearest_bev(boxes1), nearest_bev(boxes2),
                          mode=mode)


def _finish(overlaps, ok, gt_labels, pos_thr, neg_thr, min_thr):
    """Shared tail of both assigners.  overlaps (..., G, A) with -1 where
    a gt may not match; ok (..., G, A) eligibility; thresholds broadcast
    against (..., A)."""
    # max over G; argmax takes the first maximal gt (jnp.argmax)
    max_ov, argmax_ov = overlaps.max(dim=-2)
    assigned = torch.full_like(argmax_ov, -1, dtype=torch.int32)
    assigned = torch.where(max_ov < neg_thr, 0, assigned)
    assigned = torch.where(max_ov >= pos_thr,
                           argmax_ov.to(torch.int32) + 1, assigned)
    # low-quality matches: the LAST eligible gt reaching its own max wins
    gt_max = overlaps.max(dim=-1, keepdim=True).values          # (..., G, 1)
    eligible = (overlaps == gt_max) & (gt_max >= min_thr) & ok
    g_ids = torch.arange(1, overlaps.shape[-2] + 1, dtype=torch.int32,
                         device=overlaps.device)[:, None]
    lq = torch.where(eligible, g_ids, 0).max(dim=-2).values
    assigned = torch.where(lq > 0, lq, assigned)
    return assigned, max_ov


def _labels(assigned, gt_labels):
    safe = (assigned - 1).clamp(min=0).long()
    gathered = torch.gather(gt_labels.to(torch.int32), -1, safe)
    return torch.where(assigned > 0, gathered, -1).to(torch.int32)


class MaxIoUAssigner:
    """mmdet MaxIoU semantics with the nearest-BEV IoU calculator."""

    def __init__(self, pos_iou_thr: float, neg_iou_thr: float,
                 min_pos_iou: float = 0.0, ignore_iof_thr: float = -1,
                 gt_max_assign_all: bool = True,
                 iou_calculator: Optional[dict] = None):
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.ignore_iof_thr = ignore_iof_thr
        self.gt_max_assign_all = gt_max_assign_all

    def assign(self, anchors, gt_bboxes, gt_labels, gt_valid,
               gt_bboxes_ignore=None, gt_ignore_valid=None) -> AssignResult:
        """anchors (A, 7); gt_bboxes (..., G, 7) padded; gt_labels (..., G)
        int; gt_valid (..., G) bool.  Anchors whose IoF with an ignore box
        exceeds ``ignore_iof_thr`` are marked -1."""
        overlaps = bbox_overlaps_nearest_3d(gt_bboxes, anchors)  # (.., G, A)
        ok = gt_valid[..., :, None].expand_as(overlaps)
        overlaps = torch.where(ok, overlaps, -1.0)
        min_thr = (self.min_pos_iou if self.gt_max_assign_all
                   else float('inf'))
        assigned, max_ov = _finish(overlaps, ok, gt_labels, self.pos_iou_thr,
                                   self.neg_iou_thr, min_thr)
        # no gt at all: every anchor negative
        assigned = torch.where(gt_valid.any(dim=-1, keepdim=True), assigned,
                               0)
        if gt_bboxes_ignore is not None and self.ignore_iof_thr > 0:
            iof = bbox_overlaps_nearest_3d(anchors, gt_bboxes_ignore,
                                           mode='iof')          # (.., A, Gi)
            if gt_ignore_valid is not None:
                iof = torch.where(gt_ignore_valid[..., None, :], iof, 0.0)
            in_ignore = iof.max(dim=-1).values > self.ignore_iof_thr
            assigned = torch.where(in_ignore, -1, assigned)
        return AssignResult(assigned_gt=assigned, max_overlaps=max_ov,
                            labels=_labels(assigned, gt_labels))


def assign_per_class_vectorized(anchors_cls, gt_bboxes, gt_labels, gt_valid,
                                assigners: Sequence[MaxIoUAssigner]
                                ) -> AssignResult:
    """MaxIoU assignment with one assigner per anchor class in one (G, A)
    pass: gt g is eligible only for anchors of class ``gt_labels[g]``, and
    the per-class thresholds become per-anchor vectors.

    anchors_cls (HW, S, R, 7); gt_bboxes (..., G, 7); gt_labels, gt_valid
    (..., G).  Results are flat over (HW, S, R)."""
    hw, s, r, _ = anchors_cls.shape
    dev = anchors_cls.device
    flat = anchors_cls.reshape(-1, 7)
    anchor_cls = torch.arange(s, device=dev)[None, :, None].expand(
        hw, s, r).reshape(-1)

    def per_anchor(values):
        return torch.tensor(values, dtype=torch.float32,
                            device=dev)[anchor_cls]

    pos_thr = per_anchor([a.pos_iou_thr for a in assigners])
    neg_thr = per_anchor([a.neg_iou_thr for a in assigners])
    min_thr = per_anchor([a.min_pos_iou for a in assigners])
    overlaps = bbox_overlaps_nearest_3d(gt_bboxes, flat)         # (.., G, A)
    ok = gt_valid[..., :, None] & (gt_labels[..., :, None].long()
                                   == anchor_cls)
    overlaps = torch.where(ok, overlaps, -1.0)
    assigned, max_ov = _finish(overlaps, ok, gt_labels, pos_thr, neg_thr,
                               min_thr)
    return AssignResult(assigned_gt=assigned, max_overlaps=max_ov,
                        labels=_labels(assigned, gt_labels))
