"""Anchor -> GT assignment (MaxIoU), batched, static shapes.

Port of ``mmdet3d_gaussian_tpu/core/bbox/assigners.py``:
:func:`bbox_overlaps_nearest_3d`, :class:`MaxIoUAssigner` and
:func:`assign_per_class_vectorized`, with a leading batch dimension written
out (the JAX package vmaps one sample at a time), and the anchor-free
:class:`SimOTABEVAssigner` (one sample, as in JAX; no head calls it).
Codes follow mmdet: per anchor ``assigned_gt`` is -1 ignore, 0 negative,
g+1 matched to gt g.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .structures import iou_aligned_2d, nearest_bev, points_in_boxes_bev


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


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last dim: descending, ties to the lower
    index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class SimOTABEVAssigner:
    """SimOTA in BEV (reference ``sim_ota_3d_assigner.py:10-211``), static
    shapes, as the JAX package's:

    * a prior is a candidate if its centre is inside any gt box
      (z-extruded) or within ``center_radius`` (metres, max-norm) of any
      gt centre; candidates may match any gt;
    * cost per (gt, candidate) = ``cls_weight * BCE(sqrt(score), onehot)
      + iou_weight * (-log(iou + eps))``, clamped to at most
      ``match_init`` where the prior is inside that gt's box and centre
      window;
    * dynamic k = ``clamp(int(sum(top-10 ious)), min=1)`` per gt, the k
      lowest-cost candidates matched, a prior matched to several gts kept
      by its least cost.
    """

    EPS = 1e-8

    def __init__(self, center_radius: float = 0.5, candidate_topk: int = 10,
                 iou_weight: float = 3.0, cls_weight: float = 1.0,
                 match_init: float = 2.0, use_box_gate: bool = True):
        self.center_radius = center_radius
        self.candidate_topk = candidate_topk
        self.iou_weight = iou_weight
        self.cls_weight = cls_weight
        self.match_init = match_init
        self.use_box_gate = use_box_gate

    def assign(self, priors, cls_scores, ious, gt_bboxes, gt_labels,
               gt_valid) -> AssignResult:
        """priors (A, >=2) (cx, cy, ...), only the BEV centre used;
        cls_scores (A, C) sigmoid probabilities; ious (G, A) 3D IoU of the
        gts and the decoded predictions; gt (G, ...) padded, gt_valid (G,)
        bool."""
        num_gt, num_priors = ious.shape
        dev = ious.device
        centers = priors[:, 0:2]
        if self.use_box_gate:
            in_box = points_in_boxes_bev(centers, gt_bboxes).T      # (G, A)
        else:
            in_box = torch.zeros((num_gt, num_priors), dtype=torch.bool,
                                 device=dev)
        in_box = in_box & gt_valid[:, None]
        d = (centers[None, :, :] - gt_bboxes[:, None, 0:2]).abs()
        in_center = (d.amax(-1) < self.center_radius) & gt_valid[:, None]
        valid = in_box.any(0) | in_center.any(0)                    # (A,)
        gate = valid[None, :] & gt_valid[:, None]
        strong = in_box & in_center

        onehot = torch.nn.functional.one_hot(
            gt_labels.long(), cls_scores.shape[-1]).to(cls_scores.dtype)
        p = torch.sqrt(cls_scores.clamp(1e-7, 1 - 1e-7))            # (A, C)
        bce = -(onehot[:, None, :] * torch.log(p)[None]
                + (1 - onehot[:, None, :]) * torch.log(1 - p)[None])
        cls_cost = bce.sum(-1)                                      # (G, A)
        iou_cost = -torch.log(ious + self.EPS)
        cost = self.cls_weight * cls_cost + self.iou_weight * iou_cost
        cost = torch.where(strong, cost.clamp(max=self.match_init), cost)
        cost = torch.where(gate, cost, 1e18)

        k = min(self.candidate_topk, num_priors)
        top_ious = _top_k(torch.where(gate, ious, 0.0), k)[0]       # (G, k)
        dynamic_k = top_ious.sum(-1).to(torch.int32).clamp(min=1)   # (G,)
        neg_cost, idx = _top_k(-cost, k)                            # (G, k)
        rank_ok = torch.arange(k, device=dev)[None, :] < dynamic_k[:, None]
        valid_pick = rank_ok & (-neg_cost < 1e17) & gt_valid[:, None]
        matching = torch.zeros((num_gt, num_priors), dtype=torch.bool,
                               device=dev).scatter_(1, idx, valid_pick)

        multi = matching.sum(0) > 1
        best_gt = torch.where(matching, cost, 1e18).argmin(0)
        keep = torch.arange(num_gt, device=dev)[:, None] == best_gt[None, :]
        matching = torch.where(multi[None, :], matching & keep, matching)

        fg = matching.any(0)
        matched_gt = matching.to(torch.int32).argmax(0)
        assigned = torch.where(fg, matched_gt + 1, 0).to(torch.int32)
        labels = torch.where(fg, gt_labels[matched_gt].to(torch.int32), -1)
        # unmatched priors carry the reference's -INF sentinel (:116-118)
        max_iou = torch.where(
            fg, torch.where(matching, ious, 0.0).amax(0), -float(1e8))
        return AssignResult(assigned_gt=assigned, max_overlaps=max_iou,
                            labels=labels.to(torch.int32))
