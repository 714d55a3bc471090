"""Native Waymo Open Dataset detection metrics: mAP / mAPH at L1 / L2.

A copy of ``mmdet3d_gaussian_tpu/core/evaluation/waymo_metrics.py`` for
the port, on the host in numpy.

The reference reaches the official Waymo protocol through upstream
mmdet3d's ``WaymoDataset`` ('waymo' metric), which shells out to the
``waymo-open-dataset`` metrics binary
(``mmdet3d_gaussian/datasets/waymo_dataset.py:8-13`` inherits
it).  This module rebuilds that protocol natively (semantics of
``waymo_open_dataset/metrics/detection_metrics.cc`` + ``metrics_utils.cc``):

  * per-class 3D IoU thresholds: Vehicle/Car 0.7, Pedestrian 0.5,
    Cyclist 0.5;
  * HUNGARIAN matching per frame (the official default matcher): maximum
    total-IoU assignment over pairs with IoU >= threshold;
  * difficulty: LEVEL_2 = annotator-marked level 2 OR fewer than 5 lidar
    points in the box; boxes with ZERO points are dropped entirely.  The
    LEVEL_1 metric filters the GT set to level-1 boxes only — detections
    that cover level-2-only objects count as false positives there, exactly
    like the official tool (no ignore mechanism).  LEVEL_2 evaluates
    against all (nonzero-point) boxes;
  * score cutoffs: the P/R curve is sampled at up to ``num_cutoffs``
    score values drawn evenly from the sorted per-class score
    distribution (official ``ComputeScoreCutoffs``);
  * APH: every true positive is weighted by its heading accuracy
    ``1 - min(|dyaw|, 2pi - |dyaw|) / pi``; the weighted TP replaces the
    raw TP count in both precision and recall (official swap-the-measure
    form);
  * AP = sum over the recall-sorted curve of (r_i - r_{i-1}) * p_i, with
    recall gaps larger than ``recall_delta`` (0.05) filled by
    linearly-interpolated precision samples (official
    ``ComputeMeanAveragePrecision`` recall-delta semantics).

Boxes are 7-dof LiDAR-frame ``(x, y, z, dx, dy, dz, yaw)`` in this
framework's bottom-centered convention (``geometry_np.iou_3d`` with
z_offset 0.5).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .geometry_np import iou_3d

DEFAULT_IOU = {'Car': 0.7, 'Vehicle': 0.7, 'Pedestrian': 0.5,
               'Cyclist': 0.5, 'Sign': 0.5}
RECALL_DELTA = 0.05


def heading_accuracy(dt_yaw: np.ndarray, gt_yaw: np.ndarray) -> np.ndarray:
    """1 - wrapped|dyaw| / pi, clipped to [0, 1]."""
    d = np.abs(dt_yaw - gt_yaw) % (2 * np.pi)
    d = np.minimum(d, 2 * np.pi - d)
    return np.clip(1.0 - d / np.pi, 0.0, 1.0)


def gt_levels(difficulty: np.ndarray, num_points: np.ndarray) -> np.ndarray:
    """Per-box level: 0 = drop (no points), 1 = L1, 2 = L2."""
    lvl = np.where((difficulty == 2) | (num_points < 5), 2, 1)
    return np.where(num_points <= 0, 0, lvl).astype(np.int64)


def score_cutoffs(scores: np.ndarray, num_cutoffs: int = 100) -> np.ndarray:
    """Evenly-indexed sample of the sorted unique score distribution."""
    if scores.size == 0:
        return np.zeros((1,), np.float64)
    uniq = np.unique(scores.astype(np.float64))
    if uniq.size <= num_cutoffs:
        return uniq
    idx = np.linspace(0, uniq.size - 1, num_cutoffs).round().astype(int)
    return uniq[np.unique(idx)]


def _match_frame(ious: np.ndarray, thr: float):
    """Hungarian max-total-IoU assignment over pairs with IoU >= thr.

    Returns (dt_idx, gt_idx) arrays of matched pairs."""
    if ious.size == 0:
        return (np.zeros((0,), int), np.zeros((0,), int))
    from scipy.optimize import linear_sum_assignment
    cost = np.where(ious >= thr, -ious, 0.0)
    di, gi = linear_sum_assignment(cost)
    keep = ious[di, gi] >= thr
    return di[keep], gi[keep]


def _ap_from_pr(precisions: List[float], recalls: List[float]) -> float:
    """Official recall-delta AP: sort by recall, integrate
    sum((r_i - r_{i-1}) * p_i) with gaps > RECALL_DELTA filled by
    linearly-interpolated precision samples."""
    pts = sorted(zip(recalls, precisions))
    r_prev, p_prev = 0.0, (pts[0][1] if pts else 0.0)
    ap = 0.0
    for r, p in pts:
        gap = r - r_prev
        if gap <= 0:
            p_prev = p
            continue
        n_fill = int(np.ceil(gap / RECALL_DELTA)) - 1
        for j in range(1, n_fill + 1):
            f = j / (n_fill + 1)
            ap += (gap / (n_fill + 1)) * (p_prev + (p - p_prev) * f)
        ap += (gap / (n_fill + 1)) * p
        r_prev, p_prev = r, p
    return float(ap)


def eval_waymo(results: List[List[np.ndarray]],
               annotations: List[Dict],
               classes: Sequence[str] = ('Car', 'Pedestrian', 'Cyclist'),
               iou_thrs: Optional[Dict[str, float]] = None,
               num_cutoffs: int = 100,
               logger=None) -> Dict[str, float]:
    """Waymo OD mAP/mAPH at LEVEL_1 / LEVEL_2.

    Args:
        results: per frame, per class ``(N, 8)`` arrays ``[box7, score]``
            (the framework's standard detection format).
        annotations: per frame dicts with ``gt_bboxes (M, 7)``,
            ``gt_labels (M,)`` and ``gt_attrs`` carrying ``difficulty``
            and ``num_points_in_gt`` (missing fields default to level 1 /
            5 points, i.e. everything L1).
    Returns a flat dict: per class and overall
    ``{cls}/{L1,L2}/{AP,APH}`` plus ``mAP_L1 mAPH_L1 mAP_L2 mAPH_L2``.
    """
    iou_thrs = dict(DEFAULT_IOU, **(iou_thrs or {}))
    nf = len(annotations)
    out: Dict[str, float] = {}
    per_level_aps = {1: {'AP': [], 'APH': []}, 2: {'AP': [], 'APH': []}}

    for ci, cls in enumerate(classes):
        thr = iou_thrs.get(cls, 0.5)
        # collect per-frame dets/gts once
        frames = []
        all_scores = []
        for fi in range(nf):
            det = np.asarray(results[fi][ci]).reshape(-1, 8) \
                if fi < len(results) else np.zeros((0, 8), np.float32)
            ann = annotations[fi]
            sel = np.asarray(ann['gt_labels']) == ci
            gts = np.asarray(ann['gt_bboxes'], np.float32).reshape(-1, 7)[sel]
            attrs = ann.get('gt_attrs', {}) or {}
            diff = np.asarray(attrs.get(
                'difficulty', np.zeros(len(gts)))).reshape(-1)[
                    :len(gts)] if len(gts) else np.zeros((0,))
            npts = np.asarray(attrs.get(
                'num_points_in_gt', np.full(len(gts), 5))).reshape(-1)[
                    :len(gts)] if len(gts) else np.zeros((0,))
            lvl = gt_levels(diff, npts)
            keep = lvl > 0
            gts, lvl = gts[keep], lvl[keep]
            iou = iou_3d(det[:, :7], gts) if len(det) and len(gts) \
                else np.zeros((len(det), len(gts)), np.float32)
            frames.append((det, gts, lvl, iou))
            all_scores.append(det[:, 7])
        cutoffs = score_cutoffs(
            np.concatenate(all_scores) if all_scores
            else np.zeros((0,)), num_cutoffs)

        for level in (1, 2):
            prs = {'AP': ([], []), 'APH': ([], [])}
            for c in cutoffs:
                tp = tph = fp = fn = 0.0
                for det, gts, lvl, iou in frames:
                    gsel = lvl <= level
                    g = gts[gsel]
                    dsel = det[:, 7] >= c
                    d = det[dsel]
                    sub = iou[np.ix_(dsel, gsel)]
                    di, gi = _match_frame(sub, thr)
                    tp += len(di)
                    if len(di):
                        tph += float(np.sum(heading_accuracy(
                            d[di, 6], g[gi, 6])))
                    fp += len(d) - len(di)
                    fn += len(g) - len(di)
                for name, meas in (('AP', tp), ('APH', tph)):
                    p = meas / (meas + fp) if (meas + fp) > 0 else 0.0
                    r = meas / (meas + fn) if (meas + fn) > 0 else 0.0
                    prs[name][0].append(p)
                    prs[name][1].append(r)
            for name in ('AP', 'APH'):
                ap = _ap_from_pr(prs[name][0], prs[name][1])
                out[f'{cls}/L{level}/{name}'] = ap
                per_level_aps[level][name].append(ap)

    for level in (1, 2):
        for name in ('AP', 'APH'):
            vals = per_level_aps[level][name]
            out[f'm{name}_L{level}'] = float(np.mean(vals)) if vals else 0.0

    if logger is None:
        rows = [f"{k:24s} {v:.4f}" for k, v in out.items()]
        print('Waymo OD metrics\n' + '\n'.join(rows))
    return out
