"""Native nuScenes detection metrics: center-distance mAP + TP errors + NDS.

The port's own copy of ``mmdet3d_gaussian_tpu/core/evaluation/
nuscenes_metrics.py`` (numpy only; the port imports nothing of the JAX
package).

The reference inherits the full nuScenes devkit evaluation through upstream
mmdet3d and only renames ``iou3d_err -> mAIE``
(the reference's ``datasets/nuscenes_dataset.py:6-14``).
This module rebuilds the devkit's detection metric natively
(nuscenes-devkit ``evaluate.py`` / ``algo.py`` semantics):

  * greedy matching by BEV center distance at thresholds {0.5, 1, 2, 4} m,
    dets visited in global descending-score order,
  * AP = 101-point interpolated precision, clipped below 10% recall and
    10% precision, normalized by 0.9,
  * TP errors at the 2 m threshold, averaged over the recall range
    [10%, max_recall] on the interpolated confidence grid:
      ATE (BEV centre L2), ASE (1 - aligned 3D IoU), AOE (yaw diff,
      period pi for barrier), AVE (velocity L2),
  * NDS = (5 * mAP + sum(1 - min(1, tp_err))) / (5 + num_tp_metrics).

Deviation from the devkit: evaluation runs in the LiDAR frame (per-frame
rigid transform of the devkit's global frame — centre distances, size
ratios and yaw differences are invariant).  Attribute errors (AAE): the
framework has no attribute head (neither does the reference), so detected
attributes come from the velocity/class heuristic mmdet3d uses when
formatting submissions (upstream ``nuscenes_dataset.py::_format_bbox``;
the reference inherits it): vehicles moving above 0.2 m/s ->
'vehicle.moving', cycles -> 'cycle.with_rider', else the per-class
default.  AAE is computed only when annotations carry ``gt_nus_attrs``
(ids into NUS_ATTRIBUTES, -1 = void); without them the NDS normalizes
over the metrics actually computed, as before.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DIST_THS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_INTERP = 101

# devkit class capability table (cfg 'detection_cvpr_2019')
NO_ORIENT = {'traffic_cone'}
NO_VEL = {'barrier', 'traffic_cone'}
NO_ATTR = {'barrier', 'traffic_cone'}
YAW_PERIOD_PI = {'barrier'}

TP_METRICS = ('trans_err', 'scale_err', 'orient_err', 'vel_err',
              'attr_err')
TP_LABELS = {'trans_err': 'mATE', 'scale_err': 'mASE',
             'orient_err': 'mAOE', 'vel_err': 'mAVE',
             'attr_err': 'mAAE'}

# nuScenes attribute vocabulary (ids used by gt_attrs / infer_attribute)
NUS_ATTRIBUTES = (
    'cycle.with_rider', 'cycle.without_rider',
    'pedestrian.moving', 'pedestrian.standing', 'pedestrian.sitting_lying_down',
    'vehicle.moving', 'vehicle.parked', 'vehicle.stopped',
)
_ATTR_ID = {a: i for i, a in enumerate(NUS_ATTRIBUTES)}

# mmdet3d DefaultAttribute table (upstream nuscenes_dataset.py)
DEFAULT_ATTRIBUTE = {
    'car': 'vehicle.parked', 'pedestrian': 'pedestrian.moving',
    'trailer': 'vehicle.parked', 'truck': 'vehicle.parked',
    'bus': 'vehicle.moving', 'motorcycle': 'cycle.without_rider',
    'construction_vehicle': 'vehicle.parked',
    'bicycle': 'cycle.without_rider', 'barrier': '', 'traffic_cone': '',
}


def infer_attribute(cls_name: str, det_row: np.ndarray) -> int:
    """mmdet3d submission-time attribute heuristic -> NUS_ATTRIBUTES id
    (-1 for attribute-less classes).  det_row columns 7:9 hold velocity
    when present."""
    if cls_name in NO_ATTR:
        return -1
    vel = float(np.hypot(det_row[7], det_row[8])) if len(det_row) >= 10 \
        else 0.0
    if vel > 0.2:
        if cls_name in ('car', 'construction_vehicle', 'bus', 'truck',
                        'trailer'):
            attr = 'vehicle.moving'
        elif cls_name in ('bicycle', 'motorcycle'):
            attr = 'cycle.with_rider'
        else:
            attr = DEFAULT_ATTRIBUTE.get(cls_name, '')
    else:
        if cls_name == 'pedestrian':
            attr = 'pedestrian.standing'
        elif cls_name == 'bus':
            attr = 'vehicle.stopped'
        else:
            attr = DEFAULT_ATTRIBUTE.get(cls_name, '')
    return _ATTR_ID.get(attr, -1)


def _yaw_diff(a: np.ndarray, b: np.ndarray, period: float) -> np.ndarray:
    d = (a - b) % period
    return np.minimum(d, period - d)


def _aligned_iou3d(d_dims: np.ndarray, g_dims: np.ndarray) -> np.ndarray:
    """3D IoU of centre/yaw-aligned boxes (devkit ``scale_iou``)."""
    mins = np.minimum(d_dims, g_dims)
    inter = np.prod(mins, -1)
    union = np.prod(d_dims, -1) + np.prod(g_dims, -1) - inter
    return inter / np.maximum(union, 1e-7)


class _MetricData:
    """Per (class, dist_th) accumulator — devkit ``DetectionMetricData``."""

    def __init__(self):
        self.conf: List[float] = []
        self.tp: List[int] = []
        self.fp: List[int] = []
        self.match_conf: List[float] = []
        self.errors: Dict[str, List[float]] = {m: [] for m in TP_METRICS}


def _accumulate(frames: Sequence[Tuple], cls_name: str, dist_th: float,
                collect_errors: bool) -> Tuple[_MetricData, int]:
    """frames: per frame (det_boxes (N,>=8 incl score last), gt_boxes
    (G,7|9)[, nus attr ids (G,)]).  Returns (metric data, npos)."""
    npos = 0
    rows = []                          # (score, frame_idx, det_row)
    for f, frame in enumerate(frames):
        det, gt = frame[0], frame[1]
        npos += len(gt)
        for row in det:
            rows.append((float(row[-1]), f, row))
    rows.sort(key=lambda r: -r[0])
    taken = [set() for _ in frames]
    md = _MetricData()
    period = np.pi if cls_name in YAW_PERIOD_PI else 2 * np.pi
    for score, f, det_row in rows:
        gt = frames[f][1]
        best, best_dist = -1, float(dist_th)
        for gi in range(len(gt)):
            if gi in taken[f]:
                continue
            dist = float(np.hypot(det_row[0] - gt[gi, 0],
                                  det_row[1] - gt[gi, 1]))
            if dist < best_dist:
                best_dist = dist
                best = gi
        if best >= 0:
            taken[f].add(best)
            md.tp.append(1)
            md.fp.append(0)
            if collect_errors:
                g = gt[best]
                md.match_conf.append(score)
                if cls_name not in NO_ATTR and len(frames[f]) > 2 \
                        and frames[f][2] is not None:
                    ga = int(frames[f][2][best])
                    if ga >= 0:   # devkit skips void-attribute GT
                        da = infer_attribute(cls_name, det_row)
                        md.errors['attr_err'].append(
                            0.0 if da == ga else 1.0)
                md.errors['trans_err'].append(best_dist)
                md.errors['scale_err'].append(
                    1.0 - float(_aligned_iou3d(det_row[3:6], g[3:6])))
                if cls_name not in NO_ORIENT:
                    md.errors['orient_err'].append(float(_yaw_diff(
                        np.asarray(det_row[6]), np.asarray(g[6]), period)))
                if cls_name not in NO_VEL and len(g) >= 9 \
                        and len(det_row) >= 10:
                    dv = np.asarray(det_row[7:9], np.float64) \
                        - np.asarray(g[7:9], np.float64)
                    md.errors['vel_err'].append(float(np.hypot(*dv)))
        else:
            md.tp.append(0)
            md.fp.append(1)
        md.conf.append(score)
    return md, npos


def _curves(md: _MetricData, npos: int):
    """Interpolated precision/confidence on the 101-point recall grid."""
    if npos == 0 or not md.conf:
        return None
    tp = np.cumsum(md.tp).astype(np.float64)
    fp = np.cumsum(md.fp).astype(np.float64)
    conf = np.asarray(md.conf, np.float64)
    rec = tp / npos
    prec = tp / np.maximum(tp + fp, 1e-9)
    rec_interp = np.linspace(0, 1, N_INTERP)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)
    return rec, prec_i, conf_i


def _calc_ap(prec_i: Optional[np.ndarray]) -> float:
    if prec_i is None:
        return 0.0
    p = prec_i[round(100 * MIN_RECALL) + 1:].copy()
    p -= MIN_PRECISION
    p[p < 0] = 0
    return float(np.mean(p)) / (1.0 - MIN_PRECISION)


def _calc_tp(md: _MetricData, npos: int, metric: str) -> float:
    """Mean error over the recall range [10%, max_recall] (devkit
    ``calc_tp`` on the interpolated confidence grid)."""
    errs = md.errors[metric]
    if npos == 0 or not md.match_conf or not errs:
        return 1.0
    curves = _curves(md, npos)
    if curves is None:
        return 1.0
    rec, _, conf_i = curves
    # devkit: max_recall_ind = last grid index with nonzero interpolated
    # confidence (np.nonzero(md.confidence)[0][-1]) — round(100*max_recall)
    # can land one grid point past it, pulling in a spurious left-clamped
    # interp term
    nz = np.nonzero(conf_i)[0]
    if len(nz) == 0:
        return 1.0
    max_recall_ind = int(nz[-1])
    first_ind = round(100 * MIN_RECALL) + 1
    if max_recall_ind < first_ind:
        return 1.0
    # cumulative mean of the error per TP, as a function of confidence
    cm = np.cumsum(errs) / np.arange(1, len(errs) + 1)
    mconf = np.asarray(md.match_conf, np.float64)
    # interp over DECREASING conf: flip to increasing for np.interp
    vals = np.interp(conf_i[first_ind:max_recall_ind + 1],
                     mconf[::-1], cm[::-1])
    return float(np.mean(vals))


def nuscenes_eval(det_results: Sequence[Sequence[np.ndarray]],
                  annotations: Sequence[Dict],
                  classes: Sequence[str],
                  dist_ths: Sequence[float] = DIST_THS,
                  dist_th_tp: float = DIST_TH_TP,
                  ) -> Tuple[Dict[str, float], str]:
    """det_results: per frame, per class (N, >=8) arrays with the score in
    the LAST column; columns 0:7 = LiDAR box, 7:9 = velocity when present.
    annotations: per frame dicts with 'gt_bboxes' (G, 7|9) and 'gt_labels'.
    """
    num_cls = len(classes)
    have_attrs = any('gt_nus_attrs' in ann for ann in annotations)
    per_class_frames = []
    for c in range(num_cls):
        frames = []
        for det, ann in zip(det_results, annotations):
            gt_boxes = np.asarray(ann['gt_bboxes'], np.float32)
            labels = np.asarray(ann['gt_labels']).reshape(-1)
            sel = labels == c
            attrs = None
            if 'gt_nus_attrs' in ann:
                attrs = np.asarray(ann['gt_nus_attrs'],
                                   np.int32).reshape(-1)[sel]
            frames.append((np.asarray(det[c], np.float32),
                           gt_boxes[sel], attrs))
        per_class_frames.append(frames)

    results: Dict[str, float] = {}
    ap_all = np.zeros((num_cls, len(dist_ths)))
    tp_err = {m: np.ones(num_cls) for m in TP_METRICS}
    for c, cname in enumerate(classes):
        for t, th in enumerate(dist_ths):
            is_tp_th = abs(th - dist_th_tp) < 1e-9
            md, npos = _accumulate(per_class_frames[c], cname, th,
                                   collect_errors=is_tp_th)
            curves = _curves(md, npos)
            ap_all[c, t] = _calc_ap(curves[1] if curves else None)
            if is_tp_th:
                for m in TP_METRICS:
                    tp_err[m][c] = _calc_tp(md, npos, m)
        results[f'{cname}_AP'] = float(ap_all[c].mean())
        for m in TP_METRICS:
            results[f'{cname}_{TP_LABELS[m][1:]}'] = float(tp_err[m][c])

    mean_ap = float(ap_all.mean())
    results['mAP'] = mean_ap
    active = {m: [] for m in TP_METRICS}
    for c, cname in enumerate(classes):
        for m in TP_METRICS:
            if m == 'orient_err' and cname in NO_ORIENT:
                continue
            if m == 'vel_err' and cname in NO_VEL:
                continue
            if m == 'attr_err' and (cname in NO_ATTR or not have_attrs):
                continue
            active[m].append(tp_err[m][c])
    n_tp_metrics = 0
    nds_sum = 5.0 * mean_ap
    for m in TP_METRICS:
        if not active[m]:
            continue
        v = float(np.mean(active[m]))
        results[TP_LABELS[m]] = v
        nds_sum += max(0.0, 1.0 - min(1.0, v))
        n_tp_metrics += 1
    results['NDS'] = nds_sum / (5.0 + n_tp_metrics)

    rows = [['Class', 'AP'] + [TP_LABELS[m][1:] for m in TP_METRICS]]
    for c, cname in enumerate(classes):
        rows.append([cname, f'{ap_all[c].mean():.4f}']
                    + [f'{tp_err[m][c]:.4f}' for m in TP_METRICS])
    rows.append(['mean', f'{mean_ap:.4f}']
                + [f'{results.get(TP_LABELS[m], float("nan")):.4f}'
                   for m in TP_METRICS])
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = ['  '.join(v.ljust(w) for v, w in zip(r, widths))
             for r in rows]
    lines.append(f'mAP: {mean_ap:.4f}   NDS: {results["NDS"]:.4f}')
    return results, '\n'.join(lines)
