"""Data pipeline transforms (NumPy, host-side).

A copy of ``mmdet3d_gaussian_tpu/datasets/pipelines.py`` (the port imports
nothing of the JAX package): the same transforms give the same arrays bit
for bit, random draws included.

Re-provision of the reference's pipeline layer
(``mmdet3d_gaussian/datasets/pipelines/``) plus the upstream
mmdet3d transforms its configs compose
(``configs/_base_/datasets/kitti-3d-3class.py``): loading, GT-database
sampling hook, flip/rot/scale augmentation, range filters, shuffle, and the
repo's own ``NormalizeIntensityTanh`` / ``LabelIDMap`` / tolerant loader.

Every transform is a callable on a results dict with keys:
    points (N, C) float32; gt_bboxes (G, 7[+]) float32; gt_labels (G,) int64
and composes via :class:`Compose`.  The final ``Pad3D`` produces the
static-shape arrays the train step consumes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..registry import PIPELINES


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    """Map angle into [-offset*period, (1-offset)*period), in the array's
    dtype (``core.bbox.structures.limit_period`` on numpy arrays)."""
    return val - np.floor(val / period + offset) * period


@PIPELINES.register_module()
class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = [PIPELINES.build(t) if isinstance(t, dict) else t
                           for t in transforms]

    def __call__(self, results: Dict) -> Optional[Dict]:
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


@PIPELINES.register_module()
class LoadPointsFromFile:
    """Tolerant point loading: .npy or raw float32 .bin fallback (reference
    ``datasets/pipelines/loading.py:7-30``)."""

    def __init__(self, load_dim: int = 4, use_dim=4, coord_type='LIDAR'):
        self.load_dim = load_dim
        self.use_dim = list(range(use_dim)) if isinstance(use_dim, int) \
            else list(use_dim)

    def __call__(self, results):
        path = results['pts_filename']
        if path.endswith('.npy'):
            points = np.load(path)
        else:
            try:
                points = np.fromfile(path, dtype=np.float32)
            except Exception:
                points = np.load(path, allow_pickle=True)
        points = points.reshape(-1, self.load_dim)[:, self.use_dim]
        results['points'] = points.astype(np.float32)
        return results


@PIPELINES.register_module()
class LoadPointsFromMultiSweeps:
    """Aggregate previous lidar sweeps into the key frame (upstream
    mmdet3d ``LoadPointsFromMultiSweeps``, used by every reference nuScenes
    config: sweeps_num=9, pad_empty_sweeps, remove_close —
    ``configs/nuscenes/centerpoint_02pillar_second_secfpn_8x4_cyclic_20e_nus.py:71-77``).

    Each sweep is loaded from ``results['sweeps'][i]['data_path']``,
    ego-motion-compensated with ``sensor2lidar_rotation``/``translation``,
    time-stamped in column 4 (key frame = 0, sweeps = lag in seconds), and
    concatenated.  ``remove_close`` drops points within ``close_radius`` of
    the sensor in BEV (ego returns).  With no sweeps and
    ``pad_empty_sweeps``, the key frame is replicated ``sweeps_num`` times.
    """

    def __init__(self, sweeps_num: int = 10, load_dim: int = 5,
                 use_dim=(0, 1, 2, 3, 4), pad_empty_sweeps: bool = False,
                 remove_close: bool = False, close_radius: float = 1.0,
                 test_mode: bool = False, seed: int = 0):
        self.sweeps_num = sweeps_num
        self.load_dim = load_dim
        self.use_dim = list(use_dim)
        self.pad_empty_sweeps = pad_empty_sweeps
        self.remove_close = remove_close
        self.close_radius = close_radius
        self.test_mode = test_mode
        self.rng = np.random.RandomState(seed)

    def _remove_close(self, points):
        near = ((np.abs(points[:, 0]) < self.close_radius)
                & (np.abs(points[:, 1]) < self.close_radius))
        return points[~near]

    def _load(self, path):
        if path.endswith('.npy'):
            pts = np.load(path)
        else:
            pts = np.fromfile(path, dtype=np.float32)
        return pts.reshape(-1, self.load_dim).astype(np.float32)

    def __call__(self, results):
        points = np.asarray(results['points'], np.float32)
        if points.shape[1] < 5:
            points = np.c_[points,
                           np.zeros((len(points), 5 - points.shape[1]),
                                    np.float32)]
        points[:, 4] = 0.0                    # key-frame time lag
        ts = float(results.get('timestamp', 0.0))
        sweeps = results.get('sweeps', []) or []
        out = [points]
        if self.pad_empty_sweeps and len(sweeps) == 0:
            for _ in range(self.sweeps_num):
                out.append(self._remove_close(points)
                           if self.remove_close else points)
        else:
            if len(sweeps) <= self.sweeps_num:
                choices = np.arange(len(sweeps))
            elif self.test_mode:
                choices = np.arange(self.sweeps_num)
            else:
                choices = self.rng.choice(len(sweeps), self.sweeps_num,
                                          replace=False)
            for idx in choices:
                sweep = sweeps[int(idx)]
                ps = self._load(sweep['data_path'])
                if self.remove_close:
                    ps = self._remove_close(ps)
                rot = np.asarray(sweep['sensor2lidar_rotation'], np.float32)
                ps[:, :3] = ps[:, :3] @ rot.T
                ps[:, :3] += np.asarray(sweep['sensor2lidar_translation'],
                                        np.float32)
                ps[:, 4] = ts - float(sweep['timestamp']) / 1e6
                out.append(ps)
        results['points'] = np.concatenate(out, 0)[:, self.use_dim]
        return results


@PIPELINES.register_module()
class PointsRangeFilter:
    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, results):
        p = results['points']
        m = ((p[:, 0] >= self.pcr[0]) & (p[:, 0] < self.pcr[3])
             & (p[:, 1] >= self.pcr[1]) & (p[:, 1] < self.pcr[4])
             & (p[:, 2] >= self.pcr[2]) & (p[:, 2] < self.pcr[5]))
        results['points'] = p[m]
        return results


@PIPELINES.register_module()
class ObjectRangeFilter:
    """Drop GT boxes whose BEV center leaves the range; wrap yaw."""

    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, results):
        gt = results['gt_bboxes']
        m = ((gt[:, 0] >= self.pcr[0]) & (gt[:, 0] < self.pcr[3])
             & (gt[:, 1] >= self.pcr[1]) & (gt[:, 1] < self.pcr[4]))
        results['gt_bboxes'] = gt[m]
        results['gt_labels'] = results['gt_labels'][m]
        results['gt_bboxes'][:, 6] = np.asarray(
            limit_period(results['gt_bboxes'][:, 6], 0.5, 2 * np.pi))
        return results


@PIPELINES.register_module()
class PointShuffle:
    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.RandomState(seed)

    def __call__(self, results):
        perm = self.rng.permutation(len(results['points']))
        results['points'] = results['points'][perm]
        return results


@PIPELINES.register_module()
class RandomFlip3D:
    """BEV flip along y (and optionally x), applied to points + boxes."""

    def __init__(self, flip_ratio_bev_horizontal: float = 0.5,
                 flip_ratio_bev_vertical: float = 0.0,
                 seed: Optional[int] = None):
        self.ratio_h = flip_ratio_bev_horizontal
        self.ratio_v = flip_ratio_bev_vertical
        self.rng = np.random.RandomState(seed)

    def __call__(self, results):
        if self.rng.rand() < self.ratio_h:    # flip y
            results['points'][:, 1] *= -1
            gt = results['gt_bboxes']
            gt[:, 1] *= -1
            gt[:, 6] = -gt[:, 6]
            if gt.shape[1] > 8:               # velocity vy flips with y
                gt[:, 8] *= -1
        if self.rng.rand() < self.ratio_v:    # flip x
            results['points'][:, 0] *= -1
            gt = results['gt_bboxes']
            gt[:, 0] *= -1
            gt[:, 6] = np.pi - gt[:, 6]
            if gt.shape[1] > 7:               # velocity vx flips with x
                gt[:, 7] *= -1
        return results


@PIPELINES.register_module()
class GlobalRotScaleTrans:
    def __init__(self, rot_range=(-0.78539816, 0.78539816),
                 scale_ratio_range=(0.95, 1.05),
                 translation_std=(0., 0., 0.), seed: Optional[int] = None):
        self.rot_range = rot_range
        self.scale_range = scale_ratio_range
        self.trans_std = np.asarray(translation_std, np.float32)
        self.rng = np.random.RandomState(seed)

    def __call__(self, results):
        angle = self.rng.uniform(*self.rot_range)
        scale = self.rng.uniform(*self.scale_range)
        trans = self.rng.randn(3).astype(np.float32) * self.trans_std
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s], [s, c]], np.float32)

        p = results['points']
        p[:, 0:2] = p[:, 0:2] @ rot.T
        p[:, 0:3] = p[:, 0:3] * scale + trans
        gt = results['gt_bboxes']
        gt[:, 0:2] = gt[:, 0:2] @ rot.T
        gt[:, 0:3] = gt[:, 0:3] * scale + trans
        gt[:, 3:6] *= scale
        gt[:, 6] += angle
        if gt.shape[1] > 7:       # velocities
            gt[:, 7:9] = gt[:, 7:9] @ rot.T * scale
        return results


@PIPELINES.register_module()
class NormalizeIntensityTanh:
    """intensity -> post_gain * tanh(pre_gain * i) (reference
    ``transfroms_3d.py:6-28``).  The intensity's column is
    ``intensity_column``, the reference's name, which the Waymo configs
    pass (the JAX package names it ``intensity_dim`` and so cannot build
    their pipelines)."""

    def __init__(self, pre_gain: float = 1.0, post_gain: float = 1.0,
                 intensity_column: int = 3):
        self.pre_gain, self.post_gain = pre_gain, post_gain
        self.dim = intensity_column

    def __call__(self, results):
        p = results['points']
        p[:, self.dim] = self.post_gain * np.tanh(self.pre_gain
                                                  * p[:, self.dim])
        return results


@PIPELINES.register_module()
class LabelIDMap:
    """Remap label ids (reference ``transfroms_3d.py:31-64``)."""

    def __init__(self, mapping: Dict[int, int]):
        self.mapping = dict(mapping)

    def __call__(self, results):
        lab = results['gt_labels']
        out = np.array([self.mapping.get(int(l), -1) for l in lab],
                       dtype=np.int64)
        keep = out >= 0
        results['gt_labels'] = out[keep]
        results['gt_bboxes'] = results['gt_bboxes'][keep]
        return results


@PIPELINES.register_module()
class ObjectSample:
    """GT-database copy-paste hook (reference ``ObjectSampleRev``,
    ``transfroms_3d.py:67-158``): delegates to a DataBaseSampler instance."""

    def __init__(self, db_sampler, use_ground_plane: bool = False):
        from .dbsampler import DataBaseSampler
        if isinstance(db_sampler, dict):
            db_sampler = DataBaseSampler(**{k: v for k, v in
                                            db_sampler.items()
                                            if k != 'type'})
        self.db_sampler = db_sampler
        self.use_ground_plane = use_ground_plane

    def __call__(self, results):
        plane = results.get('plane') if self.use_ground_plane else None
        sampled = self.db_sampler.sample_all(
            results['gt_bboxes'], results['gt_labels'], ground_plane=plane)
        if sampled is None:
            return results
        new_boxes = sampled['gt_bboxes']
        width = results['gt_bboxes'].shape[1] \
            if results['gt_bboxes'].size else new_boxes.shape[1]
        if new_boxes.shape[1] < width:   # pad zero velocities (nuScenes)
            new_boxes = np.concatenate(
                [new_boxes, np.zeros((len(new_boxes),
                                      width - new_boxes.shape[1]),
                                     new_boxes.dtype)], 1)
        results['gt_bboxes'] = np.concatenate(
            [results['gt_bboxes'].reshape(-1, width), new_boxes], 0)
        results['gt_labels'] = np.concatenate(
            [results['gt_labels'], sampled['gt_labels']], 0)
        # remove original points inside sampled boxes, then paste points
        pts = results['points']
        keep = ~_points_in_boxes_np(pts[:, :3],
                                    sampled['gt_bboxes']).any(-1)
        results['points'] = np.concatenate(
            [sampled['points'], pts[keep]], 0)
        return results


def _points_in_boxes_np(xyz: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(P, 3) x (B, 7) -> (P, B) bool, z-inclusive."""
    if len(boxes) == 0:
        return np.zeros((len(xyz), 0), bool)
    d = xyz[:, None, 0:2] - boxes[None, :, 0:2]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    lx = c[None] * d[..., 0] + s[None] * d[..., 1]
    ly = -s[None] * d[..., 0] + c[None] * d[..., 1]
    in_bev = (np.abs(lx) <= boxes[None, :, 3] / 2) & \
             (np.abs(ly) <= boxes[None, :, 4] / 2)
    in_z = (xyz[:, None, 2] >= boxes[None, :, 2]) & \
           (xyz[:, None, 2] <= boxes[None, :, 2] + boxes[None, :, 5])
    return in_bev & in_z


@PIPELINES.register_module()
class Pad3D:
    """Pad to static shapes for the train step: points (N_max, C) + mask,
    gt (G_max, 7) + labels + valid."""

    def __init__(self, num_points: int, num_gt: int = 64):
        self.num_points = num_points
        self.num_gt = num_gt

    def __call__(self, results):
        p = results['points']
        n, c = p.shape
        if n >= self.num_points:
            sel = np.random.choice(n, self.num_points, replace=False) \
                if n > self.num_points else np.arange(n)
            points = p[sel]
            mask = np.ones(self.num_points, bool)
        else:
            points = np.concatenate(
                [p, np.zeros((self.num_points - n, c), p.dtype)], 0)
            mask = np.arange(self.num_points) < n

        gt = results.get('gt_bboxes', np.zeros((0, 7), np.float32))
        lab = results.get('gt_labels', np.zeros((0,), np.int64))
        g = min(len(gt), self.num_gt)
        gt_pad = np.zeros((self.num_gt, gt.shape[1] if gt.size else 7),
                          np.float32)
        lab_pad = np.zeros((self.num_gt,), np.int32)
        gt_pad[:g] = gt[:g]
        lab_pad[:g] = lab[:g]
        valid = np.arange(self.num_gt) < g
        return dict(points=points.astype(np.float32), points_mask=mask,
                    gt_bboxes=gt_pad, gt_labels=lab_pad, gt_valid=valid,
                    meta={k: v for k, v in results.items()
                          if k not in ('points', 'gt_bboxes', 'gt_labels')})


def collate_batch(samples: List[Dict]) -> Dict:
    """Stack padded samples into the batch dict the train step consumes."""
    out = {}
    for key in ('points', 'points_mask', 'gt_bboxes', 'gt_labels',
                'gt_valid'):
        out[key] = np.stack([s[key] for s in samples], 0)
    out['metas'] = [s.get('meta', {}) for s in samples]
    return out


@PIPELINES.register_module()
class ObjectNoise:
    """Per-object pose noise with collision rejection (upstream mmdet3d
    ``ObjectNoise`` / SECOND's ``noise_per_object_v3_``; every reference
    KITTI base pipeline applies it after ObjectSample —
    ``configs/_base_/datasets/kitti-3d-3class.py:37-42``).

    For each gt box, draw up to ``num_try`` (translation, yaw) candidates;
    apply the first whose noised BEV rectangle does not overlap any OTHER
    current gt box.  The box's interior points rotate about the box center
    with it and translate along.
    """

    def __init__(self, num_try: int = 100,
                 translation_std=(1.0, 1.0, 0.0),
                 global_rot_range=(0.0, 0.0),
                 rot_range=(-0.78539816, 0.78539816), seed: int = 0):
        assert tuple(global_rot_range) == (0.0, 0.0), \
            'per-object global rotation noise is not supported (every ' \
            'reference config zeroes it)'
        self.num_try = num_try
        self.translation_std = np.asarray(translation_std, np.float64)
        self.rot_range = rot_range
        self.rng = np.random.RandomState(seed)

    @staticmethod
    def _in_box(points, box):
        d = points[:, :2] - box[0:2]
        c, s = np.cos(box[6]), np.sin(box[6])
        lx = c * d[:, 0] + s * d[:, 1]
        ly = -s * d[:, 0] + c * d[:, 1]
        return ((np.abs(lx) <= box[3] / 2) & (np.abs(ly) <= box[4] / 2)
                & (points[:, 2] >= box[2]) & (points[:, 2] <= box[2]
                                              + box[5]))

    def __call__(self, results):
        from ..core.evaluation.geometry_np import rotated_intersection_area
        boxes = results['gt_bboxes']
        points = results['points']
        g = len(boxes)
        if g == 0:
            return results
        trans = self.rng.normal(
            scale=self.translation_std, size=(g, self.num_try, 3))
        angles = self.rng.uniform(self.rot_range[0], self.rot_range[1],
                                  (g, self.num_try))
        for i in range(g):
            others = np.delete(boxes, i, axis=0)
            cand = np.tile(boxes[i][None], (self.num_try, 1))
            cand[:, 0:3] += trans[i]
            cand[:, 6] += angles[i]
            if len(others):
                bev = np.c_[cand[:, 0:2], cand[:, 3:5], cand[:, 6:7]]
                obev = np.c_[others[:, 0:2], others[:, 3:5], others[:, 6:7]]
                inter = rotated_intersection_area(
                    bev.astype(np.float64), obev.astype(np.float64))
                ok = (inter < 1e-9).all(axis=1)
            else:
                ok = np.ones(self.num_try, bool)
            hits = np.flatnonzero(ok)
            if len(hits) == 0:
                continue                       # keep the original pose
            k = hits[0]
            mask = self._in_box(points, boxes[i])
            ctr = boxes[i][0:3].copy()
            a = angles[i, k]
            c, s = np.cos(a), np.sin(a)
            d = points[mask, 0:2] - ctr[None, 0:2]
            points[mask, 0] = c * d[:, 0] - s * d[:, 1] + ctr[0]
            points[mask, 1] = s * d[:, 0] + c * d[:, 1] + ctr[1]
            points[mask, 0:3] += trans[i, k][None]
            boxes[i] = cand[k]
        results['points'] = points
        results['gt_bboxes'] = boxes
        return results
