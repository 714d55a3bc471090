"""Dataset wrappers ``RepeatDataset`` and ``CBGSDataset``,
``WaymoDataset``, ``CowaDataset`` and ``NuScenesDataset``.

Port of ``mmdet3d_gaussian_tpu/datasets/other_datasets.py``: the KITTI
configs' train split is a ``RepeatDataset`` (times=2), the Waymo configs
read ``WaymoDataset``, the nuScenes configs ``NuScenesDataset`` under
``CBGSDataset``; ``CowaDataset`` is the 8-class KITTI-format family with
its range-breakdown report.
"""
from __future__ import annotations

import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from ..core.evaluation.mean_ap import eval_map_flexible
from ..registry import DATASETS
from .kitti import KittiDataset
from .mem_util import SharedList
from .pipelines import Compose


@DATASETS.register_module()
class RepeatDataset:
    """Repeat a dataset N times per epoch (upstream mmdet RepeatDataset —
    the reference KITTI bases wrap train with times=2,
    ``configs/_base_/datasets/kitti-3d-3class.py:107-109``, making
    cyclic_40e an effective 80-epoch schedule)."""

    def __init__(self, dataset, times: int):
        self.dataset = (DATASETS.build(dataset) if isinstance(dataset, dict)
                        else dataset)
        self.times = int(times)
        self.CLASSES = self.dataset.CLASSES

    def __len__(self):
        return self.times * len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def get_ann_info(self, idx):
        return self.dataset.get_ann_info(idx % len(self.dataset))

    def evaluate(self, *args, **kwargs):
        return self.dataset.evaluate(*args, **kwargs)


@DATASETS.register_module()
class CBGSDataset:
    """Class-balanced grouping and sampling (the CBGS paper's resampling;
    upstream mmdet3d ``CBGSDataset`` — the reference nuScenes config wraps
    train with it,
    ``configs/nuscenes/centerpoint_02pillar_second_secfpn_8x4_cyclic_20e_nus.py:156-158``).

    Each sample index is duplicated so every class's share of (sample,
    class) memberships approaches 1/num_classes."""

    def __init__(self, dataset, seed: int = 0):
        self.dataset = (DATASETS.build(dataset) if isinstance(dataset, dict)
                        else dataset)
        self.CLASSES = self.dataset.CLASSES
        rng = np.random.RandomState(seed)
        ncls = len(self.CLASSES)
        cls_inds = {c: [] for c in range(ncls)}
        for idx in range(len(self.dataset)):
            labels = np.unique(self.dataset.get_ann_info(idx)['gt_labels'])
            for lab in labels:
                if 0 <= int(lab) < ncls:
                    cls_inds[int(lab)].append(idx)
        total = sum(len(v) for v in cls_inds.values())
        frac = 1.0 / max(ncls, 1)
        indices = []
        for inds in cls_inds.values():
            if not inds or not total:
                continue
            ratio = frac / (len(inds) / total)
            indices.extend(rng.choice(
                inds, int(len(inds) * ratio)).tolist())
        self.indices = indices or list(range(len(self.dataset)))

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def get_ann_info(self, idx):
        return self.dataset.get_ann_info(self.indices[idx])

    def evaluate(self, *args, **kwargs):
        return self.dataset.evaluate(*args, **kwargs)


@DATASETS.register_module()
class WaymoDataset(KittiDataset):
    """KITTI-format Waymo infos (reference ``waymo_dataset.py:8-13``), the
    annotation list optionally shared through ``/dev/shm``
    (``use_shared_memory``) so the loader's workers map one copy."""
    CLASSES = ('Car', 'Pedestrian', 'Cyclist')

    def __init__(self, *args, use_shared_memory: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        if use_shared_memory:
            self.data_infos = SharedList(list(self.data_infos))

    def evaluate(self, results, metric='waymo', logger=None, **kwargs):
        """'waymo' = the Waymo OD protocol (mAP / mAPH at LEVEL_1 and
        LEVEL_2, Hungarian matching, per-class 3D-IoU thresholds 0.7 /
        0.5 / 0.5: ``core/evaluation/waymo_metrics.py``); 'cowa' (any other
        name) = flexible IoU3D mAP with a range breakdown."""
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        if metric in ('waymo', ['waymo']):
            from ..core.evaluation.waymo_metrics import eval_waymo
            return eval_waymo(results, annotations,
                              classes=list(self.CLASSES), logger=logger)
        return eval_map_flexible(
            results, annotations, match_thrs=[0.7, 0.5],
            affinity_calculator=dict(type='LidarIOU3D', z_offset=0.5),
            classes=list(self.CLASSES), logger=logger,
            breakdowns=[dict(type='RangeBreakdown',
                             ranges=dict(D0_30=(0, 30), D30_50=(30, 50),
                                         D50_inf=(50, 1e5)))],
            report_config=[
                ('mAP_L_0.7', lambda k: (k['breakdown'] == 'All'
                                         and k['match_threshold'] == 0.7)),
                ('mAP', lambda k: k['breakdown'] == 'All'),
            ])


@DATASETS.register_module()
class CowaDataset(KittiDataset):
    """8-class in-house KITTI-format dataset (reference
    ``cowa_dataset.py:10-235``): GT boxes outside
    ``eval_point_cloud_range`` (x, y) are ignored in evaluation, and the
    report is the flexible IoU3D mAP at 0.7 / 0.5 / 0.3 with a range
    breakdown (``mAP``, ``mAP_near`` for 0-30 m)."""
    CLASSES = ('car', 'truck', 'bus', 'engineering_vehicle', 'pedestrian',
               'bicycle', 'tricycle', 'cone')

    def __init__(self, *args, eval_point_cloud_range=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.eval_point_cloud_range = eval_point_cloud_range

    def get_ann_info(self, idx):
        ann = super().get_ann_info(idx)
        # GTs outside the eval range become ignore (reference :176-180)
        if self.eval_point_cloud_range is not None and len(
                ann['gt_bboxes']):
            pcr = np.asarray(self.eval_point_cloud_range)
            xy = ann['gt_bboxes'][:, :2]
            inside = ((xy[:, 0] >= pcr[0]) & (xy[:, 0] < pcr[3])
                      & (xy[:, 1] >= pcr[1]) & (xy[:, 1] < pcr[4]))
            ann['gt_attrs']['ignore'] = ~inside
        return ann

    def evaluate(self, results, metric='cowa', logger=None, **kwargs):
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        return eval_map_flexible(
            results, annotations, match_thrs=[0.7, 0.5, 0.3],
            affinity_calculator=dict(type='LidarIOU3D', z_offset=0.5),
            classes=list(self.CLASSES), logger=logger,
            breakdowns=[dict(type='RangeBreakdown',
                             ranges=dict(D0_30=(0, 30), D30_50=(30, 50),
                                         D50_inf=(50, 1e5)))],
            report_config=[
                ('mAP', lambda k: k['breakdown'] == 'All'),
                ('mAP_near', lambda k: k['breakdown'] == 'D0_30'),
            ])


@DATASETS.register_module()
class NuScenesDataset:
    """nuScenes 10-class dataset over mmdet3d-style info pickles: 5-dim
    points (aggregated over sweeps by the pipeline), 9-DoF boxes (7 +
    velocity) when ``with_velocity``."""
    CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
               'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone',
               'barrier')

    def __init__(self, data_root: str, ann_file: str, pipeline: Sequence,
                 classes: Optional[Sequence[str]] = None,
                 test_mode: bool = False, with_velocity: bool = True):
        self.data_root = data_root
        self.test_mode = test_mode
        self.with_velocity = with_velocity
        self.CLASSES = tuple(classes) if classes else NuScenesDataset.CLASSES
        self.cat2label = {c: i for i, c in enumerate(self.CLASSES)}
        with open(ann_file, 'rb') as f:
            data = pickle.load(f)
        self.data_infos = data['infos'] if isinstance(data, dict) else data
        self.pipeline = Compose(pipeline)

    def __len__(self):
        return len(self.data_infos)

    def get_ann_info(self, idx) -> Dict:
        info = self.data_infos[idx]
        boxes = np.asarray(info['gt_boxes'], np.float32).reshape(-1, 7)
        names = info['gt_names']
        keep = [i for i, n in enumerate(names) if n in self.cat2label]
        labels = np.array([self.cat2label[names[i]] for i in keep], np.int64)
        boxes = boxes[keep]
        if self.with_velocity and 'gt_velocity' in info:
            vel = np.asarray(info['gt_velocity'], np.float32)[keep]
            boxes = np.concatenate([boxes, np.nan_to_num(vel)], -1)
        return dict(gt_bboxes=boxes, gt_labels=labels, gt_attrs={})

    def __getitem__(self, idx):
        info = self.data_infos[idx]
        # multi-sweep inputs of the mmdet3d info schema; the infos'
        # timestamps are in microseconds
        results = dict(pts_filename=info['lidar_path'], sample_idx=idx,
                       sweeps=info.get('sweeps', []),
                       timestamp=float(info.get('timestamp', 0)) / 1e6)
        ann = self.get_ann_info(idx)
        results['gt_bboxes'] = ann['gt_bboxes'].copy()
        results['gt_labels'] = ann['gt_labels'].copy()
        return self.pipeline(results)

    def evaluate(self, results, metric='nds', logger=None, **kwargs):
        """``'nds'`` (the default): the nuScenes devkit's detection metric
        rebuilt in numpy (centre-distance mAP at 0.5, 1, 2 and 4 m, the TP
        errors at 2 m, NDS; ``core/evaluation/nuscenes_metrics.py``).
        Any other ``metric`` (``'iou3d_err'``): IoU3D-matched flexible mAP
        under the reference's ``mAIE`` report name, on the boxes' first 7
        columns (the JAX package hands the evaluator the 9-column boxes,
        which it cannot reshape to 7, and raises)."""
        annotations = [self.get_ann_info(i) for i in range(len(self))]
        if metric in ('nds', ['nds'], None):
            from ..core.evaluation.nuscenes_metrics import nuscenes_eval
            rep, report = nuscenes_eval(results, annotations,
                                        list(self.CLASSES))
            if logger is None:
                print('\n' + report)
            return rep
        annotations = [dict(a, gt_bboxes=a['gt_bboxes'][:, :7])
                       for a in annotations]
        return eval_map_flexible(
            results, annotations, match_thrs=[0.5, 0.7],
            affinity_calculator=dict(type='LidarIOU3D', z_offset=0.5),
            classes=list(self.CLASSES), logger=logger,
            report_config=[('mAIE', lambda k: k['breakdown'] == 'All')])
