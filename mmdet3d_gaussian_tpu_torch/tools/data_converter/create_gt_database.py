"""Crop per-GT point patches -> GT database + dbinfos pkl for the sampler.

Port of ``tools/data_converter/create_gt_database.py`` (the reference's) on
the port's ``datasets``, so it runs where there is no JAX::

    python -m mmdet3d_gaussian_tpu_torch.tools.data_converter.create_gt_database ROOT [--info-path PKL]

writes the patches under ``ROOT/kitti_gt_database`` and
``ROOT/kitti_dbinfos_train.pkl`` from ``ROOT/kitti_infos_train.pkl``."""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np

from ...datasets.kitti import KittiDataset
from ...datasets.pipelines import _points_in_boxes_np


def create_groundtruth_database(data_root, info_path, out_dir=None,
                                db_name='kitti_gt_database'):
    out_dir = out_dir or data_root
    db_dir = osp.join(out_dir, db_name)
    os.makedirs(db_dir, exist_ok=True)
    with open(info_path, 'rb') as f:
        infos = pickle.load(f)

    db_infos = {}
    for info in infos:
        annos = info.get('annos')
        if annos is None or len(annos['name']) == 0:
            continue
        pts_path = osp.join(data_root, info['point_cloud']['velodyne_path'])
        points = np.fromfile(pts_path, np.float32).reshape(-1, 4)
        boxes = KittiDataset._cam_to_lidar_boxes(annos, info['calib'])
        inside = _points_in_boxes_np(points[:, :3], boxes)
        frame = osp.splitext(
            osp.basename(info['point_cloud']['velodyne_path']))[0]
        for i, name in enumerate(annos['name']):
            if name == 'DontCare':
                continue
            obj_pts = points[inside[:, i]].copy()
            obj_pts[:, :3] -= boxes[i, :3]      # center-relative patch
            fname = f'{frame}_{name}_{i}.bin'
            obj_pts.tofile(osp.join(db_dir, fname))
            db_infos.setdefault(name, []).append(dict(
                name=name, path=osp.join(db_name, fname),
                gt_idx=i, box3d_lidar=boxes[i].astype(np.float32),
                num_points_in_gt=int(inside[:, i].sum()),
                difficulty=int(annos.get('difficulty',
                                         [0] * len(boxes))[i])))
    db_path = osp.join(out_dir, 'kitti_dbinfos_train.pkl')
    with open(db_path, 'wb') as f:
        pickle.dump(db_infos, f)
    for k, v in db_infos.items():
        print(f'{k}: {len(v)} patches')
    return db_path


def main():
    p = argparse.ArgumentParser()
    p.add_argument('data_root')
    p.add_argument('--info-path', default=None)
    args = p.parse_args()
    create_groundtruth_database(
        args.data_root,
        args.info_path or osp.join(args.data_root,
                                   'kitti_infos_train.pkl'))


if __name__ == '__main__':
    main()
