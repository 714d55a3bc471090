"""KITTI raw -> info pkl converter.

Port of ``tools/data_converter/kitti_converter.py`` (the reference's
``kitti_converter.py`` and ``kitti_data_utils.py`` in one) on the port's
``datasets``, so it runs where there is no JAX::

    python -m mmdet3d_gaussian_tpu_torch.tools.data_converter.kitti_converter ROOT [--out-dir DIR]

writes ``kitti_infos_train.pkl`` and ``kitti_infos_val.pkl`` (and the
reduced clouds under ``training/velodyne_reduced``).  It produces
mmdet3d-compatible info dicts:
    {'point_cloud': {'velodyne_path'}, 'calib': {'R0_rect',
     'Tr_velo_to_cam', 'P2'}, 'annos': {name, location, dimensions,
     rotation_y, bbox, occluded, truncated, difficulty,
     num_points_in_gt}, 'plane' (optional)}
plus reduced point clouds (points inside image FOV).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np

from ...datasets.kitti import KittiDataset
from ...datasets.pipelines import _points_in_boxes_np


def read_calib(path):
    out = {}
    with open(path) as f:
        for line in f:
            if ':' not in line:
                continue
            k, v = line.split(':', 1)
            out[k.strip()] = np.array([float(x) for x in v.split()],
                                      np.float64)
    calib = {}
    calib['P2'] = out['P2'].reshape(3, 4)
    r0 = np.eye(4)
    r0[:3, :3] = out['R0_rect'].reshape(3, 3)
    calib['R0_rect'] = r0
    tr = np.eye(4)
    tr[:3] = out['Tr_velo_to_cam'].reshape(3, 4)
    calib['Tr_velo_to_cam'] = tr
    return calib


def read_label(path):
    names, trunc, occ, alpha, bbox, dims, loc, rot = ([] for _ in range(8))
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) < 15:
                continue
            names.append(p[0])
            trunc.append(float(p[1]))
            occ.append(int(float(p[2])))
            alpha.append(float(p[3]))
            bbox.append([float(x) for x in p[4:8]])
            dims.append([float(p[10]), float(p[8]), float(p[9])])  # l, h, w
            loc.append([float(x) for x in p[11:14]])
            rot.append(float(p[14]))
    return dict(name=np.array(names), truncated=np.array(trunc),
                occluded=np.array(occ), alpha=np.array(alpha),
                bbox=np.array(bbox).reshape(-1, 4),
                dimensions=np.array(dims).reshape(-1, 3),
                location=np.array(loc).reshape(-1, 3),
                rotation_y=np.array(rot))


def assign_difficulty(annos):
    """KITTI easy/moderate/hard rules (reference kitti_data_utils.py)."""
    min_h = (40, 25, 25)
    max_occ = (0, 1, 2)
    max_trunc = (0.15, 0.3, 0.5)
    n = len(annos['name'])
    diff = np.full(n, -1, np.int32)
    h = annos['bbox'][:, 3] - annos['bbox'][:, 1] if n else np.zeros(0)
    for d in (2, 1, 0):
        # STRICT h > min_h: the reference excludes `h <= min_height`
        # (kitti_data_utils.py:512) — a 40.00-px box is NOT easy
        ok = ((h > min_h[d]) & (annos['occluded'] <= max_occ[d])
              & (annos['truncated'] <= max_trunc[d]))
        diff[ok] = d
    annos['difficulty'] = diff
    return annos


def read_png_shape(path, default=(375, 1242)):
    """(H, W) from a PNG IHDR header without an image library."""
    try:
        with open(path, 'rb') as f:
            head = f.read(26)
        if head[:8] != b'\x89PNG\r\n\x1a\n':
            return np.array(default, np.int32)
        w = int.from_bytes(head[16:20], 'big')
        h = int.from_bytes(head[20:24], 'big')
        return np.array([h, w], np.int32)
    except OSError:
        return np.array(default, np.int32)


def points_in_rect_fov(points, calib, img_shape=(375, 1242)):
    """Mask of points projecting into the image."""
    pts = np.c_[points[:, :3], np.ones(len(points))]
    cam = pts @ (calib['R0_rect'] @ calib['Tr_velo_to_cam']).T
    depth_ok = cam[:, 2] > 0
    uvw = cam @ calib['P2'].T            # (N, 4) @ (4, 3) homogeneous
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-6)
    in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < img_shape[1])
              & (uv[:, 1] >= 0) & (uv[:, 1] < img_shape[0]))
    return depth_ok & in_img


def count_points_in_gt(points, annos, calib):
    if len(annos['name']) == 0:
        annos['num_points_in_gt'] = np.zeros(0, np.int32)
        return annos
    boxes = KittiDataset._cam_to_lidar_boxes(annos, calib)
    inside = _points_in_boxes_np(points[:, :3], boxes)
    annos['num_points_in_gt'] = inside.sum(0).astype(np.int32)
    return annos


def create_kitti_infos(root, split='training', ids=None,
                       save_reduced=True):
    id_file = {'training': 'train.txt', 'val': 'val.txt',
               'testing': 'test.txt'}
    if ids is None:
        split_path = osp.join(root, 'ImageSets',
                              id_file.get(split, 'train.txt'))
        if osp.exists(split_path):
            ids = [l.strip() for l in open(split_path) if l.strip()]
        else:
            vdir = osp.join(root, 'training', 'velodyne')
            ids = sorted(f[:-4] for f in os.listdir(vdir)
                         if f.endswith('.bin'))
    infos = []
    subdir = 'testing' if split == 'testing' else 'training'
    red_dir = osp.join(root, subdir, 'velodyne_reduced')
    if save_reduced:
        os.makedirs(red_dir, exist_ok=True)
    for idx in ids:
        info = {'point_cloud': {
            'velodyne_path': f'{subdir}/velodyne/{idx}.bin'}}
        calib = read_calib(osp.join(root, subdir, 'calib', f'{idx}.txt'))
        info['calib'] = calib
        img_path = osp.join(root, subdir, 'image_2', f'{idx}.png')
        info['image'] = {'image_path': f'{subdir}/image_2/{idx}.png',
                         'image_shape': read_png_shape(img_path)}
        pts = np.fromfile(osp.join(root, subdir, 'velodyne', f'{idx}.bin'),
                          np.float32).reshape(-1, 4)
        if save_reduced:
            fov = points_in_rect_fov(pts, calib)
            pts[fov].tofile(osp.join(red_dir, f'{idx}.bin'))
        label_path = osp.join(root, subdir, 'label_2', f'{idx}.txt')
        if osp.exists(label_path):
            annos = assign_difficulty(read_label(label_path))
            annos = count_points_in_gt(pts, annos, calib)
            info['annos'] = annos
        plane_path = osp.join(root, subdir, 'planes', f'{idx}.txt')
        if osp.exists(plane_path):
            with open(plane_path) as f:
                lines = f.readlines()
            info['plane'] = np.array([float(x) for x in lines[3].split()])
        infos.append(info)
    return infos


def main():
    p = argparse.ArgumentParser()
    p.add_argument('root', help='KITTI root dir')
    p.add_argument('--out-dir', default=None)
    args = p.parse_args()
    out = args.out_dir or args.root
    for split, name in (('training', 'train'), ('val', 'val')):
        infos = create_kitti_infos(args.root, split)
        path = osp.join(out, f'kitti_infos_{name}.pkl')
        with open(path, 'wb') as f:
            pickle.dump(infos, f)
        print(f'{path}: {len(infos)} frames')


if __name__ == '__main__':
    main()
