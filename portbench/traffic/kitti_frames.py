"""KITTI frames as the 3-class configuration's training pipeline hands
them to the train step (``configs/_base_/datasets/kitti-3d-3class.py``).

The raw frame is the KITTI scene of the port's card smoke run
(``chip_smoke.py::kitti_scene``: a mix of Cars and Pedestrians beside one
Cyclist, apart from each other in the camera's sector) with the ground
and clutter drawn at a log-uniform range, so that their density a square
metre falls as 1/r^2 as a spinning sensor's does.  ``ObjectSample`` then
fills each class up to the pipeline's ``sample_groups``: as the GT
database sampler does, each missing object is drawn once, at a place of
the sector, and dropped where its BEV rectangle meets a box already kept;
a kept object brings its points and clears the scene's points inside it.
``Pad3D`` last: ``pad_points`` points (a random subset of a frame with
more) and ``pad_boxes`` box slots.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np

from .common import bev_overlap, box_points, in_any_box, pad3d

# class sizes (dx, dy, dz) in class order Pedestrian, Cyclist, Car, and
# the velodyne's height over the road
SIZES = ((0.8, 0.6, 1.73), (1.76, 0.6, 1.73), (3.9, 1.6, 1.56))
CLASSES = ('Pedestrian', 'Cyclist', 'Car')
GROUND_Z = -1.73
# the objects of the raw frames, cycled through the pool: 3-5 Cars and
# 1-2 Pedestrians beside one Cyclist
MIXES = [(cars, peds) for cars in (3, 4, 5) for peds in (1, 2)]


def _place(rng):
    x = rng.uniform(6.0, 55.0)
    return x, rng.uniform(-1, 1) * min(0.7 * x, 35.0)


def _box(rng, lab, x, y):
    dims = np.asarray(SIZES[lab]) * rng.uniform(0.9, 1.1, 3)
    return np.array([x, y, GROUND_Z, *dims, rng.uniform(-math.pi, math.pi)])


def _points_on(rng, boxes):
    """Each object's points: fewer with range and with a smaller side."""
    car = (SIZES[2][0] + SIZES[2][1]) * SIZES[2][2]
    side = (boxes[:, 3] + boxes[:, 4]) * boxes[:, 5] / car
    counts = np.clip(6000 / boxes[:, 0] * side, 10, 600).astype(int)
    return box_points(rng, boxes, counts)[0]


def scene(rng: np.random.Generator, p: Dict[str, Any],
          size: Dict[str, Any]):
    """One frame after ``ObjectSample``: (points (n, 4) x, y, z,
    reflectance; boxes (g, 7); labels (g,) int32 in class order)."""
    cars, peds = size['mix']
    labels = sorted([2] * cars + [0] * peds + [1])
    boxes = []
    for lab in labels:
        for _ in range(100):
            box = _box(rng, lab, *_place(rng))
            if not any(bev_overlap(box, b) for b in boxes):
                break
        boxes.append(box)
    n_raw = len(boxes)
    # the GT sampler: classes in the order of sample_groups, each missing
    # object drawn once and kept where it meets no kept box
    for name, group in p['sample_groups'].items():
        lab = CLASSES.index(name)
        for _ in range(max(int(group) - labels.count(lab), 0)):
            box = _box(rng, lab, *_place(rng))
            if not any(bev_overlap(box, b) for b in boxes):
                boxes.append(box)
                labels.append(lab)
    boxes = np.asarray(boxes, np.float64)
    raw_inside = _points_on(rng, boxes[:n_raw])
    sampled_inside = _points_on(rng, boxes[n_raw:])

    def sector(n):
        # the camera's field of view; log-uniform range, so the density a
        # square metre falls as 1/r^2
        r = np.exp(rng.uniform(math.log(p['min_range_m']),
                               math.log(p['max_range_m']), n))
        phi = rng.uniform(-1, 1, n) * math.radians(p['half_fov_deg'])
        x, y = r * np.cos(phi), r * np.sin(phi)
        keep = (x < 69.0) & (np.abs(y) < 39.6)
        return x[keep], y[keep]

    # the raw frame holds size['points'] points; the scene's points inside
    # a sampled box are cleared
    n_rest = size['points'] - len(raw_inside)
    n_clutter = int(p['clutter_points'])
    rest = []
    while sum(len(r) for r in rest) < n_rest:
        gx, gy = sector(n_rest - n_clutter)
        cx, cy = sector(n_clutter)
        pts = np.r_[np.c_[gx, gy, GROUND_Z + rng.normal(0, 0.03, len(gx))],
                    np.c_[cx, cy, rng.uniform(GROUND_Z, 0.8, len(cx))]]
        rest.append(pts[~in_any_box(pts, boxes)])
    rest = np.concatenate(rest)[:n_rest]
    pts = np.r_[raw_inside, rest, sampled_inside]
    pts = np.c_[pts, rng.random(len(pts))].astype(np.float32)
    return (pts[rng.permutation(len(pts))], boxes.astype(np.float32),
            np.asarray(labels, np.int32))


def make_batch(p: Dict[str, Any], rng: np.random.Generator, sizes):
    """A batch of frames of ``sizes`` (one dict a frame) through ``Pad3D``."""
    frames = [scene(rng, p, size) for size in sizes]
    return pad3d(rng, frames, p['pad_points'], p['pad_boxes'], 4, 7)
