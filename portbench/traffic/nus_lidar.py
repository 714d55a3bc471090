"""nuScenes frames as the CenterPoint configuration's test pipeline hands
them to the model (``configs/_base_/datasets/nus-3d.py``): the key frame
and ``sweeps - 1`` earlier sweeps of a spinning LiDAR
(``LoadPointsFromMultiSweeps``, ``sweeps_num=9``), each put into the key
frame's coordinates with its time lag as the fifth channel, cropped to
the point cloud range (``PointsRangeFilter``), then ``Pad3D``: a random
``pad_points`` of the frame's points.

The sensor is nuScenes' Velodyne HDL-32E as published: ``beams`` lasers
from ``elevation_deg[0]`` to ``[1]`` evenly, ``azimuth_steps`` a turn (at
20 Hz), ``sensor_height_m`` over the road, returns to ``max_range_m``
with ``range_noise_m`` of noise along the ray.  Each sweep casts every
ray from where the ego was ``lag`` seconds before the key frame (it
drives along +x at the frame's ``ego_speed_mps``; a sweep starts at a
random azimuth) into a street: a flat road, building rows along both
kerbs (``street_half_width_m`` from the centre), and the frame's objects
on the road, moved back along their velocity by the lag.  A ray returns
its nearest hit; a ray that hits nothing in range returns nothing.  So
the points of a frame, and the pillars they fill, follow from the sensor,
the street and the ego's motion, not from a chosen count.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np

from .common import bev_overlap, pad3d

# class sizes (dx, dy, dz) and speeds (m/s) in the dataset's class order:
# car, truck, trailer, bus, construction_vehicle, bicycle, motorcycle,
# pedestrian, traffic_cone, barrier
SIZES = ((4.6, 1.95, 1.73), (6.9, 2.5, 2.8), (12.3, 2.9, 3.9),
         (11.0, 2.9, 3.5), (6.4, 2.7, 3.2), (1.7, 0.6, 1.3),
         (2.1, 0.8, 1.5), (0.7, 0.7, 1.8), (0.4, 0.4, 1.1),
         (0.5, 2.5, 1.0))
SPEEDS = (10.0, 8.0, 5.0, 8.0, 2.0, 4.0, 8.0, 1.5, 0.0, 0.0)
# classes that drive along the road
ALONG_ROAD = (0, 1, 2, 3, 4, 5, 6)


def _objects(rng, p, size):
    """The frame's objects on the road: boxes (g, 9) x, y, z (bottom),
    dx, dy, dz, yaw, vx, vy and labels (g,)."""
    g, w = int(size['objects']), size['street_half_width_m']
    span, h = p['range'][3], p['sensor_height_m']
    boxes, labels = [], []
    for cls in rng.integers(0, len(SIZES), g):
        dims = np.asarray(SIZES[cls]) * rng.uniform(0.9, 1.1, 3)
        if cls in ALONG_ROAD:
            yaw = rng.normal(0.0, 0.1) + math.pi * rng.integers(0, 2)
        else:
            yaw = rng.uniform(-math.pi, math.pi)
        speed = SPEEDS[cls] * rng.uniform(0, 1)
        for _ in range(100):
            x = rng.uniform(-span + 2, span - 2)
            y = rng.uniform(-1, 1) * max(w - 1.0 - dims[1] / 2, 0.5)
            box = np.array([x, y, -h, *dims, yaw, speed * math.cos(yaw),
                            speed * math.sin(yaw)])
            ego = np.array([0.0, 0.0, -h, 5.0, 2.5, 1.8, 0.0])
            if not bev_overlap(box, ego) and \
                    not any(bev_overlap(box, b) for b in boxes):
                break
        boxes.append(box)
        labels.append(cls)
    return np.asarray(boxes), np.asarray(labels, np.int32)


def _buildings(rng, p, size):
    """Building rows along both kerbs: per side (y of the wall, starts,
    ends, heights) of segments from -1.5 to 1.5 times the range."""
    out = []
    lo, hi = -1.5 * p['range'][3], 1.5 * p['range'][3]
    for side in (1.0, -1.0):
        wall = side * (size['street_half_width_m']
                       + rng.uniform(*p['sidewalk_m']))
        starts, ends, heights = [], [], []
        x = lo + rng.uniform(0, p['building_gap_m'][1])
        while x < hi:
            length = rng.uniform(*p['building_len_m'])
            starts.append(x)
            ends.append(x + length)
            heights.append(rng.uniform(*p['building_height_m']))
            x += length + rng.uniform(*p['building_gap_m'])
        out.append((wall, np.asarray(starts), np.asarray(ends),
                    np.asarray(heights)))
    return out


def _sweep(rng, p, origin, boxes, buildings):
    """One turn of the sensor at ``origin`` -> the returns (n, 3)."""
    n_az, h = int(p['azimuth_steps']), p['sensor_height_m']
    el = np.radians(np.linspace(*p['elevation_deg'], int(p['beams'])))
    step = 2 * math.pi / n_az
    phase = rng.uniform(0, step) + step * rng.integers(0, n_az)
    az = phase + step * np.arange(n_az)
    d = np.stack(np.broadcast_arrays(
        np.cos(el)[:, None] * np.cos(az)[None],
        np.cos(el)[:, None] * np.sin(az)[None],
        np.sin(el)[:, None]), -1).reshape(-1, 3)
    t = np.full(len(d), np.inf)
    down = d[:, 2] < 0
    t[down] = -h / d[down, 2]
    for wall, starts, ends, heights in buildings:
        ok = d[:, 1] * wall > 0
        tw = np.full(len(d), np.inf)
        tw[ok] = (wall - origin[1]) / d[ok, 1]
        xh = origin[0] + tw * d[:, 0]
        zh = tw * d[:, 2]
        i = np.clip(np.searchsorted(starts, xh, 'right') - 1, 0, None)
        hit = ok & (xh >= starts[i]) & (xh < ends[i]) & (zh >= -h) \
            & (zh <= -h + heights[i])
        t = np.where(hit, np.minimum(t, tw), t)
    if len(boxes):
        t = np.minimum(t, _box_hits(origin, d, boxes, el, n_az, phase))
    keep = t <= p['max_range_m']
    r = t[keep] + rng.normal(0, p['range_noise_m'], int(keep.sum()))
    keep_close = r >= p['remove_close_m']
    return origin + r[keep_close, None] * d[keep][keep_close]


def _box_hits(origin, d, boxes, el, n_az, phase):
    """Each ray's distance to the nearest box it meets (inf if none): a
    slab test in each box's frame over the rays whose azimuth and
    elevation can meet the box, all boxes at once."""
    step = 2 * math.pi / n_az
    rel = boxes[:, :2] - origin[:2]
    dist = np.hypot(rel[:, 0], rel[:, 1])
    radius = 0.5 * np.hypot(boxes[:, 3], boxes[:, 4])
    ok = dist > radius
    boxes, rel, dist, radius = boxes[ok], rel[ok], dist[ok], radius[ok]
    half = np.arcsin(radius / dist)
    first = np.floor((np.arctan2(rel[:, 1], rel[:, 0]) - half - phase)
                     / step).astype(np.int64)
    n_cols = np.ceil(2 * half / step).astype(np.int64) + 2
    bottom = boxes[:, 2] - origin[2]
    top = bottom + boxes[:, 5]
    near, far = dist - radius, dist + radius
    lo_el = np.arctan2(bottom, np.where(bottom < 0, near, far))
    hi_el = np.arctan2(top, np.where(top > 0, near, far))
    j0 = np.searchsorted(el, lo_el)
    n_el = np.searchsorted(el, hi_el, 'right') - j0
    # (box, column) pairs, then the beams of each pair's box
    box_of = np.repeat(np.arange(len(boxes)), n_cols)
    col = (first[box_of] + np.arange(len(box_of))
           - np.repeat(np.cumsum(n_cols) - n_cols, n_cols)) % n_az
    per = n_el[box_of]
    box_of, col = np.repeat(box_of, per), np.repeat(col, per)
    beam = j0[box_of] + np.arange(len(box_of)) \
        - np.repeat(np.cumsum(per) - per, per)
    ray = beam * n_az + col
    b = boxes[box_of]
    c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
    ox = origin[0] - b[:, 0]
    oy = origin[1] - b[:, 1]
    lo = np.stack([c * ox + s * oy, -s * ox + c * oy,
                   origin[2] - b[:, 2] - b[:, 5] / 2], 1)
    dd = d[ray]
    ld = np.stack([c * dd[:, 0] + s * dd[:, 1],
                   -s * dd[:, 0] + c * dd[:, 1], dd[:, 2]], 1)
    ext = b[:, 3:6] / 2
    with np.errstate(divide='ignore', invalid='ignore'):
        t1 = (-ext - lo) / ld
        t2 = (ext - lo) / ld
    t_in = np.nanmax(np.minimum(t1, t2), 1)
    t_out = np.nanmin(np.maximum(t1, t2), 1)
    hit = (t_in <= t_out) & (t_out > 0)
    out = np.full(len(d), np.inf)
    np.minimum.at(out, ray[hit], np.maximum(t_in[hit], 0.0))
    return out


def frame(rng: np.random.Generator, p: Dict[str, Any],
          size: Dict[str, Any]):
    """One frame: (points (n, 5) x, y, z, intensity in [0, 255], time lag;
    boxes (g, 9); labels (g,) int32), cropped to ``p['range']``."""
    boxes, labels = _objects(rng, p, size)
    buildings = _buildings(rng, p, size)
    v = size['ego_speed_mps']
    lo, hi = np.asarray(p['range'][:3]), np.asarray(p['range'][3:])
    parts = []
    for k in range(int(p['sweeps'])):
        lag = k * p['sweep_lag_s']
        origin = np.array([-v * lag, 0.0, 0.0])
        moved = boxes.copy()
        moved[:, 0:2] -= boxes[:, 7:9] * lag
        xyz = _sweep(rng, p, origin, moved, buildings)
        xyz = xyz[((xyz >= lo) & (xyz < hi)).all(-1)]
        parts.append(np.c_[xyz, rng.uniform(0, 255, len(xyz)),
                           np.full(len(xyz), lag)])
    pts = np.concatenate(parts).astype(np.float32)
    return pts, boxes.astype(np.float32), labels


def make_batch(p: Dict[str, Any], rng: np.random.Generator, sizes):
    """A batch of frames of ``sizes`` (one dict a frame) through ``Pad3D``."""
    frames = [frame(rng, p, size) for size in sizes]
    return pad3d(rng, frames, p['pad_points'], p['pad_boxes'], 5, 9)
