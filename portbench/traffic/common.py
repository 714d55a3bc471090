"""What the generators share: boxes and the points in them, the BEV
overlap test of the GT sampler, and the data pipeline's last step
(``Pad3D``: a frame over ``num_points`` keeps a random subset of them,
one under it is padded; boxes are padded to ``num_gt``)."""
from __future__ import annotations

import math

import numpy as np


def in_any_box(xyz: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(P, 3) points x (G, 7+) bottom-centred boxes -> (P,) whether each
    point lies in some box (z-inclusive); each box tests only the points
    whose x lies within its circumscribed circle."""
    out = np.zeros(len(xyz), bool)
    order = np.argsort(xyz[:, 0], kind='stable')
    xs = xyz[order, 0]
    for b in boxes:
        r = 0.5 * math.hypot(b[3], b[4])
        lo, hi = np.searchsorted(xs, [b[0] - r, b[0] + r])
        idx = order[lo:hi]
        d = xyz[idx, :2] - b[:2]
        c, s = math.cos(b[6]), math.sin(b[6])
        lx = c * d[:, 0] + s * d[:, 1]
        ly = -s * d[:, 0] + c * d[:, 1]
        z = xyz[idx, 2]
        out[idx[(np.abs(lx) <= b[3] / 2) & (np.abs(ly) <= b[4] / 2)
                & (z >= b[2]) & (z <= b[2] + b[5])]] = True
    return out


def box_points(rng: np.random.Generator, boxes: np.ndarray, counts):
    """Points spread uniformly through each box's volume, ``counts[i]`` in
    box i -> (sum counts, 3) and the owner of each point."""
    owner = np.repeat(np.arange(len(boxes)), counts)
    b = boxes[owner]
    local = rng.uniform(-0.5, 0.5, (len(owner), 3)) * b[:, 3:6]
    c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
    xyz = np.c_[b[:, 0] + c * local[:, 0] - s * local[:, 1],
                b[:, 1] + s * local[:, 0] + c * local[:, 1],
                b[:, 2] + b[:, 5] / 2 + local[:, 2]]
    return xyz, owner


def bev_corners(box) -> np.ndarray:
    """(7+,) box -> its BEV rectangle's 4 corners (4, 2)."""
    c, s = np.cos(box[6]), np.sin(box[6])
    hx, hy = box[3] / 2, box[4] / 2
    local = np.array([[hx, hy], [-hx, hy], [-hx, -hy], [hx, -hy]])
    return local @ np.array([[c, s], [-s, c]]) + np.asarray(box[:2])


def bev_overlap(a, b) -> bool:
    """Whether two boxes' BEV rectangles overlap (separating axes): the
    GT sampler's collision test."""
    if math.hypot(a[0] - b[0], a[1] - b[1]) > 0.5 * (
            math.hypot(a[3], a[4]) + math.hypot(b[3], b[4])):
        return False
    ca, cb = bev_corners(a), bev_corners(b)
    for poly in (ca, cb):
        for i in range(4):
            edge = poly[(i + 1) % 4] - poly[i]
            axis = np.array([-edge[1], edge[0]])
            pa, pb = ca @ axis, cb @ axis
            if pa.max() < pb.min() or pb.max() < pa.min():
                return False
    return True


def pad3d(rng: np.random.Generator, frames, num_points: int, num_gt: int,
          channels: int, box_dim: int):
    """The pipeline's ``Pad3D`` over a batch of (points, boxes, labels)
    frames: a frame of more than ``num_points`` points keeps a random
    ``num_points`` of them, one of fewer is padded (``points_mask``);
    boxes beyond ``num_gt`` are dropped, fewer are padded (``gt_valid``)."""
    b = len(frames)
    points = np.zeros((b, num_points, channels), np.float32)
    mask = np.zeros((b, num_points), bool)
    gt = np.zeros((b, num_gt, box_dim), np.float32)
    labels = np.zeros((b, num_gt), np.int32)
    valid = np.zeros((b, num_gt), bool)
    for i, (pts, boxes, labs) in enumerate(frames):
        if len(pts) > num_points:
            pts = pts[rng.choice(len(pts), num_points, replace=False)]
        g = min(len(boxes), num_gt)
        points[i, :len(pts)] = pts
        mask[i, :len(pts)] = True
        gt[i, :g] = boxes[:g]
        labels[i, :g] = labs[:g]
        valid[i, :g] = True
    return dict(points=points, points_mask=mask, gt_bboxes=gt,
                gt_labels=labels, gt_valid=valid)
