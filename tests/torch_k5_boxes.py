"""Boxes for the tests of K5's cull (``rotated_iou.near_pairs_plain``):
numpy from a seed, shared by the CPU tests and the ``gpu`` tests.

:func:`adversarial_boxes` places pairs of boxes at centre distances
R_a + R_b +- 1e-4 (R the cull radius), edge to edge (same yaw and size,
displaced along either axis, so two edges are collinear) and corner to
corner (the corners point at each other along the diagonals), near the
origin or at the corners of the KITTI range, with ordinary, zero-size,
0.05 m-thin and equal boxes, one box with a negative width and one with a
NaN field.
"""
import numpy as np
import torch

from mmdet3d_gaussian_tpu_torch.ops import rotated_iou

# where the pairs sit: near the origin, or at the corners of the KITTI range
# (x up to 69.12 m, |y| up to 39.68 m)
REGIONS = {'origin': [(0.0, 0.0), (3.0, -2.0)],
           'range_corners': [(68.5, 39.2), (68.5, -39.2), (0.6, 39.2),
                             (0.6, -39.2)]}


def _radius(box):
    return float(rotated_iou.cull_radius(torch.tensor(box,
                                                      dtype=torch.float32)))


def _partner(a, size_b, yaw_b, direction, delta):
    """Box of ``size_b`` and ``yaw_b`` whose centre lies along the unit
    ``direction`` from box ``a`` at R_a + R_b + ``delta``."""
    b = np.array([a[0], a[1], size_b[0], size_b[1], yaw_b])
    for _ in range(3):      # R_b depends (weakly) on b's own position
        dist = _radius(a) + _radius(b.astype(np.float32)) + delta
        b[:2] = a[:2] + dist * direction
    return b


def adversarial_boxes(seed, region='origin', pairs=24):
    """(1, K, 5) f32 boxes (see the module docstring)."""
    rng = np.random.RandomState(seed)
    out = []
    for n in range(pairs):
        anchor = np.array(REGIONS[region][n % len(REGIONS[region])])
        w, h = rng.uniform(0.5, 4.5), rng.uniform(0.5, 2.0)
        if n % 6 == 4:
            h = 0.05                          # thin
        yaw = rng.uniform(-np.pi, np.pi)
        a = np.array([anchor[0], anchor[1], w, h, yaw])
        delta = 1e-4 if n % 2 else -1e-4
        kind = n % 3
        if kind == 0:        # edge to edge along the length: collinear edges
            d = np.array([np.cos(yaw), np.sin(yaw)])
            b = _partner(a, (w, h), yaw, d, delta)
        elif kind == 1:      # edge to edge across
            d = np.array([-np.sin(yaw), np.cos(yaw)])
            b = _partner(a, (w, h), yaw, d, delta)
        else:                # corner to corner along the diagonals
            wb, hb = rng.uniform(0.5, 4.5), rng.uniform(0.5, 2.0)
            phi = yaw + np.arctan2(h, w)
            d = np.array([np.cos(phi), np.sin(phi)])
            b = _partner(a, (wb, hb), phi - np.arctan2(hb, wb), d, delta)
        out += [a, b]
    c = np.array(REGIONS[region][0])
    out += [
        [c[0] + 9.0, c[1], 0.0, 1.5, 0.3],     # zero width
        [c[0] + 9.0, c[1] + 1.0, 2.0, 0.0, 0.3],   # zero length
        [c[0] + 9.0, c[1] + 0.5, 0.0, 0.0, 0.0],   # a point
        [c[0] + 9.5, c[1], 4.0, 0.05, 1.0],    # thin, across the zeros
        [c[0] - 6.0, c[1], 3.9, 1.6, 0.7],     # equal boxes
        [c[0] - 6.0, c[1], 3.9, 1.6, 0.7],
        [c[0] - 6.0, c[1] + 5.0, -2.0, 1.0, 0.2],  # negative width
        [c[0] - 6.0, c[1] + 8.0, 1.0, 1.0, np.nan],  # NaN yaw
    ]
    return np.asarray(out, np.float32)[None]


def cluster_boxes(seed, p, k, spread=20.0):
    """Decoded-anchor-like BEV boxes: jittered clusters, so many pairs
    overlap and some IoUs exceed the NMS threshold."""
    rng = np.random.RandomState(seed)
    n = max(k // 4, 1)
    centers = rng.uniform(-spread, spread, (p, n, 2))
    pick = rng.randint(0, n, (p, k))
    xy = np.take_along_axis(centers, pick[..., None], 1) \
        + rng.normal(0, 0.6, (p, k, 2))
    wh = rng.uniform([0.5, 0.5], [4.5, 2.0], (p, k, 2))
    yaw = rng.uniform(-np.pi, np.pi, (p, k, 1))
    return np.concatenate([xy, wh, yaw], -1).astype(np.float32)


def far_value(boxes):
    """(P, K, K) f32: the IoU of an empty intersection, the kernel's value
    on a far pair (0 where both sizes are >= 0)."""
    b = torch.as_tensor(boxes, dtype=torch.float32)
    area = b[..., 2] * b[..., 3]
    aa, ab = area[:, :, None], area[:, None, :]
    inter = torch.minimum(torch.minimum(torch.zeros_like(aa), aa), ab)
    return inter / (aa + ab - inter).clamp(min=1e-6)
