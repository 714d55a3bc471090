"""Pure-numpy visualization geometry (headless-testable core).

The reference's interactive tooling (``core/visualizer/open3d_vis.py``)
builds its wireframes / point colorings inline with open3d calls, which makes
it untestable without a display.  Here every geometric product — wireframe
vertices+edges, in-box masks, color buffers — is computed in plain numpy so
the front-ends (:mod:`.open3d_vis`, :mod:`.plot_bev`, the ``.obj`` dump in
``__init__``) only hand finished arrays to their backend.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# 12 box edges + 2 heading-cross edges on the +x face, matching the
# reference's open3d correspondence list (open3d_vis.py:104-108) up to
# vertex numbering (we use the canonical corner order below, the reference
# uses open3d's get_box_points order).
BOX_EDGES = np.array(
    [(0, 1), (1, 2), (2, 3), (3, 0),          # bottom face
     (4, 5), (5, 6), (6, 7), (7, 4),          # top face
     (0, 4), (1, 5), (2, 6), (3, 7),          # pillars
     (0, 5), (1, 4)],                         # heading cross (front face)
    dtype=np.int64)


def box_corners(bboxes: np.ndarray,
                center_mode: str = 'lidar_bottom') -> np.ndarray:
    """``(M, 7)`` boxes (x, y, z, dx, dy, dz, yaw) -> ``(M, 8, 3)`` corners.

    Corner order: bottom face (x+y+, x+y-, x-y-, x-y+) then the same for the
    top face, all in the box frame before yaw.  ``center_mode``:
    'lidar_bottom' treats z as the bottom center (KITTI/lidar convention,
    reference open3d_vis.py:100-104), 'gravity' as the gravity center.
    """
    bboxes = np.asarray(bboxes, np.float64).reshape(-1, 7)
    template = np.array(
        [[1, 1, 0], [1, -1, 0], [-1, -1, 0], [-1, 1, 0],
         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], np.float64)
    half = bboxes[:, None, 3:6] * np.array([0.5, 0.5, 1.0])
    corners = template[None, :, :] * half          # z in [0, dz]
    if center_mode == 'gravity':
        corners[..., 2] -= bboxes[:, None, 5] / 2
    elif center_mode != 'lidar_bottom':
        raise ValueError(center_mode)
    yaw = bboxes[:, 6]
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    corners[..., :2] = np.einsum('mij,mkj->mki', rot, corners[..., :2])
    return corners + bboxes[:, None, 0:3]


def box_wireframe(bboxes: np.ndarray, center_mode: str = 'lidar_bottom'
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Boxes -> flat wireframe: ``(M*8, 3)`` vertices + ``(M*14, 2)`` edges."""
    corners = box_corners(bboxes, center_mode)
    m = corners.shape[0]
    verts = corners.reshape(-1, 3)
    lines = (BOX_EDGES[None, :, :] + 8 * np.arange(m)[:, None, None])
    return verts, lines.reshape(-1, 2)


def bev_outline(bboxes: np.ndarray) -> np.ndarray:
    """Boxes -> closed BEV outlines ``(M, 5, 2)`` (first corner repeated),
    the polyline form the reference's assigner debug render plots
    (``sim_ota_3d_assigner.py:134-141``)."""
    corners = box_corners(bboxes)[:, :4, :2]
    return np.concatenate([corners, corners[:, :1]], axis=1)


def points_in_boxes_mask(points: np.ndarray, bboxes: np.ndarray,
                         center_mode: str = 'lidar_bottom') -> np.ndarray:
    """``(N, 3+)`` points x ``(M, 7)`` boxes -> ``(N,)`` bool (in any box).

    Replaces open3d's ``get_point_indices_within_bounding_box``
    (reference open3d_vis.py:113-115) with vectorized numpy.
    """
    points = np.asarray(points, np.float64)[:, :3]
    bboxes = np.asarray(bboxes, np.float64).reshape(-1, 7)
    if bboxes.shape[0] == 0:
        return np.zeros(points.shape[0], bool)
    d = points[:, None, :2] - bboxes[None, :, 0:2]
    c, s = np.cos(bboxes[:, 6]), np.sin(bboxes[:, 6])
    local_x = c * d[..., 0] + s * d[..., 1]
    local_y = -s * d[..., 0] + c * d[..., 1]
    z0 = bboxes[:, 2] - (bboxes[:, 5] / 2 if center_mode == 'gravity' else 0)
    in_box = ((np.abs(local_x) <= bboxes[None, :, 3] / 2)
              & (np.abs(local_y) <= bboxes[None, :, 4] / 2)
              & (points[:, 2:3] >= z0[None, :])
              & (points[:, 2:3] <= (z0 + bboxes[:, 5])[None, :]))
    return in_box.any(axis=1)


def colorize_points(points: np.ndarray,
                    point_color: Sequence[float] = (0.5, 0.5, 0.5),
                    in_box_mask: Optional[np.ndarray] = None,
                    in_box_color: Sequence[float] = (1.0, 0.0, 0.0)
                    ) -> np.ndarray:
    """Per-point RGB in [0, 1]: uniform base color, in-box points recolored
    (reference ``_draw_bboxes`` side effect, open3d_vis.py:111-117)."""
    colors = np.tile(np.asarray(point_color, np.float64),
                     (np.asarray(points).shape[0], 1))
    if in_box_mask is not None:
        colors[np.asarray(in_box_mask, bool)] = np.asarray(in_box_color)
    return colors


def seg_mask_colors(points: np.ndarray, labels: np.ndarray,
                    palette: Optional[np.ndarray] = None) -> np.ndarray:
    """Points + int labels -> the ``(N, 6)`` xyz+rgb buffer the reference's
    ``Visualizer.add_seg_mask`` consumes (open3d_vis.py:415-435)."""
    points = np.asarray(points, np.float64)[:, :3]
    labels = np.asarray(labels, np.int64)
    if palette is None:
        rng = np.random.RandomState(0)
        palette = rng.rand(int(labels.max(initial=0)) + 1, 3)
    palette = np.asarray(palette, np.float64)
    if palette.max() > 1.0:
        palette = palette / 255.0
    return np.concatenate([points, palette[labels]], axis=1)
