"""Result visualization package (port of
``mmdet3d_gaussian_tpu/core/visualizer``, numpy and the file system only).

Re-provision of the reference visual debug tooling:

* :func:`show_result` (here) — ``.obj`` dumps, the headless path
  (reference ``core/visualizer/show_result.py:1-122``);
* :mod:`.open3d_vis` — the interactive ``Visualizer`` /
  ``show_pts_boxes`` / ``show_pts_index_boxes`` API (reference
  ``open3d_vis.py``), gated on open3d;
* :mod:`.plot_bev` — headless matplotlib PNG renders of the reference's
  inline debug plots (SimOTA assignment, ball-query grouping, heatmaps);
* :mod:`.geometry` — the pure-numpy geometry layer all of the above share.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np

from .geometry import (BOX_EDGES, bev_outline, box_corners,  # noqa: F401
                       box_wireframe, colorize_points, points_in_boxes_mask,
                       seg_mask_colors)
from .plot_bev import (plot_assignment_bev, plot_grouping_bev,  # noqa: F401
                       plot_heatmap_bev)


def _write_points_obj(points: np.ndarray, path: str):
    with open(path, 'w') as f:
        for p in points:
            f.write(f'v {p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n')


_BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
              (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]


def _write_boxes_obj(boxes: np.ndarray, path: str):
    """Boxes as wireframe line elements (pure numpy — a viz dump must not
    require a device)."""
    corners = box_corners(boxes)
    with open(path, 'w') as f:
        for box in corners:
            for c in box:
                f.write(f'v {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n')
        for i in range(len(corners)):
            base = i * 8
            for a, b in _BOX_EDGES:
                f.write(f'l {base + a + 1} {base + b + 1}\n')


def show_result(points: Optional[np.ndarray],
                gt_bboxes: Optional[np.ndarray],
                pred_bboxes: Optional[np.ndarray],
                out_dir: str, filename: str, show: bool = False):
    """Dump (points, gt boxes, pred boxes) as .obj files (reference
    ``show_result``); optionally open an open3d window when available."""
    result_path = osp.join(out_dir, filename)
    os.makedirs(result_path, exist_ok=True)
    if points is not None:
        _write_points_obj(np.asarray(points),
                          osp.join(result_path, f'{filename}_points.obj'))
    if gt_bboxes is not None and len(gt_bboxes):
        _write_boxes_obj(np.asarray(gt_bboxes),
                         osp.join(result_path, f'{filename}_gt.obj'))
    if pred_bboxes is not None and len(pred_bboxes):
        _write_boxes_obj(np.asarray(pred_bboxes),
                         osp.join(result_path, f'{filename}_pred.obj'))
    if show:
        try:
            show_open3d(points, gt_bboxes, pred_bboxes)
        except ImportError:
            pass
    return result_path


def show_open3d(points, gt_bboxes=None, pred_bboxes=None):
    """Interactive open3d view (reference ``open3d_vis.py``); requires
    open3d + a display."""
    import open3d as o3d  # noqa: raises ImportError when absent
    geoms = []
    if points is not None:
        pc = o3d.geometry.PointCloud(
            points=o3d.utility.Vector3dVector(
                np.asarray(points)[:, :3].astype(np.float64)))
        geoms.append(pc)
    for boxes, color in ((gt_bboxes, (0, 1, 0)), (pred_bboxes, (1, 0, 0))):
        if boxes is None or not len(boxes):
            continue
        corners = box_corners(np.asarray(boxes))
        for box in corners:
            ls = o3d.geometry.LineSet(
                points=o3d.utility.Vector3dVector(box.astype(np.float64)),
                lines=o3d.utility.Vector2iVector(np.asarray(_BOX_EDGES)))
            ls.paint_uniform_color(color)
            geoms.append(ls)
    o3d.visualization.draw_geometries(geoms)
