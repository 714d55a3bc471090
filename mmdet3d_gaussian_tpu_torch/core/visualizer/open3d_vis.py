"""Interactive open3d visualization (reference ``core/visualizer/open3d_vis.py``).

API parity with the reference: :func:`show_pts_boxes`,
:func:`show_pts_index_boxes`, and the online :class:`Visualizer`
(``add_bboxes`` / ``add_seg_mask`` / ``show``).  All geometry is produced by
the numpy layer in :mod:`.geometry` (testable without a display); open3d is
only touched at draw time, and its absence raises a clear error from the
entry points instead of at import (without open3d the
``.obj`` dump in :func:`..show_result` is the headless path).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .geometry import (box_wireframe, colorize_points, points_in_boxes_mask)


def _o3d():
    try:
        import open3d as o3d  # noqa: F401
    except ImportError as e:  # pragma: no cover - env without open3d
        raise ImportError(
            'open3d is required for interactive visualization; install it or '
            'use mmdet3d_gaussian_tpu_torch.core.visualizer.show_result '
            '(.obj dump) / plot_bev (matplotlib) instead.') from e
    return o3d


def _add_points(vis, points, points_size, colors):
    o3d = _o3d()
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(
        np.asarray(points, np.float64)[:, :3])
    pcd.colors = o3d.utility.Vector3dVector(colors)
    vis.get_render_option().point_size = points_size
    vis.add_geometry(pcd)
    return pcd


def _add_wireframe(vis, bbox3d, bbox_color, center_mode):
    o3d = _o3d()
    verts, lines = box_wireframe(np.asarray(bbox3d), center_mode)
    ls = o3d.geometry.LineSet(
        points=o3d.utility.Vector3dVector(verts),
        lines=o3d.utility.Vector2iVector(lines))
    ls.paint_uniform_color(bbox_color)
    vis.add_geometry(ls)
    return ls


class Visualizer:
    """Online visualizer (reference open3d_vis.py:327-443): build once, add
    geometry incrementally, then ``show()``.

    points: ``(N, 3+C)``; bbox3d: ``(M, 7)`` (x, y, z, dx, dy, dz, yaw),
    bottom-centered by default (``center_mode='lidar_bottom'``).
    """

    def __init__(self, points, bbox3d=None, save_path: Optional[str] = None,
                 points_size: int = 2,
                 point_color: Sequence[float] = (0.5, 0.5, 0.5),
                 bbox_color: Sequence[float] = (0.0, 1.0, 0.0),
                 points_in_box_color: Sequence[float] = (1.0, 0.0, 0.0),
                 center_mode: str = 'lidar_bottom', mode: str = 'xyz'):
        o3d = _o3d()
        self.o3d_visualizer = o3d.visualization.Visualizer()
        self.o3d_visualizer.create_window()
        self.o3d_visualizer.add_geometry(
            o3d.geometry.TriangleMesh.create_coordinate_frame(
                size=1, origin=[0, 0, 0]))
        self.points_size = points_size
        self.bbox_color = tuple(bbox_color)
        self.points_in_box_color = tuple(points_in_box_color)
        self.center_mode = center_mode
        self.seg_num = 0
        self.pcd = None
        self._points = None
        if points is not None:
            points = np.asarray(points, np.float64)
            self._points = points
            if mode == 'xyzrgb':
                colors = points[:, 3:6]
                if colors.max(initial=0.0) > 1.0:
                    colors = colors / 255.0
            else:
                colors = colorize_points(points, point_color)
            self.points_colors = colors
            self.pcd = _add_points(self.o3d_visualizer, points,
                                   points_size, colors)
        if bbox3d is not None:
            self.add_bboxes(bbox3d)
        self.save_path = save_path

    def add_bboxes(self, bbox3d, bbox_color=None, points_in_box_color=None):
        """Add wireframes; recolor the points inside them (reference
        open3d_vis.py:395-414)."""
        o3d = _o3d()
        _add_wireframe(self.o3d_visualizer, bbox3d,
                       bbox_color or self.bbox_color, self.center_mode)
        if self.pcd is not None:
            mask = points_in_boxes_mask(self._points, bbox3d,
                                        self.center_mode)
            self.points_colors[mask] = np.asarray(
                points_in_box_color or self.points_in_box_color)
            self.pcd.colors = o3d.utility.Vector3dVector(self.points_colors)
            self.o3d_visualizer.update_geometry(self.pcd)

    def add_seg_mask(self, seg_mask_colors):
        """Draw a second, x-offset copy of the cloud colored by segmentation
        (reference open3d_vis.py:415-435); input ``(N, 6)`` xyz+rgb."""
        o3d = _o3d()
        self.seg_num += 1
        pts = np.asarray(seg_mask_colors, np.float64).copy()
        offset = (self._points[:, 0].max() -
                  self._points[:, 0].min()) * 1.2 * self.seg_num
        pts[:, 0] += offset
        self.o3d_visualizer.add_geometry(
            o3d.geometry.TriangleMesh.create_coordinate_frame(
                size=1, origin=[offset, 0, 0]))
        _add_points(self.o3d_visualizer, pts, self.points_size, pts[:, 3:6])

    def show(self, save_path: Optional[str] = None):
        self.o3d_visualizer.run()
        save_path = save_path or self.save_path
        if save_path is not None:
            self.o3d_visualizer.capture_screen_image(save_path)
        self.o3d_visualizer.destroy_window()


def show_pts_boxes(points, bbox3d=None, show: bool = True,
                   save_path: Optional[str] = None, **kwargs):
    """One-shot points+boxes view (reference open3d_vis.py:129-190)."""
    vis = Visualizer(points, bbox3d=bbox3d, **kwargs)
    if show:
        vis.show(save_path)
    elif save_path is not None:
        vis.o3d_visualizer.capture_screen_image(save_path)
        vis.o3d_visualizer.destroy_window()


def show_pts_index_boxes(points, bbox3d=None, show: bool = True,
                         indices=None, save_path: Optional[str] = None,
                         **kwargs):
    """Points + boxes with an index-selected subset highlighted (reference
    open3d_vis.py:261-326): ``indices`` marks points to recolor."""
    vis = Visualizer(points, bbox3d=None, **kwargs)
    if bbox3d is not None:
        vis.add_bboxes(bbox3d)
    if indices is not None and vis.pcd is not None:
        o3d = _o3d()
        mask = np.zeros(len(vis.points_colors), bool)
        mask[np.asarray(indices, np.int64)] = True
        vis.points_colors[mask] = np.asarray(vis.points_in_box_color)
        vis.pcd.colors = o3d.utility.Vector3dVector(vis.points_colors)
        vis.o3d_visualizer.update_geometry(vis.pcd)
    if show:
        vis.show(save_path)
