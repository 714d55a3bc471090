"""Headless BEV debug renders (matplotlib -> PNG).

Counterparts of the reference's inline debug plots: the SimOTA assignment
render (``sim_ota_3d_assigner.py:125-156`` — gt outlines red, decoded
positives green, matched priors blue dots, match lines) and the ball-query
grouping render (``ops/vsa/group_points.py:136-164`` — keypoints blue,
grouped neighbors red).  The reference calls ``plt.show()`` /
``o3d...draw_geometries`` interactively; this image is headless, so both
write a PNG instead (pass ``path=None`` to get the matplotlib figure back
for interactive use).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .geometry import bev_outline


def _finish(fig, path):
    if path is not None:
        fig.savefig(path, bbox_inches='tight')
        import matplotlib.pyplot as plt
        plt.close(fig)
        return path
    return fig


def plot_assignment_bev(assigned_gt, priors_xy, decoded_bboxes, gt_bboxes,
                        gt_valid=None, path: Optional[str] = None):
    """Render an anchor/prior assignment in BEV.

    assigned_gt: ``(A,)`` int (-1 ignore / 0 negative / g+1 matched);
    priors_xy: ``(A, 2)`` prior centers; decoded_bboxes ``(A, 7)``;
    gt_bboxes ``(G, 7)``.  Matches the reference ``_debug`` content: valid
    gt outlines (red), positive decoded boxes (green), positive prior
    centers (blue dots), and a line from each positive prior to its gt
    center.
    """
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    assigned_gt = np.asarray(assigned_gt)
    priors_xy = np.asarray(priors_xy)
    decoded_bboxes = np.asarray(decoded_bboxes)
    gt_bboxes = np.asarray(gt_bboxes).reshape(-1, 7)
    if gt_valid is None:
        gt_valid = np.ones(gt_bboxes.shape[0], bool)
    gt_valid = np.asarray(gt_valid, bool)

    fig, ax = plt.subplots(dpi=200)
    for o in bev_outline(gt_bboxes[gt_valid]):
        ax.plot(o[:, 0], o[:, 1], 'r', lw=1)
    pos = assigned_gt > 0
    if pos.any():
        for o in bev_outline(decoded_bboxes[pos]):
            ax.plot(o[:, 0], o[:, 1], 'g', lw=0.8)
        ax.plot(priors_xy[pos, 0], priors_xy[pos, 1], 'b.', ms=2)
        gt_centers = gt_bboxes[assigned_gt[pos] - 1, :2]
        for p, g in zip(priors_xy[pos], gt_centers):
            ax.plot([g[0], p[0]], [g[1], p[1]], lw=0.5, color='0.6')
    ax.set_aspect('equal')
    ax.set_title(f'{int(pos.sum())} positives / {int(gt_valid.sum())} gt')
    return _finish(fig, path)


def plot_grouping_bev(new_xyz, grouped_xyz, empty_mask=None,
                      path: Optional[str] = None):
    """Render ball-query grouping: keypoints (blue) + their grouped
    neighbors (red), BEV projection.

    new_xyz: ``(M, 3)`` group centers; grouped_xyz ``(M, K, 3)`` absolute
    neighbor coordinates; empty_mask ``(M,)`` optional (empty balls are
    skipped, the reference zeroes them).
    """
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    new_xyz = np.asarray(new_xyz)
    grouped = np.asarray(grouped_xyz)
    keep = np.ones(new_xyz.shape[0], bool)
    if empty_mask is not None:
        keep = ~np.asarray(empty_mask, bool)

    fig, ax = plt.subplots(dpi=200)
    pts = grouped[keep].reshape(-1, 3)
    ax.plot(pts[:, 0], pts[:, 1], 'r.', ms=1.5, label='grouped')
    ax.plot(new_xyz[keep, 0], new_xyz[keep, 1], 'b.', ms=3, label='keypoints')
    ax.set_aspect('equal')
    ax.legend(loc='upper right', fontsize=6)
    return _finish(fig, path)


def plot_heatmap_bev(heatmap, path: Optional[str] = None,
                     title: str = 'heatmap'):
    """Render a CenterPoint-style class heatmap ``(H, W)`` or ``(H, W, C)``
    (max over classes)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    hm = np.asarray(heatmap)
    if hm.ndim == 3:
        hm = hm.max(axis=-1)
    fig, ax = plt.subplots(dpi=200)
    im = ax.imshow(hm, origin='lower', cmap='viridis')
    fig.colorbar(im, ax=ax, shrink=0.8)
    ax.set_title(title)
    return _finish(fig, path)
