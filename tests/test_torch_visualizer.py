"""The port's visualizer (``mmdet3d_gaussian_tpu_torch/core/visualizer``)
against the JAX package's: twins of ``tests/test_visualizer.py``, each
also holding the port's arrays equal to JAX's and its ``.obj`` files and
renders byte-equal to JAX's on the same inputs."""
import os

import numpy as np
import pytest

from mmdet3d_gaussian_tpu.core import visualizer as jvis
from mmdet3d_gaussian_tpu.core.visualizer import geometry as jgeo

from mmdet3d_gaussian_tpu_torch.core import visualizer as tvis
from mmdet3d_gaussian_tpu_torch.core.visualizer import geometry as tgeo


def _same_files(a, b):
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb
    for name in fa:
        with open(os.path.join(a, name), 'rb') as f1, \
                open(os.path.join(b, name), 'rb') as f2:
            assert f1.read() == f2.read(), name


def test_show_result_writes_objs(tmp_path):
    rng = np.random.RandomState(0)
    pts = rng.randn(100, 4).astype(np.float32)
    gt = np.array([[0, 0, 0, 4, 2, 1.5, 0.3]], np.float32)
    pred = np.array([[1, 1, 0, 4, 2, 1.5, -0.2],
                     [5, 5, 0, 2, 1, 1.0, 0.0]], np.float32)
    out = tvis.show_result(pts, gt, pred, str(tmp_path / 'port'), 'frame0')
    files = os.listdir(out)
    assert {'frame0_points.obj', 'frame0_gt.obj',
            'frame0_pred.obj'} <= set(files)
    lines = open(os.path.join(out, 'frame0_pred.obj')).read().splitlines()
    assert sum(ln.startswith('v ') for ln in lines) == 16
    assert sum(ln.startswith('l ') for ln in lines) == 24
    want = jvis.show_result(pts, gt, pred, str(tmp_path / 'jax'), 'frame0')
    _same_files(out, want)


def test_box_corners_axis_aligned():
    box = np.array([[1.0, 2.0, 0.5, 4.0, 2.0, 1.5, 0.0]])
    c = tgeo.box_corners(box)
    assert c.shape == (1, 8, 3)
    np.testing.assert_allclose(c[0, :4, 2], 0.5)
    np.testing.assert_allclose(c[0, 4:, 2], 2.0)
    np.testing.assert_allclose(sorted(set(np.round(c[0, :, 0], 6))), [-1, 3])
    np.testing.assert_allclose(sorted(set(np.round(c[0, :, 1], 6))), [1, 3])
    cg = tgeo.box_corners(box, 'gravity')
    np.testing.assert_allclose(cg[0, :, 2], c[0, :, 2] - 0.75)
    np.testing.assert_array_equal(c, jgeo.box_corners(box))
    np.testing.assert_array_equal(cg, jgeo.box_corners(box, 'gravity'))
    with pytest.raises(ValueError):
        tgeo.box_corners(box, 'top')


def test_box_corners_rotation_preserves_shape():
    boxes = np.random.RandomState(1).uniform(-3, 3, (6, 7))
    boxes[:, 3:6] = np.abs(boxes[:, 3:6]) + 0.5
    boxes[0] = [0.0, 0.0, 0.0, 4.0, 2.0, 1.5, np.pi / 2]
    c = tgeo.box_corners(boxes)
    assert np.ptp(c[0, :, 0]) == pytest.approx(2.0)
    assert np.ptp(c[0, :, 1]) == pytest.approx(4.0)
    np.testing.assert_array_equal(c, jgeo.box_corners(boxes))


def test_wireframe_and_outline():
    boxes = np.array([[0, 0, 0, 4, 2, 1.5, 0.3],
                      [5, 5, 0, 2, 1, 1.0, -0.2]])
    verts, lines = tgeo.box_wireframe(boxes)
    assert verts.shape == (16, 3) and lines.shape == (28, 2)
    assert lines.max() == 15
    out = tgeo.bev_outline(boxes)
    assert out.shape == (2, 5, 2)
    np.testing.assert_allclose(out[:, 0], out[:, 4])
    jverts, jlines = jgeo.box_wireframe(boxes)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(lines, jlines)
    np.testing.assert_array_equal(out, jgeo.bev_outline(boxes))
    np.testing.assert_array_equal(tgeo.BOX_EDGES, jgeo.BOX_EDGES)


def test_points_in_boxes_mask_and_colors():
    boxes = np.array([[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0]])
    pts = np.array([[0.0, 0.0, 1.0], [0.9, 0.9, 0.1], [1.5, 0.0, 1.0],
                    [0.0, 0.0, 2.5]])
    mask = tgeo.points_in_boxes_mask(pts, boxes)
    np.testing.assert_array_equal(mask, [True, True, False, False])
    colors = tgeo.colorize_points(pts, (0.5, 0.5, 0.5), mask, (1, 0, 0))
    np.testing.assert_allclose(colors[0], [1, 0, 0])
    np.testing.assert_allclose(colors[2], [0.5, 0.5, 0.5])
    rng = np.random.RandomState(2)
    many = rng.uniform(-3, 3, (200, 3))
    rboxes = np.c_[rng.uniform(-2, 2, (4, 3)), rng.uniform(0.5, 3, (4, 3)),
                   rng.uniform(-np.pi, np.pi, 4)]
    for mode in ('lidar_bottom', 'gravity'):
        np.testing.assert_array_equal(
            tgeo.points_in_boxes_mask(many, rboxes, mode),
            jgeo.points_in_boxes_mask(many, rboxes, mode))
    np.testing.assert_array_equal(
        tgeo.points_in_boxes_mask(many, rboxes[:0]),
        jgeo.points_in_boxes_mask(many, rboxes[:0]))
    np.testing.assert_array_equal(
        colors, jgeo.colorize_points(pts, (0.5, 0.5, 0.5), mask, (1, 0, 0)))


def test_seg_mask_colors():
    pts = np.random.RandomState(0).randn(10, 4)
    labels = np.array([0, 1] * 5)
    palette = np.array([[255, 0, 0], [0, 255, 0]])
    out = tgeo.seg_mask_colors(pts, labels, palette=palette)
    assert out.shape == (10, 6)
    np.testing.assert_allclose(out[0, 3:], [1, 0, 0])
    np.testing.assert_allclose(out[1, 3:], [0, 1, 0])
    np.testing.assert_array_equal(
        out, jgeo.seg_mask_colors(pts, labels, palette=palette))
    np.testing.assert_array_equal(tgeo.seg_mask_colors(pts, labels),
                                  jgeo.seg_mask_colors(pts, labels))


def test_plot_bev_renders(tmp_path):
    rng = np.random.RandomState(0)
    gt = np.array([[0, 0, 0, 4, 2, 1.5, 0.2], [8, 3, 0, 3, 1.6, 1.4, -0.4]])
    assigned = np.array([1, 2, 0, -1, 1])
    priors = rng.randn(5, 2) * 3
    decoded = np.concatenate([priors, rng.rand(5, 5)], 1)
    centers, groups = rng.randn(6, 3), rng.randn(6, 8, 3)
    empty = np.array([0, 0, 1, 0, 0, 0], bool)
    heat = rng.rand(32, 32, 3)
    paths = {}
    for name, vis in (('port', tvis), ('jax', jvis)):
        d = tmp_path / name
        d.mkdir()
        paths[name] = [
            vis.plot_assignment_bev(assigned, priors, decoded, gt,
                                    path=str(d / 'assign.png')),
            vis.plot_grouping_bev(centers, groups, empty_mask=empty,
                                  path=str(d / 'group.png')),
            vis.plot_heatmap_bev(heat, path=str(d / 'hm.png'))]
    for p in paths['port']:
        assert os.path.getsize(p) > 1000
    _same_files(str(tmp_path / 'port'), str(tmp_path / 'jax'))


def test_open3d_gated_import_error():
    from mmdet3d_gaussian_tpu_torch.core.visualizer import open3d_vis
    try:
        import open3d  # noqa: F401
        pytest.skip('open3d present')
    except ImportError:
        pass
    with pytest.raises(ImportError, match='obj'):
        open3d_vis.Visualizer(np.zeros((4, 3)))
    with pytest.raises(ImportError, match='obj'):
        open3d_vis.show_pts_boxes(np.zeros((4, 3)), None)
