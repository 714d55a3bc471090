"""The port's evaluators and axis-aligned NMS against the JAX package's.

``geometry_np`` on random boxes (equal), the port's native library (its own
copy of ``csrc/eval_ops.cpp``) against the numpy path; ``eval_map_flexible``, ``kitti_eval`` and ``KittiDataset.evaluate``
under both metrics on random detections and annotations, several seeds:
the reports must be equal.  ``nms_normal_bev``'s keep masks must equal
JAX's at several K, and the TINY predict with ``use_rotate_nms=False``
JAX's predict (weights carried over by ``jax_variables_to_torch``).
"""
import math
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mmdet3d_gaussian_tpu  # noqa: F401  (registers the JAX datasets)
from mmdet3d_gaussian_tpu.core.evaluation import geometry_np as JG
from mmdet3d_gaussian_tpu.core.evaluation import kitti_official as jko
from mmdet3d_gaussian_tpu.core.evaluation.mean_ap import (
    eval_map_flexible as j_eval_map)
from mmdet3d_gaussian_tpu.datasets.kitti import KittiDataset as JKitti
from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.ops import nms as jnms

from mmdet3d_gaussian_tpu_torch.core.evaluation import geometry_np as TG
from mmdet3d_gaussian_tpu_torch.core.evaluation import kitti_official as tko
from mmdet3d_gaussian_tpu_torch.core.evaluation import matcher as tmatch
from mmdet3d_gaussian_tpu_torch.core.evaluation import native
from mmdet3d_gaussian_tpu_torch.core.evaluation.mean_ap import (
    eval_map_flexible as t_eval_map)
from mmdet3d_gaussian_tpu_torch.datasets.kitti import KittiDataset as TKitti
from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.ops import nms as tnms
from mmdet3d_gaussian_tpu_torch.weights import jax_variables_to_torch

from tests.test_torch_predict import TINY_MODEL, randomize

torch.set_num_threads(2)

CLASSES = ('Pedestrian', 'Cyclist', 'Car')
SIZES = np.array([[0.8, 0.6, 1.73], [1.76, 0.6, 1.73], [3.9, 1.6, 1.56]])
# a KITTI-like camera for LiDAR frames: cam x = -y, y = -z, z = x
CALIB = dict(
    R0_rect=np.eye(4),
    Tr_velo_to_cam=np.array([[0., -1., 0., 0.], [0., 0., -1., 0.],
                             [1., 0., 0., 0.], [0., 0., 0., 1.]]),
    P2=np.array([[721.5377, 0., 609.5593, 0.], [0., 721.5377, 172.854, 0.],
                 [0., 0., 1., 0.]]))
SEEDS = (0, 1, 2)


def random_boxes(rng, n, spread=20.0):
    ctr = rng.uniform([2, -spread, -2], [2 + 2 * spread, spread, 0], (n, 3))
    dims = rng.uniform(0.5, 4.5, (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.c_[ctr, dims, yaw].astype(np.float32)


def scene(rng, n_gt):
    """Per-class LiDAR GT boxes inside the camera's view, and detections:
    jittered copies of most GT boxes plus false positives, with scores."""
    labels = rng.randint(0, 3, n_gt)
    x = rng.uniform(5, 45, n_gt)
    y = rng.uniform(-0.6, 0.6, n_gt) * x
    gt = np.c_[x, y, np.full(n_gt, -1.73), SIZES[labels]
               * rng.uniform(0.9, 1.1, (n_gt, 3)),
               rng.uniform(-np.pi, np.pi, n_gt)].astype(np.float32)
    keep = rng.rand(n_gt) < 0.8
    dets = gt[keep].copy()
    dets[:, :3] += rng.normal(0, 0.25, (len(dets), 3))
    dets[:, 3:6] *= rng.uniform(0.85, 1.15, (len(dets), 3))
    dets[:, 6] += rng.normal(0, 0.15, len(dets))
    fp = np.c_[rng.uniform(5, 45, (4, 1)), rng.uniform(-10, 10, (4, 1)),
               np.full((4, 1), -1.73), SIZES[rng.randint(0, 3, 4)],
               rng.uniform(-np.pi, np.pi, (4, 1))].astype(np.float32)
    det_labels = np.r_[labels[keep], rng.randint(0, 3, 4)]
    dets = np.r_[dets, fp]
    scores = rng.uniform(0.05, 1.0, len(dets)).astype(np.float32)
    per_cls = [np.c_[dets[det_labels == c], scores[det_labels == c]]
               .astype(np.float32) for c in range(3)]
    gt_cls = [np.c_[gt[labels == c], np.ones((int((labels == c).sum()), 1))]
              .astype(np.float32) for c in range(3)]
    return gt, labels, per_cls, gt_cls


# ------------------------------------------------------------- geometry
@pytest.mark.parametrize('seed', SEEDS)
def test_geometry_np_equal(seed):
    rng = np.random.RandomState(seed)
    a, b = random_boxes(rng, 40, 4.0), random_boxes(rng, 30, 4.0)
    for fn in ('iou_bev', 'trans_bev'):
        np.testing.assert_array_equal(getattr(TG, fn)(a, b),
                                      getattr(JG, fn)(a, b))
    np.testing.assert_array_equal(TG.iou_3d(a, b, 0.5), JG.iou_3d(a, b, 0.5))
    bev = a[:, [0, 1, 3, 4, 6]].astype(np.float64)
    np.testing.assert_array_equal(TG.rotated_intersection_area(bev, bev[:7]),
                                  JG.rotated_intersection_area(bev, bev[:7]))
    assert (TG.iou_bev(a, b) > 0).sum() > 10


def test_native_matches_numpy():
    """The port's library builds here and agrees with the numpy path (f32
    corners in C++ against f64 in numpy)."""
    assert native.available(), 'the eval ops did not build'
    assert native.library_path().exists()
    rng = np.random.RandomState(3)
    a, b = random_boxes(rng, 60, 4.0), random_boxes(rng, 50, 4.0)
    np.testing.assert_allclose(native.iou_bev(a, b), TG.iou_bev(a, b),
                               atol=1e-5)
    np.testing.assert_allclose(native.iou_3d(a, b, 0.5),
                               TG.iou_3d(a, b, 0.5), atol=1e-5)
    cost = -TG.iou_bev(a, b).astype(np.float32)
    thrs = np.array([-0.7, -0.5, -0.1], np.float32)
    ig = rng.rand(50) < 0.2
    cr = np.zeros(50, bool)
    np.testing.assert_array_equal(
        native.match_coco_native(cost, thrs, ig, cr),
        tmatch.match_coco_np(cost, thrs, ig, cr))


# ------------------------------------------------------------ evaluators
@pytest.mark.parametrize('seed', SEEDS)
def test_eval_map_flexible_equal(seed):
    rng = np.random.RandomState(seed)
    dets, annos = [], []
    for _ in range(5):
        gt, labels, per_cls, _ = scene(rng, rng.randint(0, 9))
        attrs = dict(ignore=rng.rand(len(gt)) < 0.15)
        annos.append(dict(gt_bboxes=gt, gt_labels=labels, gt_attrs=attrs))
        dets.append(per_cls)
    kw = dict(match_thrs=[0.7, 0.5, 0.25],
              breakdowns=[dict(type='RangeBreakdown',
                               ranges=dict(near=(0, 20), far=(20, 1e5)))],
              affinity_calculator=dict(type='LidarIOU3D', z_offset=0.5),
              classes=list(CLASSES), logger='silent',
              report_config=[('mAP', lambda k: k['breakdown'] == 'All'),
                             ('mAP_near', lambda k: k['breakdown'] == 'near'),
                             ('car_0.7', lambda k: (k['class_name'] == 'Car'
                              and k['match_threshold'] == 0.7))])
    got, want = t_eval_map(dets, annos, **kw), j_eval_map(dets, annos, **kw)
    assert list(got) == list(want)
    np.testing.assert_array_equal(np.array(list(got.values())),
                                  np.array(list(want.values())))
    assert 0 < want['mAP'] <= 1


def _annos(seed, frames=6):
    rng = np.random.RandomState(seed)
    gt_annos, dt_annos, per_frame = [], [], []
    for _ in range(frames):
        _, _, per_cls, gt_cls = scene(rng, rng.randint(1, 10))
        gt = JKitti.lidar_det_to_kitti_anno(gt_cls, CALIB, classes=CLASSES)
        n = len(gt['name'])
        gt.update(occluded=rng.randint(0, 3, n).astype(np.int32),
                  truncated=rng.uniform(0, 0.6, n).astype(np.float32))
        gt_annos.append(gt)
        dt_annos.append(JKitti.lidar_det_to_kitti_anno(per_cls, CALIB,
                                                       classes=CLASSES))
        per_frame.append(per_cls)
    return gt_annos, dt_annos, per_frame


@pytest.mark.parametrize('seed', SEEDS)
def test_kitti_eval_equal(seed):
    gt_annos, dt_annos, _ = _annos(seed)
    got_res, got_rep = tko.kitti_eval(gt_annos, dt_annos, list(CLASSES))
    want_res, want_rep = jko.kitti_eval(gt_annos, dt_annos, list(CLASSES))
    assert got_rep == want_rep
    assert list(got_res) == list(want_res)
    np.testing.assert_array_equal(np.array(list(got_res.values())),
                                  np.array(list(want_res.values())))
    assert 'AP11' in got_rep and max(want_res.values()) > 0


@pytest.fixture(scope='module', params=[7, 8, 9])
def kitti_infos(tmp_path_factory, request):
    """An info pkl of 6 frames whose annotations come from random LiDAR
    GT boxes through ``CALIB``, and each frame's detections (one seed a
    parameter)."""
    root = tmp_path_factory.mktemp('kitti_eval')
    gt_annos, _, per_frame = _annos(request.param)
    infos = []
    for i, anno in enumerate(gt_annos):
        anno = {k: v for k, v in anno.items() if k != 'score'}
        anno['difficulty'] = np.zeros(len(anno['name']), np.int32)
        infos.append(dict(
            point_cloud=dict(velodyne_path=f'training/velodyne/{i:06d}.bin'),
            image=dict(image_shape=(375, 1242)), calib=CALIB, annos=anno))
    path = os.path.join(root, 'infos.pkl')
    with open(path, 'wb') as f:
        pickle.dump(infos, f)
    return str(root), path, per_frame


@pytest.mark.parametrize('metric', ['cowa', 'kitti'])
def test_kitti_dataset_evaluate_equal(kitti_infos, metric, capsys):
    root, path, per_frame = kitti_infos
    pipeline = [dict(type='LoadPointsFromFile', load_dim=4, use_dim=4)]
    args = dict(data_root=root, ann_file=path, pipeline=pipeline,
                classes=list(CLASSES))
    got = TKitti(**args).evaluate(per_frame, metric=metric)
    got_out = capsys.readouterr().out
    want = JKitti(**args).evaluate(per_frame, metric=metric)
    want_out = capsys.readouterr().out
    assert got_out == want_out
    assert list(got) == list(want)
    np.testing.assert_array_equal(np.array(list(got.values())),
                                  np.array(list(want.values())))
    assert ('AP11' in got_out) == (metric == 'kitti')
    assert max(v for v in want.values() if not math.isnan(v)) > 0


# ------------------------------------------------------------ axis NMS
def nms_case(k, seed):
    """K score-sorted candidate boxes (cx, cy, w, h, yaw) clustered so that
    many overlap."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-20, 20, (max(1, k // 8), 2))
    ctr = centers[rng.randint(0, len(centers), k)] + rng.normal(0, 1.0,
                                                                (k, 2))
    wh = rng.uniform(0.5, 4.0, (k, 2))
    yaw = rng.uniform(-np.pi, np.pi, (k, 1))
    boxes = np.c_[ctr, wh, yaw].astype(np.float32)
    scores = np.sort(rng.rand(k).astype(np.float32))[::-1].copy()
    valid = rng.rand(k) < 0.9
    return boxes, scores, valid


def near_threshold(iou, thr):
    """Entries of the port's IoU within one f32 ulp of ``thr``."""
    t = np.float32(thr)
    lo, hi = np.nextafter(t, -np.inf), np.nextafter(t, np.inf)
    return int(((iou >= lo) & (iou <= hi)).sum())


@pytest.mark.parametrize('k', [1, 17, 128, 700])
@pytest.mark.parametrize('thr', [0.01, 0.3, 0.7])
def test_nms_normal_bev_keep_equal(k, thr):
    boxes, scores, valid = nms_case(k, seed=k)
    want = np.asarray(jax.jit(jnms.nms_normal_bev, static_argnums=2)(
        jnp.asarray(boxes), jnp.asarray(scores), thr, jnp.asarray(valid)))
    tb = torch.from_numpy(boxes)[None]
    got = tnms.nms_normal_bev(tb, thr, torch.from_numpy(valid)[None])[0]
    iou = tnms.aligned_iou_bev(tb)[0].numpy()
    near = near_threshold(iou, thr)
    if near:
        print(f'nms_normal_bev K={k} thr={thr}: {near} IoUs within one ulp '
              f'of the threshold')
    np.testing.assert_array_equal(got.numpy(), want)
    if k > 1:
        assert 0 < want.sum() < valid.sum()


def test_top_k_matches_lax_top_k():
    """The head's ``top_k`` (candidates before NMS) picks what
    ``lax.top_k`` picks, in its order, ties to the lower index."""
    rng = np.random.RandomState(5)
    scores = rng.randint(0, 20, (3, 64)).astype(np.float32)   # many ties
    got = tnms.top_k(torch.from_numpy(scores), 16)
    want = jax.lax.top_k(jnp.asarray(scores), 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


AXIS_HEAD = dict(test_cfg=dict(use_rotate_nms=False, nms_thr=0.3,
                               score_thr=0.05, nms_pre=128, max_num=32))


def test_tiny_predict_axis_aligned_nms():
    """The TINY predict with ``use_rotate_nms=False`` equals JAX's: labels
    and valid exactly, scores and boxes within the rotated predict's
    tolerances (``tests/test_torch_predict.py::test_predict``)."""
    jd = jdet.PointPillarsDetector(model_cfg=TINY_MODEL, head_cfg=AXIS_HEAD)
    batch = jdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                 pc_range=TINY_MODEL['point_cloud_range'])
    variables = jax.jit(jd.init)(jax.random.PRNGKey(0), batch)
    variables = randomize(variables, np.random.RandomState(0))
    want = [np.asarray(x) for x in jax.jit(jd.predict)(variables, batch)]

    td = tdet.PointPillarsDetector(dict(TINY_MODEL, s2d_canvas='off'),
                                   AXIS_HEAD, device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(variables), strict=True)
    tbatch = tdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                  pc_range=TINY_MODEL['point_cloud_range'],
                                  device='cpu')
    got = [x.numpy() for x in td.predict(tbatch)]
    with torch.inference_mode():
        maps = td.apply_eval(tbatch)
        b_sorted, _, v_sorted = td.head.select_candidates(
            maps[0], maps[1], maps[2], td.anchors)
    k = b_sorted.shape[2]
    iou = tnms.aligned_iou_bev(
        b_sorted[..., [0, 1, 3, 4, 6]].reshape(-1, k, 5)).numpy()
    v = v_sorted.reshape(-1, k).numpy()
    pair = v[:, :, None] & v[:, None, :]
    assert np.abs(iou[pair] - AXIS_HEAD['test_cfg']['nms_thr']).min() > 1e-4
    assert got[3].sum() >= 10

    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2][got[3]], want[2][want[3]])
    np.testing.assert_allclose(got[1][got[3]], want[1][want[3]], atol=1e-5)
    np.testing.assert_allclose(got[0][got[3]], want[0][want[3]], atol=1e-4)


@pytest.mark.parametrize('which', ['affinity', 'matcher'])
def test_require_native_refuses_numpy(monkeypatch, which):
    """With ``MMDET3D_TPU_REQUIRE_NATIVE=1`` and no native library, the
    affinity calculators and the matcher raise, as JAX's do; without the
    variable they take the numpy versions."""
    from mmdet3d_gaussian_tpu_torch.core.evaluation import (affinity,
                                                            matcher, native)
    monkeypatch.setattr(native, 'available', lambda: False)

    def fail(*args, **kwargs):
        raise AssertionError('the native library was called')
    for name in ('iou_bev', 'iou_3d', 'match_coco_native'):
        monkeypatch.setattr(native, name, fail)
    det = np.array([[0, 0, 0, 2, 2, 2, 0]], np.float32)
    gt = np.array([[0.5, 0, 0, 2, 2, 2, 0]], np.float32)
    run = {'affinity': lambda: affinity.LidarIOU3D()(det, gt),
           'matcher': lambda: matcher.MatcherCoCo([0.5])(
               np.array([[0.7]], np.float32))}[which]
    monkeypatch.delenv('MMDET3D_TPU_REQUIRE_NATIVE', raising=False)
    out = np.asarray(run())
    want = {'affinity': [[1.5 * 2 * 2 / (2 * 8 - 1.5 * 2 * 2)]],
            'matcher': [[0]]}[which]
    np.testing.assert_allclose(out, want, rtol=1e-6)
    monkeypatch.setenv('MMDET3D_TPU_REQUIRE_NATIVE', '1')
    with pytest.raises(RuntimeError, match='MMDET3D_TPU_REQUIRE_NATIVE=1'):
        run()
