"""Waymo in the port against the JAX package on the CPU.

* ``WaymoDataset`` on ``tests/test_waymo_path.py``'s tree (6-column bins,
  5 used, the intensity through ``NormalizeIntensityTanh`` and seeded
  random transforms): every item bitwise equal to JAX's, the annotations a
  ``SharedList`` in both, the Waymo class set; its ``'waymo'`` and
  ``'cowa'`` reports on random detections equal to JAX's.
* ``eval_waymo`` on random detections against JAX's: level-2 boxes (by
  mark and by fewer than 5 points), boxes with no point (dropped), heading
  errors up to a flip (APH below AP), a class without boxes, frames
  without detections.
* A TINY Waymo-shaped model (5 channels, a stride-1 first stage, a
  3 x 16-channel neck, aligned anchors with a z per class, the GWD
  decoded-box loss of the ``gwd5`` Waymo config through K3's plain
  version), JAX's variables carried over by ``jax_variables_to_torch``:
  the predict's maps within 1e-4 and detections equal, one dense-target
  train step's loss terms within 1e-5, gradients within 1e-4 of each
  leaf's largest (``tests/test_torch_hard.py``'s f32 tolerance) and
  running statistics within 1e-5.
"""
import copy

import numpy as np
import pytest
import torch

import jax

import mmdet3d_gaussian_tpu  # noqa: F401  (registers the JAX datasets)
from mmdet3d_gaussian_tpu.core.evaluation import waymo_metrics as jwm
from mmdet3d_gaussian_tpu.datasets.mem_util import SharedList as JShared
from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.registry import DATASETS as JDATASETS

from mmdet3d_gaussian_tpu_torch import datasets  # noqa: F401
from mmdet3d_gaussian_tpu_torch.core.evaluation import waymo_metrics as twm
from mmdet3d_gaussian_tpu_torch.datasets.mem_util import SharedList as TShared
from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.registry import DATASETS as TDATASETS
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

from .test_torch_datasets import assert_items_equal
from .test_torch_train import _np_tree, randomize
from .test_waymo_path import make_waymo_tree

torch.set_num_threads(2)

PCR = [0, -12.8, -3, 25.6, 12.8, 1]
CLASSES = ('Car', 'Pedestrian', 'Cyclist')


def _pipeline():
    return [dict(type='LoadPointsFromFile', load_dim=6, use_dim=5),
            dict(type='NormalizeIntensityTanh', pre_gain=2.0),
            dict(type='RandomFlip3D', flip_ratio_bev_horizontal=0.5,
                 flip_ratio_bev_vertical=0.5, seed=1),
            dict(type='GlobalRotScaleTrans', rot_range=[-0.3, 0.3],
                 scale_ratio_range=[0.95, 1.05], seed=2),
            dict(type='PointsRangeFilter', point_cloud_range=PCR),
            dict(type='ObjectRangeFilter', point_cloud_range=PCR),
            dict(type='PointShuffle', seed=3),
            dict(type='Pad3D', num_points=1024, num_gt=8)]


@pytest.fixture(scope='module')
def waymo_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp('waymo')
    make_waymo_tree(root, num_frames=5)
    cfg = dict(type='WaymoDataset', data_root=str(root),
               ann_file=str(root / 'waymo_infos_train.pkl'),
               use_shared_memory=True, pipeline=_pipeline())
    return (JDATASETS.build(copy.deepcopy(cfg)),
            TDATASETS.build(copy.deepcopy(cfg)))


def test_waymo_items_bitwise_equal(waymo_sets):
    jds, tds = waymo_sets
    assert isinstance(jds.data_infos, JShared)
    assert isinstance(tds.data_infos, TShared)
    assert tuple(tds.CLASSES) == tuple(jds.CLASSES) == CLASSES
    assert len(tds) == len(jds) == 5
    for i in range(len(jds)):
        ti, ji = tds[i], jds[i]
        assert ti['points'].shape == (1024, 5)
        assert_items_equal(ti, ji)
        ja, ta = jds.get_ann_info(i), tds.get_ann_info(i)
        np.testing.assert_array_equal(ta['gt_bboxes'], ja['gt_bboxes'])
        np.testing.assert_array_equal(ta['gt_labels'], ja['gt_labels'])


# ------------------------------------------------------------------- metric
def _eval_case(seed=0, frames=6):
    """Annotations and detections: class 0 with level-2 boxes by mark and
    by point count, one box without points, detections near the boxes
    with heading errors up to a flip plus false positives; class 1 with a
    few boxes; class 2 with no box but false positives; the last frame
    without detections."""
    rng = np.random.RandomState(seed)
    anns, results = [], []
    for f in range(frames):
        n = rng.randint(3, 8)
        labels = np.r_[np.zeros(n - 2, np.int64), np.ones(2, np.int64)]
        boxes = np.c_[rng.uniform(0, 40, n), rng.uniform(-20, 20, n),
                      rng.uniform(-1, 0, n), rng.uniform(1, 5, (n, 3)),
                      rng.uniform(-np.pi, np.pi, n)].astype(np.float32)
        difficulty = np.where(rng.rand(n) < 0.3, 2, 1)
        npts = rng.randint(0, 40, n)
        npts[0] = 0                    # dropped
        npts[1] = 3                    # level 2 by count
        anns.append(dict(gt_bboxes=boxes, gt_labels=labels,
                         gt_attrs=dict(difficulty=difficulty,
                                       num_points_in_gt=npts)))
        per_class = []
        for c in range(3):
            own = boxes[labels == c]
            hit = own[rng.rand(len(own)) < 0.8].copy()
            hit[:, :3] += rng.normal(0, 0.15, (len(hit), 3))
            hit[:, 6] += rng.choice([0.0, 0.3, np.pi], len(hit))
            fp = np.c_[rng.uniform(0, 40, (2, 1)),
                       rng.uniform(-20, 20, (2, 1)),
                       rng.uniform(-1, 0, (2, 1)), rng.uniform(1, 5, (2, 3)),
                       rng.uniform(-np.pi, np.pi, (2, 1))]
            det = np.concatenate([hit, fp])
            if f == frames - 1:
                det = det[:0]
            per_class.append(np.c_[det, rng.rand(len(det))].astype(
                np.float32))
        results.append(per_class)
    return anns, results


def test_eval_waymo_matches_jax():
    anns, results = _eval_case()
    want = jwm.eval_waymo(results, anns, logger='quiet')
    got = twm.eval_waymo(results, anns, logger='quiet')
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
    assert want['Car/L1/AP'] > want['Car/L1/APH'] > 0
    assert want['Cyclist/L1/AP'] == 0.0
    assert want['Car/L2/AP'] != want['Car/L1/AP']
    for fn in ('heading_accuracy', 'gt_levels', 'score_cutoffs'):
        assert getattr(twm, fn).__doc__ == getattr(jwm, fn).__doc__
    np.testing.assert_array_equal(
        twm.gt_levels(np.array([1, 2, 1, 1]), np.array([9, 9, 4, 0])),
        jwm.gt_levels(np.array([1, 2, 1, 1]), np.array([9, 9, 4, 0])))


@pytest.mark.parametrize('metric', ['waymo', 'cowa'])
def test_dataset_evaluate_matches_jax(waymo_sets, metric):
    jds, tds = waymo_sets
    rng = np.random.RandomState(1)
    results = []
    for i in range(len(jds)):
        ann = jds.get_ann_info(i)
        per_class = []
        for c in range(3):
            own = ann['gt_bboxes'][ann['gt_labels'] == c]
            det = own + rng.normal(0, 0.1, own.shape).astype(np.float32)
            per_class.append(np.c_[det, rng.rand(len(det))].astype(
                np.float32))
        results.append(per_class)
    want = jds.evaluate(copy.deepcopy(results), metric=metric,
                        logger='quiet')
    got = tds.evaluate(copy.deepcopy(results), metric=metric,
                       logger='quiet')
    assert set(got) == set(want) and len(want) >= 2
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
    key = 'mAP_L2' if metric == 'waymo' else 'mAP'
    assert 0 < want[key] <= 1


# ------------------------------------------------- a TINY Waymo-shaped model
WPCR = (-12.8, -12.8, -2.0, 12.8, 12.8, 4.0)
TINY_WAYMO = dict(
    voxel_size=(0.4, 0.4, 6.0), point_cloud_range=WPCR,
    max_points_per_voxel=8, max_voxels_per_sample=2048,
    voxelize_mode='hard',
    encoder_cfg=dict(in_channels=5, feat_channels=(16,)),
    backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                      layer_nums=(1, 1, 1), layer_strides=(1, 2, 2)),
    neck_cfg=dict(in_channels=(16, 32, 64), out_channels=(16, 16, 16),
                  upsample_strides=(1, 2, 4)),
    head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=48))
TINY_WAYMO_HEAD = dict(
    num_classes=3,
    anchor_generator=dict(
        aligned=True,
        ranges=[[-12.8, -12.8, -0.0345, 12.8, 12.8, -0.0345],
                [-12.8, -12.8, 0.0, 12.8, 12.8, 0.0],
                [-12.8, -12.8, -0.1188, 12.8, 12.8, -0.1188]],
        sizes=[[4.73, 2.08, 1.77], [0.91, 0.84, 1.74], [1.81, 0.84, 1.77]],
        rotations=[0.0, 1.57]),
    assigners=[dict(pos_iou_thr=0.55, neg_iou_thr=0.4, min_pos_iou=0.4),
               dict(pos_iou_thr=0.5, neg_iou_thr=0.3, min_pos_iou=0.3),
               dict(pos_iou_thr=0.5, neg_iou_thr=0.3, min_pos_iou=0.3)],
    loss_decoded_bbox=dict(type='GDLoss', loss_type='gwd3d',
                           center_offset=(0, 0, 0.5), fun='log1p', tau=0.0,
                           loss_weight=5.0),
    code_weight=[0.] * 7, decode_weight=1.0, pos_cap=0,
    test_cfg=dict(use_rotate_nms=True, nms_thr=0.25, score_thr=0.1,
                  nms_pre=128, max_num=32))


@pytest.fixture(scope='module')
def tiny_waymo():
    jd = jdet.PointPillarsDetector(model_cfg=TINY_WAYMO,
                                   head_cfg=TINY_WAYMO_HEAD)
    batch = jdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                 pc_range=WPCR, num_feats=5)
    variables = randomize(_np_tree(jax.jit(jd.init)(jax.random.PRNGKey(0),
                                                    batch)),
                          np.random.RandomState(0))
    det = tdet.PointPillarsDetector(TINY_WAYMO, TINY_WAYMO_HEAD,
                                    device='cpu')
    det.trunk.load_state_dict(jax_variables_to_torch(variables),
                              strict=True)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jd, batch, variables, det, tbatch


def test_tiny_waymo_shapes(tiny_waymo):
    """The Waymo trunk's leaves through the converter: the 5-channel PFN
    (11 features in: 5 channels, the cluster offset and the pillar
    centre offset), the stride-1 first stage, the 48-channel neck."""
    _, _, _, det, _ = tiny_waymo
    sd = det.trunk.state_dict()
    assert sd['voxel_encoder.pfn_layers.0.linear.weight'].shape == (16, 11)
    assert det.trunk.backbone.blocks[0][0].stride == (1, 1)
    assert det.featmap_size == (64, 64)
    assert det.anchors.shape == (64, 64, 3, 2, 7)


def test_tiny_waymo_predict_matches_jax(tiny_waymo):
    jd, batch, variables, det, tbatch = tiny_waymo
    maps = jax.jit(jd.apply_eval)(variables, batch)
    dets = [np.asarray(d) for d in jax.jit(jax.vmap(
        jd.head.get_bboxes, in_axes=(0, 0, 0, None)))(
            maps[0], maps[1], maps[2], jd.anchors)]
    got_maps = det.apply_eval(tbatch)
    for g, w, name in zip(got_maps, maps, ('cls', 'bbox', 'dir')):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    got = [x.numpy() for x in det.predict(tbatch)]
    assert got[3].sum() > 0
    np.testing.assert_array_equal(got[3], dets[3])
    np.testing.assert_array_equal(got[2][got[3]], dets[2][dets[3]])
    np.testing.assert_allclose(got[1][got[3]], dets[1][dets[3]], atol=1e-5)
    np.testing.assert_allclose(got[0][got[3]], dets[0][dets[3]], atol=1e-4)


def test_tiny_waymo_train_step_matches_jax(tiny_waymo):
    jd, batch, variables, det, tbatch = tiny_waymo

    def f(params):
        outs, stats = jd.apply_train(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch)
        total, losses = jd.loss(outs, batch)
        return total, (losses, stats)

    (total, (losses, stats)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(variables['params'])
    want_grads = jax_grads_to_torch(_np_tree(grads))
    want_state = jax_variables_to_torch({'params': variables['params'],
                                         'batch_stats': _np_tree(stats)})
    total_t, losses_t = det.loss(det.apply_train(tbatch), tbatch)
    params = dict(det.trunk.named_parameters())
    grads_t = dict(zip(params, torch.autograd.grad(total_t,
                                                   list(params.values()))))
    assert set(losses_t) == {'loss_cls', 'loss_bbox', 'loss_dir'}
    for k, v in losses.items():
        np.testing.assert_allclose(float(losses_t[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    assert float(losses['loss_bbox']) > 0
    assert set(grads_t) == set(want_grads)
    for k, w in want_grads.items():
        np.testing.assert_allclose(grads_t[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()),
                                   err_msg=k)
    sd = det.trunk.state_dict()
    for k, w in want_state.items():
        if 'running_' in k:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
