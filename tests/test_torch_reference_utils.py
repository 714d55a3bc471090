"""The port's three reference utilities that no head calls, against the
JAX package on the same inputs: ``SimOTABEVAssigner`` (the SimOTA cases
of ``tests/test_assigners.py``, and random scenes with every output
compared), ``Point3DRangeGenerator`` and ``PointBBoxYawCoder``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmdet3d_gaussian_tpu.core import anchor as janchor
from mmdet3d_gaussian_tpu.core.bbox import assigners as jassign
from mmdet3d_gaussian_tpu.core.bbox import coders as jcoders
from mmdet3d_gaussian_tpu.core.evaluation import geometry_np as G

from mmdet3d_gaussian_tpu_torch.core import anchor as tanchor
from mmdet3d_gaussian_tpu_torch.core.bbox import assigners as tassign
from mmdet3d_gaussian_tpu_torch.core.bbox import coders as tcoders
from mmdet3d_gaussian_tpu_torch.registry import (ANCHOR_GENERATORS,
                                                 BBOX_CODERS)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _same_result(got, want):
    np.testing.assert_array_equal(got.assigned_gt.numpy(),
                                  np.asarray(want.assigned_gt))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(want.max_overlaps), rtol=0,
                               atol=0)


def test_simota_assigns_in_box_priors():
    gt = np.asarray([[5.0, 5.0, -1.5, 4.0, 2.0, 1.5, 0.0]], np.float32)
    xs, ys = np.meshgrid(np.arange(0, 10, 1.0), np.arange(0, 10, 1.0))
    priors = np.stack([xs.ravel(), ys.ravel(),
                       np.full(xs.size, 1.0)], -1).astype(np.float32)
    d = np.linalg.norm(priors[:, :2] - np.array([5.0, 5.0]), axis=-1)
    ious = np.clip(1.0 - d / 5.0, 0, 1)[None, :].astype(np.float32)
    scores = np.full((priors.shape[0], 3), 0.5, np.float32)
    args = (priors, scores, ious, gt, np.asarray([1], np.int32),
            np.ones(1, bool))
    res = tassign.SimOTABEVAssigner(center_radius=2.5, candidate_topk=10) \
        .assign(*map(_t, args))
    got = res.assigned_gt.numpy()
    pos = got > 0
    assert pos.sum() >= 1
    for i in np.where(pos)[0]:
        assert abs(priors[i, 0] - 5.0) <= 2.0 + 1e-5
        assert abs(priors[i, 1] - 5.0) <= 2.5 + 1e-5
    assert (res.labels.numpy()[pos] == 1).all()
    want = jassign.SimOTABEVAssigner(center_radius=2.5, candidate_topk=10) \
        .assign(*map(jnp.asarray, args))
    _same_result(res, want)


def test_simota_no_gt():
    args = (np.asarray([[1.0, 1.0, 1.0]], np.float32),
            np.full((1, 3), 0.5, np.float32), np.zeros((1, 1), np.float32),
            np.zeros((1, 7), np.float32), np.zeros(1, np.int32),
            np.zeros(1, bool))
    res = tassign.SimOTABEVAssigner().assign(*map(_t, args))
    assert res.assigned_gt.numpy()[0] == 0
    _same_result(res, jassign.SimOTABEVAssigner().assign(
        *map(jnp.asarray, args)))


@pytest.mark.parametrize('seed,box_gate', [(17, True), (3, True),
                                           (5, False)])
def test_simota_matches_jax(seed, box_gate):
    """The scene of ``tests/test_assigners.py::test_sim_ota_matches_
    reference`` (priors on a grid, noisy decoded boxes, 3D IoU), some gts
    padded out: assignment, labels and matched IoUs equal to JAX's."""
    rng = np.random.RandomState(seed)
    a, c, g = 240, 3, 6
    xs, ys = np.meshgrid(np.linspace(1, 24, 16), np.linspace(-11, 11, 15))
    centers = np.c_[xs.ravel(), ys.ravel()][:a].astype(np.float32)
    priors = np.c_[centers, np.full((a, 1), 2.0)].astype(np.float32)
    scores = rng.uniform(0.05, 0.95, (a, c)).astype(np.float32)
    gts = np.c_[rng.uniform(4, 22, (g, 1)), rng.uniform(-9, 9, (g, 1)),
                rng.uniform(-2, -1, (g, 1)), rng.uniform(2.5, 5.0, (g, 1)),
                rng.uniform(1.5, 2.2, (g, 1)), rng.uniform(1.3, 1.9, (g, 1)),
                rng.uniform(-3, 3, (g, 1))].astype(np.float32)
    labels = rng.randint(0, c, g).astype(np.int32)
    valid = np.ones(g, bool)
    valid[-1] = False
    near = np.argmin(np.linalg.norm(
        centers[:, None] - gts[None, :, :2], axis=-1), axis=1)
    dec = gts[near].copy()
    dec[:, :2] = centers + rng.randn(a, 2) * 0.8
    dec[:, 2:6] += rng.randn(a, 4).astype(np.float32) * 0.15
    ious = G.iou_3d(dec.astype(np.float64),
                    gts.astype(np.float64)).T.astype(np.float32)
    args = (priors, scores, ious, gts, labels, valid)
    kw = dict(center_radius=0.5, candidate_topk=10, iou_weight=3.0,
              cls_weight=1.0, match_init=2.0, use_box_gate=box_gate)
    got = tassign.SimOTABEVAssigner(**kw).assign(*map(_t, args))
    want = jassign.SimOTABEVAssigner(**kw).assign(*map(jnp.asarray, args))
    assert (got.assigned_gt.numpy() > 0).sum() > 0
    _same_result(got, want)


def test_point3d_range_generator_matches_jax():
    kw = dict(point_cloud_range=(0, -39.68, -3, 69.12, 39.68, 1),
              strides=(1, 2, 4))
    gen = ANCHOR_GENERATORS.build(dict(type='Point3DRangeGenerator', **kw))
    assert isinstance(gen, tanchor.Point3DRangeGenerator)
    sizes = [(248, 216), (124, 108), (62, 54)]
    got = gen.grid_priors(sizes, 0.32)
    want = janchor.Point3DRangeGenerator(**kw).grid_priors(sizes, 0.32)
    for g, w, (h, wd) in zip(got, want, sizes):
        assert g.shape == (h, wd, 3) and g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize('correct_yaw', [True, False])
def test_point_bbox_yaw_coder_matches_jax(correct_yaw):
    rng = np.random.RandomState(4)
    n = 64
    priors = np.c_[rng.uniform(0, 70, (n, 2)),
                   rng.choice([0.32, 0.64, 1.28], (n, 1))].astype(np.float32)
    pred = rng.normal(0, 1, (n, 11)).astype(np.float32)
    boxes = np.c_[rng.uniform(-5, 5, (n, 6)), rng.uniform(-3, 3, (n, 1)),
                  rng.normal(0, 1, (n, 2))].astype(np.float32)
    coder = BBOX_CODERS.build(dict(type='PointBBoxYawCoder'))
    assert isinstance(coder, tcoders.PointBBoxYawCoder)
    jc = jcoders.PointBBoxYawCoder()
    got = coder.decode(_t(priors), _t(pred), correct_yaw).numpy()
    want = np.asarray(jc.decode(jnp.asarray(priors), jnp.asarray(pred),
                                correct_yaw))
    assert got.shape == (n, 9)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(coder.encode(_t(boxes)).numpy(),
                               np.asarray(jc.encode(jnp.asarray(boxes))),
                               rtol=1e-6, atol=1e-6)
