"""The traffic generators: deterministic from the seed, any seed up to a
little over 2**31 and beyond, the sizes the mixes and the configurations'
pipelines state."""
import json

import numpy as np
import pytest

from portbench import traffic
from portbench.families.common import live_pillars
from portbench.run import ROOT
from portbench.traffic import nus_lidar
from portbench.traffic.common import bev_overlap

SEED = 2 ** 31 + 12345
MIXES = ['kitti_train_b12', 'nus_lidar_b4']


@pytest.mark.parametrize('name', MIXES)
def test_equal_seeds_equal_arrays(name):
    tf = dict(traffic.load(name), pool=2)
    a, b = traffic.make_pool(tf, SEED), traffic.make_pool(tf, SEED)
    c = traffic.make_pool(tf, SEED + 1)
    for x, y, z in zip(a, b, c):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
        assert not np.array_equal(x['points'], z['points'])


@pytest.mark.parametrize('name', MIXES)
def test_sizes_as_stated(name):
    tf = dict(traffic.load(name), pool=1)
    (batch,) = traffic.make_pool(tf, 7)
    live = batch['points_mask'].sum(1)
    assert batch['points'].shape == (tf['frames'], tf['pad_points'],
                                     batch['points'].shape[2])
    assert batch['gt_bboxes'].shape[:2] == (tf['frames'], tf['pad_boxes'])
    lo = tf.get('spread', {}).get('points', [tf['pad_points']])[0]
    assert (live >= min(lo, tf['pad_points'])).all()
    assert (batch['gt_valid'].sum(1) >= 1).all()


def test_kitti_boxes_as_the_gt_sampler_leaves_them():
    """Each class filled up to its sample group where no box is in the
    way, and no two boxes overlapping in BEV."""
    tf = dict(traffic.load('kitti_train_b12'), pool=1)
    (batch,) = traffic.make_pool(tf, 11)
    groups = list(tf['sample_groups'].values())
    counts = []
    for boxes, labels, valid in zip(batch['gt_bboxes'], batch['gt_labels'],
                                    batch['gt_valid']):
        boxes, labels = boxes[valid], labels[valid]
        per = np.bincount(labels, minlength=3)
        assert (per <= max(groups)).all()
        counts.append(len(boxes))
        for i in range(len(boxes)):
            for j in range(i):
                assert not bev_overlap(boxes[i], boxes[j])
    assert np.mean(counts) > 0.6 * sum(groups)


def test_density_falls_with_range():
    tf = dict(traffic.load('kitti_train_b12'), pool=1)
    (batch,) = traffic.make_pool(tf, 3)
    pts = batch['points'][0][batch['points_mask'][0]]
    r = np.hypot(pts[:, 0], pts[:, 1])
    near = ((r > 5) & (r < 10)).sum() / (np.pi / 4 * (10 ** 2 - 5 ** 2))
    far = ((r > 50) & (r < 55)).sum() / (np.pi / 4 * (55 ** 2 - 50 ** 2))
    assert near > 10 * far


def test_sweeps_of_a_moving_ego_fill_more_pillars():
    """The pillars of a nuScenes frame follow from the sensor's motion: ten
    sweeps from a moving ego land on more pillars than from a standing
    one, in the same street."""
    tf = traffic.load('nus_lidar_b4')
    model = json.loads((ROOT / 'portbench' / 'configs'
                        / 'centerpoint_nus_gwd5.json').read_text())['model']
    pillars = []
    for speed in (0.0, 12.0):
        size = dict(objects=30, ego_speed_mps=speed, street_half_width_m=20.0)
        pts, _b, _l = nus_lidar.frame(traffic.rng_for(5), tf, size)
        pillars.append(live_pillars(
            dict(points=pts[None], points_mask=np.ones((1, len(pts)), bool)),
            model)[0])
        lag = np.unique(pts[:, 4])
        assert len(lag) == tf['sweeps'] and lag[0] == 0.0
    assert pillars[1] > 1.5 * pillars[0], pillars


@pytest.mark.parametrize('name', MIXES)
def test_every_seed_gets_the_same_sizes(name):
    tf = traffic.load(name)
    a = traffic.frame_sizes(tf, 1)
    b = traffic.frame_sizes(tf, SEED)
    assert a != b
    for key in a[0]:
        assert sorted(f[key] for f in a) == sorted(f[key] for f in b)
