"""The port's datasets and data pipeline against the JAX package's.

A KITTI-format tree (``tests/test_train_loop.py::make_kitti_tree``, 6
frames of 800 points) with a GT database written by
``tools/data_converter/create_gt_database.py``; the flagship config's
pipelines with every path pointed at it.  ``dataset[i]`` must be bitwise
equal in both packages under the test pipeline and under the full train
pipeline with every random transform seeded (frames stay within
``Pad3D.num_points``, so ``Pad3D`` draws nothing from the global
generator); the wrappers, ``collate_batch``, the pooled iterator (1 and 2
workers) and the eval split's padding must give the same batches.
"""
import copy
import os

import numpy as np
import pytest

import mmdet3d_gaussian_tpu  # noqa: F401  (registers the JAX datasets)
from mmdet3d_gaussian_tpu.engine import loop as jloop
from mmdet3d_gaussian_tpu.registry import DATASETS as JDATASETS
from mmdet3d_gaussian_tpu.utils.config import Config as JConfig

from mmdet3d_gaussian_tpu_torch import datasets as _tdatasets  # noqa: F401
from mmdet3d_gaussian_tpu_torch.datasets import mem_util as tmem
from mmdet3d_gaussian_tpu_torch.datasets.pipelines import collate_batch
from mmdet3d_gaussian_tpu_torch.engine import loop as tloop
from mmdet3d_gaussian_tpu_torch.registry import DATASETS as TDATASETS
from mmdet3d_gaussian_tpu_torch.utils.config import Config as TConfig

from tests.test_train_loop import make_kitti_tree
from tools.data_converter.create_gt_database import (
    create_groundtruth_database)

FLAGSHIP = os.path.join(
    os.path.dirname(__file__), '..', 'configs', 'kitti',
    'hv_pointpillars_secfpn_kld5tau1_12x4_160e_kitti-3d-3class.py')
# a seed for every random transform of the train pipeline
SEEDS = {'ObjectNoise': 11, 'RandomFlip3D': 12, 'GlobalRotScaleTrans': 13,
         'PointShuffle': 14}
DB_SEED = 15


@pytest.fixture(scope='module')
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('kitti')
    make_kitti_tree(root, num_frames=6, seed=3)
    # the converter reads ``velodyne_path`` under the data root
    os.makedirs(root / 'training' / 'velodyne', exist_ok=True)
    for name in os.listdir(root / 'training' / 'velodyne_reduced'):
        os.link(root / 'training' / 'velodyne_reduced' / name,
                root / 'training' / 'velodyne' / name)
    create_groundtruth_database(str(root),
                                str(root / 'kitti_infos_train.pkl'))
    return root


def flagship_data(root, seeded=True):
    """The flagship config's ``data`` dict with every path under ``root``
    (and, with ``seeded``, a seed for every random transform)."""
    data = JConfig.fromfile(FLAGSHIP).to_dict()['data']
    data = copy.deepcopy(data)
    r = str(root) + '/'
    train = data['train']['dataset']
    train.update(data_root=r, ann_file=r + 'kitti_infos_train.pkl')
    data['val'].update(data_root=r, ann_file=r + 'kitti_infos_train.pkl')
    for t in train['pipeline']:
        if t['type'] == 'ObjectSample':
            t['db_sampler'].update(info_path=r + 'kitti_dbinfos_train.pkl',
                                   data_root=r)
            if seeded:
                t['db_sampler']['seed'] = DB_SEED
        elif seeded and t['type'] in SEEDS:
            t['seed'] = SEEDS[t['type']]
    return data


def assert_items_equal(got, want):
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for k, w in want.items():
        if k == 'meta':
            assert got[k].keys() == w.keys()
            for mk, mv in w.items():
                np.testing.assert_array_equal(got[k][mk], mv)
            continue
        assert got[k].dtype == w.dtype, k
        assert got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k


def test_gt_database_sampled(kitti_root):
    data = flagship_data(kitti_root)
    ds = TDATASETS.build(copy.deepcopy(data['train']['dataset']))
    sampler = ds.pipeline.transforms[1].db_sampler
    assert len(sampler.db_infos['Car']) > 0
    item = ds[0]
    # frames of 800 points plus pasted objects stay within Pad3D
    assert item['points_mask'].sum() < 20000
    assert item['gt_valid'].sum() > 3


@pytest.mark.parametrize('split', ['val', 'train'])
def test_items_bitwise_equal(kitti_root, split):
    """Every frame, test pipeline (val) and seeded train pipeline."""
    data = flagship_data(kitti_root)
    cfg = data[split] if split == 'val' else data['train']['dataset']
    jds = JDATASETS.build(copy.deepcopy(cfg))
    tds = TDATASETS.build(copy.deepcopy(cfg))
    assert len(tds) == len(jds) == 6
    for i in range(len(jds)):
        assert_items_equal(tds[i], jds[i])
        ja, ta = jds.get_ann_info(i), tds.get_ann_info(i)
        np.testing.assert_array_equal(ta['gt_bboxes'], ja['gt_bboxes'])
        np.testing.assert_array_equal(ta['gt_labels'], ja['gt_labels'])


@pytest.mark.parametrize('wrapper', ['RepeatDataset', 'CBGSDataset'])
def test_wrappers_match(kitti_root, wrapper):
    data = flagship_data(kitti_root)
    inner = data['val']
    cfg = (dict(type=wrapper, times=2, dataset=inner)
           if wrapper == 'RepeatDataset'
           else dict(type=wrapper, dataset=inner, seed=4))
    jds = JDATASETS.build(copy.deepcopy(cfg))
    tds = TDATASETS.build(copy.deepcopy(cfg))
    assert len(tds) == len(jds)
    assert tds.CLASSES == jds.CLASSES
    if wrapper == 'CBGSDataset':
        assert tds.indices == jds.indices
    for i in range(len(jds)):
        assert_items_equal(tds[i], jds[i])
        np.testing.assert_array_equal(tds.get_ann_info(i)['gt_bboxes'],
                                      jds.get_ann_info(i)['gt_bboxes'])


def _loader_cfg(root, workers, batch):
    data = flagship_data(root)
    # the test pipeline (deterministic) under the train split's
    # RepeatDataset: batches are then equal whatever the thread count
    data['train']['dataset']['pipeline'] = data['val']['pipeline']
    data.update(samples_per_gpu=batch, workers_per_gpu=workers)
    return dict(data=data)


@pytest.mark.parametrize('workers', [1, 2])
@pytest.mark.parametrize('split', ['train', 'val'])
def test_dataloader_batches_match(kitti_root, workers, split):
    """Shuffled train batches (drop the rest) and in-order eval batches
    (last one padded with its last sample) are the same in both packages,
    and the same with 1 and 2 workers."""
    cfg = _loader_cfg(kitti_root, workers, batch=4)
    jds, jit = jloop.build_dataloader(JConfig(cfg), split)
    tds, tit = tloop.build_dataloader(TConfig(cfg), split)
    assert len(tds) == len(jds)
    jb, tb = list(jit(7)), list(tit(7))
    serial = list(tloop.build_dataloader(
        TConfig(_loader_cfg(kitti_root, 1, 4)), split)[1](7))
    n = len(jds)
    assert len(tb) == len(jb) == (n // 4 if split == 'train' else -(-n // 4))
    for t, j, s in zip(tb, jb, serial):
        assert [m['sample_idx'] for m in t['metas']] == \
            [m['sample_idx'] for m in j['metas']] == \
            [m['sample_idx'] for m in s['metas']]
        for k in ('points', 'points_mask', 'gt_bboxes', 'gt_labels',
                  'gt_valid'):
            assert np.array_equal(t[k], j[k]) and np.array_equal(t[k], s[k])
    if split == 'val':
        last = [m['sample_idx'] for m in tb[-1]['metas']]
        assert last == [4, 5, 5, 5]


def test_collate_batch_matches(kitti_root):
    from mmdet3d_gaussian_tpu.datasets.pipelines import (
        collate_batch as jcollate)
    data = flagship_data(kitti_root)
    ds = TDATASETS.build(copy.deepcopy(data['val']))
    items = [ds[i] for i in (2, 0, 5)]
    got, want = collate_batch(items), jcollate(items)
    assert set(got) == set(want)
    for k in want:
        if k == 'metas':
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])
    assert got['points'].shape == (3, 20000, 4)


def test_shared_list_roundtrip():
    data = [dict(a=np.arange(3)), 'x', None, 3.5]
    owner = tmem.SharedList(data)
    try:
        reader = tmem.SharedList(name=owner.name)
        assert len(reader) == 4
        np.testing.assert_array_equal(reader[0]['a'], np.arange(3))
        assert reader[1] == 'x' and reader[2] is None and reader[3] == 3.5
        d = tmem.SharedDictOfList({'Car': [1, 2], 'Ped': [3]})
        assert list(d.keys()) == ['Car', 'Ped'] and d['Car'][1] == 2
        for lst in [d._keys, *d._lists.values()]:
            lst.cleanup()
    finally:
        owner.cleanup()


@pytest.mark.parametrize('span', [4.0, 12.0, 70.0])
def test_object_noise_matches_crowded(span):
    """``ObjectNoise`` on scenes from packed (most candidates collide, some
    boxes keep their pose) to KITTI-sparse: the port tests candidates in
    chunks against the nearby boxes only, and must draw and move exactly
    what the JAX package's all-pairs clipping does."""
    from mmdet3d_gaussian_tpu.datasets.pipelines import ObjectNoise as J
    from mmdet3d_gaussian_tpu_torch.datasets.pipelines import ObjectNoise as T
    rng = np.random.RandomState(int(span))
    for seed in range(4):
        g = 30
        boxes = np.zeros((g, 7), np.float32)
        boxes[:, 0] = rng.uniform(0, span, g)
        boxes[:, 1] = rng.uniform(-span / 2, span / 2, g)
        boxes[:, 2] = rng.uniform(-2, 0, g)
        boxes[:, 3] = rng.uniform(0.5, 4.5, g)
        boxes[:, 4] = rng.uniform(0.5, 2.0, g)
        boxes[:, 5] = rng.uniform(1.0, 2.0, g)
        boxes[:, 6] = rng.uniform(-3, 3, g)
        points = np.c_[rng.uniform(0, span, (4000, 1)),
                       rng.uniform(-span / 2, span / 2, (4000, 1)),
                       rng.uniform(-2, 1, (4000, 2))].astype(np.float32)
        want = J(seed=seed)(dict(gt_bboxes=boxes.copy(),
                                 points=points.copy()))
        got = T(seed=seed)(dict(gt_bboxes=boxes.copy(),
                                points=points.copy()))
        assert np.array_equal(got['gt_bboxes'], want['gt_bboxes'])
        assert np.array_equal(got['points'], want['points'])
        moved = (got['gt_bboxes'] != boxes).any(1)
        if span == 70.0:
            assert moved.all()
        else:
            assert moved.any()
