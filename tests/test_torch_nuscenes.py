"""The port's nuScenes data, metric and CLIs against the JAX package's.

* ``NuScenesDataset`` items on ``tests/test_nuscenes_path.py``'s tree
  (``make_nus_tree``: 5-dim points, previous sweeps, velocities) bitwise
  equal to JAX's, under the test pipeline and under the nuScenes train
  pipeline with every random transform seeded, plain and in
  ``CBGSDataset``;
* ``nuscenes_eval`` and ``NuScenesDataset.evaluate`` (``nds`` and
  ``iou3d_err``) equal to JAX's on the detections of
  ``tests/test_nuscenes_metrics.py``'s cases;
* the train CLI on a TINY CenterPoint nuScenes config (``CBGSDataset``, a
  deterministic pipeline) for 3 steps from JAX's initial weights
  (``--load-from``), its ``train_log.jsonl`` against JAX's
  ``run_training`` (every loss term and ``grad_norm`` within rtol 1e-4, as
  ``tests/test_torch_loop.py`` holds the KITTI loop); then the test CLI on
  its checkpoint under ``--metric nds`` and ``--metric iou3d_err``.
"""
import copy
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import mmdet3d_gaussian_tpu  # noqa: F401  (registers the JAX datasets)
from mmdet3d_gaussian_tpu.core.evaluation import mean_ap as jmean_ap
from mmdet3d_gaussian_tpu.core.evaluation import nuscenes_metrics as jnm
from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.engine import loop as jloop
from mmdet3d_gaussian_tpu.registry import DATASETS as JDATASETS
from mmdet3d_gaussian_tpu.utils.config import Config as JConfig

from mmdet3d_gaussian_tpu_torch import datasets as _tdatasets  # noqa: F401
from mmdet3d_gaussian_tpu_torch.core.evaluation import nuscenes_metrics \
    as tnm
from mmdet3d_gaussian_tpu_torch.registry import DATASETS as TDATASETS
from mmdet3d_gaussian_tpu_torch.weights import jax_variables_to_torch

from tests.test_nuscenes_metrics import _frames
from tests.test_nuscenes_path import PCR, make_nus_tree

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ['car', 'pedestrian']
STEPS = 3


def eval_pipeline():
    return [
        dict(type='LoadPointsFromFile', load_dim=5, use_dim=5),
        dict(type='LoadPointsFromMultiSweeps', sweeps_num=2,
             use_dim=[0, 1, 2, 3, 4], pad_empty_sweeps=True,
             remove_close=True, test_mode=True),
        dict(type='PointsRangeFilter', point_cloud_range=PCR),
        dict(type='Pad3D', num_points=2048, num_gt=8),
    ]


def train_pipeline(seeded=True):
    """``configs/_base_/datasets/nus-3d.py``'s train pipeline at the TINY
    range, its random transforms seeded (or, unseeded, only the
    deterministic ones)."""
    random = [
        dict(type='RandomFlip3D', flip_ratio_bev_horizontal=0.5,
             flip_ratio_bev_vertical=0.5, seed=1),
        dict(type='GlobalRotScaleTrans', rot_range=[-0.785, 0.785],
             scale_ratio_range=[0.95, 1.05], translation_std=[0.5, 0.5, 0.5],
             seed=2),
    ]
    return [
        dict(type='LoadPointsFromFile', load_dim=5, use_dim=5),
        dict(type='LoadPointsFromMultiSweeps', sweeps_num=2,
             use_dim=[0, 1, 2, 3, 4], pad_empty_sweeps=True,
             remove_close=True),
        *(random if seeded else []),
        dict(type='PointsRangeFilter', point_cloud_range=PCR),
        dict(type='ObjectRangeFilter', point_cloud_range=PCR),
        *([dict(type='PointShuffle', seed=3)] if seeded else []),
        dict(type='Pad3D', num_points=2048, num_gt=8),
    ]


def assert_same(got, want, where='item'):
    """Bitwise equal nested items: dicts, lists, arrays (dtype and shape
    too) and scalars."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            assert_same(got[k], want[k], f'{where}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{where}[{i}]')
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert np.array_equal(got, want), where
    else:
        assert got == want, where


def nus_data(root, pipeline):
    return dict(type='NuScenesDataset', data_root=str(root),
                ann_file=str(root / 'nus_infos.pkl'), classes=CLASSES,
                pipeline=pipeline)


@pytest.fixture(scope='module')
def nus_root(tmp_path_factory):
    return make_nus_tree(tmp_path_factory.mktemp('nus'), num_frames=6)


@pytest.mark.parametrize('split', ['test', 'train', 'cbgs'])
def test_items_bitwise_equal(nus_root, split):
    pipe = eval_pipeline() if split == 'test' else train_pipeline()
    cfg = nus_data(nus_root, pipe)
    if split == 'cbgs':
        cfg = dict(type='CBGSDataset', dataset=cfg)
    jds = JDATASETS.build(copy.deepcopy(cfg))
    tds = TDATASETS.build(copy.deepcopy(cfg))
    assert len(tds) == len(jds) >= 6
    assert tds.CLASSES == jds.CLASSES == tuple(CLASSES)
    for i in range(len(jds)):
        assert_same(tds[i], jds[i])
        ja, ta = jds.get_ann_info(i), tds.get_ann_info(i)
        assert ta['gt_bboxes'].shape[1] == 9
        for k in ('gt_bboxes', 'gt_labels'):
            assert ta[k].dtype == ja[k].dtype
            np.testing.assert_array_equal(ta[k], ja[k])
    item = tds[0]
    assert item['points'].shape == (2048, 5)
    # the time-lag channel: 0 on the key frame, the sweeps' lag after
    lags = set(np.round(item['points'][:, 4].astype(np.float64), 3))
    assert {0.0, 0.05, 0.1} <= lags


def _cases():
    """(det_results, annotations, classes) of the JAX metric tests."""
    def frames(seed, **kw):
        dets, annos = _frames(np.random.default_rng(seed), **kw)
        return dets, annos, ['car', 'truck']

    golden_dets = [[np.array([
        [0.6, 0, 0, 2, 2, 1.5, 0.1, 0.5, 0, 0.9],
        [10, 1, 0, 4, 2, 1.5, np.pi / 4, 1, 2, 0.7],
        [20, 0, 0, 4, 2, 1.5, 0.0, 0, 0, 0.5]], np.float32)]]
    golden_anns = [dict(gt_bboxes=np.array([
        [0, 0, 0, 4, 2, 1.5, 0, 0, 0],
        [10, 0, 0, 4, 2, 1.5, 0, 1, 0]], np.float32),
        gt_labels=np.array([0, 0]))]
    attrs = [dict(a, gt_nus_attrs=np.array([
        jnm.NUS_ATTRIBUTES.index('vehicle.parked'),
        jnm.NUS_ATTRIBUTES.index('vehicle.moving')], np.int32))
        for a in golden_anns]
    fp_dets, fp_annos, fp_cls = frames(6)
    for per_cls in fp_dets:
        fp = per_cls[0][:1].copy()
        fp[:, 0] += 500
        fp[:, -1] = 1.0
        per_cls[0] = np.concatenate([per_cls[0], fp], 0)
    barrier = frames(5, yaw_off=np.pi)
    return {
        'perfect': frames(0, vel=True),
        'offset': frames(1, offset=0.3),
        'gating': frames(2, offset=1.5),
        'scale_orient': frames(3, dim_scale=0.8, yaw_off=0.3),
        'velocity': frames(4, vel=True, vel_off=0.5),
        'barrier': (barrier[0], barrier[1], ['barrier', 'traffic_cone']),
        'false_positives': (fp_dets, fp_annos, fp_cls),
        'golden': (golden_dets, golden_anns, ['car']),
        'golden_attrs': (golden_dets, attrs, ['car']),
    }


@pytest.mark.parametrize('case', list(_cases()))
def test_nuscenes_eval_matches_jax(case):
    dets, annos, classes = _cases()[case]
    want, want_report = jnm.nuscenes_eval(dets, annos, classes)
    got, got_report = tnm.nuscenes_eval(dets, annos, classes)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == v or (np.isnan(got[k]) and np.isnan(v)), k
    assert got_report == want_report
    assert np.isfinite(got['NDS'])


@pytest.mark.parametrize('metric', ['nds', 'iou3d_err'])
def test_dataset_evaluate_matches_jax(tmp_path, metric):
    """``NuScenesDataset.evaluate`` on perturbed ground truth with
    velocities: the same report."""
    rng = np.random.default_rng(8)
    infos = []
    for i in range(12):
        n = 4
        boxes = np.concatenate([
            rng.uniform(-30, 30, (n, 2)), rng.uniform(-2, 0, (n, 1)),
            rng.uniform(1, 4, (n, 3)),
            rng.uniform(-np.pi, np.pi, (n, 1))], -1).astype(np.float32)
        infos.append(dict(lidar_path=f'{i}.bin', gt_boxes=boxes,
                          gt_names=np.array(['car', 'pedestrian', 'car',
                                             'bus']),
                          gt_velocity=rng.uniform(-2, 2, (n, 2))))
    path = tmp_path / 'infos.pkl'
    with open(path, 'wb') as f:
        pickle.dump(dict(infos=infos), f)
    cfg = dict(type='NuScenesDataset', data_root=str(tmp_path),
               ann_file=str(path), pipeline=[], classes=CLASSES)
    jds, tds = JDATASETS.build(dict(cfg)), TDATASETS.build(dict(cfg))
    results = []
    for i in range(len(tds)):
        ann = tds.get_ann_info(i)
        per_cls = []
        for c in range(len(CLASSES)):
            b = ann['gt_bboxes'][ann['gt_labels'] == c][:, :7].copy()
            b[:, :2] += rng.normal(0, 0.3, (len(b), 2))
            sc = rng.uniform(0.2, 1, (len(b), 1))
            per_cls.append(np.concatenate([b, sc], -1).astype(np.float32))
        results.append(per_cls)
    got = tds.evaluate(results, metric=metric)
    if metric == 'nds':
        want = jds.evaluate(results, metric=metric)
    else:
        # JAX hands the evaluator the 9-column boxes and raises; the port
        # evaluates their first 7 columns, as JAX's evaluator does when
        # given them
        with pytest.raises(ValueError, match='reshape'):
            jds.evaluate(results, metric=metric)
        annos = [dict(jds.get_ann_info(i)) for i in range(len(jds))]
        for a in annos:
            a['gt_bboxes'] = a['gt_bboxes'][:, :7]
        want = jmean_ap.eval_map_flexible(
            results, annos, match_thrs=[0.5, 0.7],
            affinity_calculator=dict(type='LidarIOU3D', z_offset=0.5),
            classes=CLASSES,
            report_config=[('mAIE', lambda k: k['breakdown'] == 'All')])
    assert got.keys() == want.keys() and got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
    assert ('NDS' if metric == 'nds' else 'mAIE') in got


# ------------------------------------------------------ loop and CLIs
def loop_config(root):
    """The TINY CenterPoint config of ``tests/test_nuscenes_path.py``
    (two 1-class tasks, velocity on), train under ``CBGSDataset``, one
    worker, at lr 1e-4: at 1e-3 the cyclic schedule's peak (10x) makes the
    third step's gradient norm differ by ~1e-3 between two runs of JAX's
    own loop on the CPU, and the comparison would measure that."""
    return dict(
        model=dict(
            voxel_size=(0.4, 0.4, 4.0), point_cloud_range=tuple(PCR),
            max_voxels_per_sample=1024, voxelize_mode='dynamic',
            head_type='center',
            encoder_cfg=dict(in_channels=5, feat_channels=(16,)),
            backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                              layer_nums=(1, 1, 1), layer_strides=(2, 2, 2)),
            neck_cfg=dict(in_channels=(16, 32, 64),
                          out_channels=(16, 16, 16),
                          upsample_strides=(0.5, 1, 2))),
        head=dict(
            tasks=[dict(num_classes=1), dict(num_classes=1)],
            out_size_factor=4, with_vel=True, code_weights=None,
            max_objs=8,
            test_cfg=dict(max_per_img=16, score_threshold=0.0,
                          nms_type='rotate', nms_thr=0.2, post_max_size=8)),
        data=dict(samples_per_gpu=2, workers_per_gpu=1,
                  train=dict(type='CBGSDataset', dataset=nus_data(
                      root, train_pipeline(seeded=False))),
                  val=nus_data(root, eval_pipeline())),
        optimizer=dict(lr=1e-4),
        max_epochs=1)


def read_log(work_dir):
    with open(os.path.join(work_dir, 'train_log.jsonl')) as f:
        return [json.loads(line) for line in f]


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, '-m', *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope='module')
def runs(tmp_path_factory, nus_root):
    """JAX's ``run_training`` and the port's train CLI, 3 steps each from
    the same initial weights."""
    tmp = tmp_path_factory.mktemp('nus_loop')
    cfg = loop_config(nus_root)
    jd = jdet.CenterPointDetector(model_cfg=dict(cfg['model']),
                                  head_cfg=dict(cfg['head']))
    jwork = str(tmp / 'jax')
    os.makedirs(jwork)
    jloop.run_training(jd, JConfig(copy.deepcopy(cfg)), jwork,
                       max_steps=STEPS, log_interval=1)
    # JAX's initial variables: its loop inits from PRNGKey(0) on its first
    # batch (the values depend on the batch's shapes only)
    _, make_iter = jloop.build_dataloader(JConfig(copy.deepcopy(cfg)),
                                          'train')
    it = make_iter(0)
    first = next(it)
    it.close()
    first.pop('metas', None)
    variables = jax.jit(jd.init)(jax.random.PRNGKey(0), first)
    init = str(tmp / 'jax_init.pt')
    strides = cfg['model']['neck_cfg']['upsample_strides']
    torch.save(dict(state_dict=jax_variables_to_torch(
        jax.tree_util.tree_map(np.asarray, variables), strides)), init)

    cfg_path = tmp / 'tiny_nus.py'
    cfg_path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    twork = tmp / 'port'
    out = _cli(['mmdet3d_gaussian_tpu_torch.tools.train', str(cfg_path),
                '--work-dir', str(twork), '--max-steps', str(STEPS),
                '--log-interval', '1', '--load-from', init,
                '--device', 'cpu'], tmp)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(tmp=tmp, cfg_path=cfg_path, jwork=jwork, twork=twork)


def test_train_cli_log_matches_jax(runs):
    jlog, tlog = read_log(runs['jwork']), read_log(runs['twork'])
    assert [r['step'] for r in tlog] == [r['step'] for r in jlog] == [1, 2, 3]
    for t, j in zip(tlog, jlog):
        assert set(j) <= set(t)
        keys = [k for k in j if k.startswith('task') or k in (
            'loss', 'grad_norm')]
        assert len(keys) == 2 * 2 + 2
        for k in keys:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                       err_msg=f'step {j["step"]} {k}')
    assert tlog[0]['loss'] != tlog[-1]['loss']


@pytest.mark.parametrize('metric,key', [('nds', 'NDS'),
                                        ('iou3d_err', 'mAIE')])
def test_test_cli_metrics(runs, metric, key):
    out = _cli(['mmdet3d_gaussian_tpu_torch.tools.test',
                str(runs['cfg_path']),
                str(runs['twork'] / f'ckpt_{STEPS}.pt'), '--metric', metric,
                '--device', 'cpu'], runs['tmp'])
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'frames 6,' in out.stdout
    report = json.loads(out.stdout[out.stdout.rindex('\n{') + 1:])
    assert key in report
    assert all(np.isfinite(v) for v in report.values())
