"""The port's training loop and CLIs against the JAX package's.

On the TINY config of ``tests/test_train_loop.py`` (a KITTI-format tree of
6 frames, one worker, every random transform seeded, frames within
``Pad3D``), JAX's ``run_training`` and the port's run 3 steps from the same
weights: the port starts from JAX's initial variables through
``load_from``.  JAX's loop draws one batch to initialize before it trains,
so the port's transforms are advanced by the same two samples first.  The
per-step ``loss`` and ``grad_norm`` of the two ``train_log.jsonl`` files
agree within rtol 1e-4 (as the single TINY step of
``tests/test_torch_train.py``), and each tensor of the final parameters
agrees with JAX's restored checkpoint through the converter.  Then the port alone: resume
restores the saved state bitwise and trains on, a ``val/mAP`` record is
logged with ``eval_interval=1``, and both CLIs run as subprocesses with
``--device cpu`` and raise without it (no card here).
"""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import mmdet3d_gaussian_tpu  # noqa: F401  (registers the JAX datasets)
from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.engine import loop as jloop
from mmdet3d_gaussian_tpu.utils.config import Config as JConfig

from mmdet3d_gaussian_tpu_torch.datasets.kitti import KittiDataset
from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.engine import loop as tloop
from mmdet3d_gaussian_tpu_torch.parallel import train_state as tts
from mmdet3d_gaussian_tpu_torch.registry import PIPELINES
from mmdet3d_gaussian_tpu_torch.utils.config import Config as TConfig
from mmdet3d_gaussian_tpu_torch.weights import jax_variables_to_torch

from tests.test_train_loop import make_kitti_tree

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCR = [0, -12.8, -3, 25.6, 12.8, 1]
STEPS = 3


def pipeline():
    return [
        dict(type='LoadPointsFromFile', load_dim=4, use_dim=4),
        dict(type='ObjectNoise', num_try=20, translation_std=[0.5, 0.5, 0],
             rot_range=[-0.3, 0.3], seed=4),
        dict(type='RandomFlip3D', flip_ratio_bev_horizontal=0.5, seed=1),
        dict(type='GlobalRotScaleTrans', rot_range=[-0.3, 0.3],
             scale_ratio_range=[0.95, 1.05], seed=2),
        dict(type='PointsRangeFilter', point_cloud_range=PCR),
        dict(type='ObjectRangeFilter', point_cloud_range=PCR),
        dict(type='PointShuffle', seed=3),
        dict(type='Pad3D', num_points=1024, num_gt=8),
    ]


def config(root, **data):
    """The TINY config of ``tests/test_train_loop.py:51`` with the seeded
    pipeline above and one worker."""
    train = dict(type='KittiDataset', data_root=str(root),
                 ann_file=str(root / 'kitti_infos_train.pkl'),
                 pipeline=pipeline())
    return dict(
        model=dict(
            voxel_size=(0.4, 0.4, 4.0), point_cloud_range=tuple(PCR),
            max_points_per_voxel=8, max_voxels_per_sample=1024,
            encoder_cfg=dict(in_channels=4, feat_channels=(16,)),
            backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                              layer_nums=(1, 1, 1), layer_strides=(2, 2, 2)),
            neck_cfg=dict(in_channels=(16, 32, 64),
                          out_channels=(16, 16, 16),
                          upsample_strides=(1, 2, 4)),
            head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=48)),
        head=dict(test_cfg=dict(nms_pre=64, max_num=16, score_thr=0.05,
                                nms_thr=0.01, use_rotate_nms=True)),
        data=dict(samples_per_gpu=2, workers_per_gpu=1, train=train,
                  **data),
        optimizer=dict(lr=1e-3),
        max_epochs=1)


def read_log(work_dir):
    with open(os.path.join(work_dir, 'train_log.jsonl')) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """JAX's and the port's 3-step runs from the same initial weights."""
    tmp = tmp_path_factory.mktemp('loop')
    root = tmp / 'kitti'
    make_kitti_tree(root)
    cfg = config(root)

    jd = jdet.PointPillarsDetector(model_cfg=dict(cfg['model']),
                                   head_cfg=dict(cfg['head']))
    jwork = str(tmp / 'jax')
    os.makedirs(jwork)
    jstate = jloop.run_training(jd, JConfig(copy.deepcopy(cfg)), jwork,
                                max_steps=STEPS, log_interval=1)
    # JAX's initial variables: its loop inits from PRNGKey(0) on its first
    # batch (the values depend on the batch's shapes only)
    first = jdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                 pc_range=PCR)
    variables = jax.jit(jd.init)(jax.random.PRNGKey(0), first)
    init = str(tmp / 'jax_init.pt')
    torch.save(dict(state_dict=jax_variables_to_torch(variables)), init)

    # the port's transforms, advanced past JAX's init batch (samples
    # order[0] and order[1] of the seed-0 shuffle)
    tcfg = copy.deepcopy(cfg)
    objs = [PIPELINES.build(t) for t in tcfg['data']['train']['pipeline']]
    train = {k: v for k, v in tcfg['data']['train'].items() if k != 'type'}
    ds = KittiDataset(**dict(train, pipeline=objs))
    order = np.random.RandomState(0).permutation(len(ds))
    ds[int(order[0])], ds[int(order[1])]
    tcfg['data']['train']['pipeline'] = objs
    td = tdet.PointPillarsDetector(dict(cfg['model']), dict(cfg['head']),
                                   device='cpu')
    twork = str(tmp / 'port')
    os.makedirs(twork)
    tstate = tloop.run_training(td, TConfig(tcfg), twork, max_steps=STEPS,
                                log_interval=1, load_from=init)
    return dict(tmp=tmp, root=root, cfg=cfg, jwork=jwork, jstate=jstate,
                init=init, twork=twork, tstate=tstate, tdet=td)


def test_logs_agree(runs):
    jlog, tlog = read_log(runs['jwork']), read_log(runs['twork'])
    assert [r['step'] for r in tlog] == [r['step'] for r in jlog] == [1, 2, 3]
    for t, j in zip(tlog, jlog):
        assert set(j) <= set(t)
        for k in ('loss', 'grad_norm', 'loss_cls', 'loss_bbox', 'loss_dir'):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                       err_msg=f'step {j["step"]} {k}')
        assert t['epoch'] == j['epoch'] == 0
    assert tlog[0]['loss'] != tlog[1]['loss']


def test_final_parameters_agree(runs):
    """The port's ``ckpt_3.pt`` against JAX's restored ``ckpt_3`` through
    the converter, tensor by tensor.  Adam divides each gradient by its own
    running scale, so an element whose gradient is small against its
    tensor's still moves by about lr, and the rounding difference of that
    gradient shows in its update.  So: each tensor's update (final minus
    the shared initial value) within 5e-3 of its norm of JAX's update;
    every element within a quarter of the summed learning rate of JAX's;
    elements beyond 1e-4 of their tensor's largest value at most 0.5 % of
    all, and in each tensor at most 2 % or 2 elements, whichever is more,
    so that they cannot cover a small tensor; BN running statistics within
    1e-5."""
    jstate = jloop.restore_checkpoint(
        os.path.join(runs['jwork'], f'ckpt_{STEPS}'), runs['jstate'])
    want = jax_variables_to_torch({
        'params': jax.tree_util.tree_map(np.asarray, jstate.params),
        'batch_stats': jax.tree_util.tree_map(np.asarray,
                                              jstate.batch_stats)})
    init = torch.load(runs['init'], weights_only=True)['state_dict']
    ckpt = torch.load(os.path.join(runs['twork'], f'ckpt_{STEPS}.pt'),
                      weights_only=True)
    got = ckpt['state_dict']
    assert ckpt['step'] == STEPS and ckpt['opt_state']['count'] == STEPS
    assert set(want) <= set(got)
    opt = tts.make_optimizer_from_cfg(TConfig(runs['cfg']), STEPS)
    lr_sum = sum(opt.lr_schedule(t) for t in range(STEPS))
    n_off = n_all = 0
    for k, w in want.items():
        if k.endswith('num_batches_tracked'):   # JAX keeps no counter
            assert int(got[k]) == STEPS
            continue
        diff = (got[k] - w).abs()
        if 'running_' in k:
            assert float(diff.max()) <= 1e-5 * max(float(w.abs().max()), 1)
            continue
        update = w - init[k]
        rel = float((got[k] - init[k] - update).norm() / update.norm())
        off = int((diff > 1e-4 * float(w.abs().max())).sum())
        if off:
            print(f'{k} {tuple(w.shape)}: {off} of {w.numel()} elements '
                  f'beyond 1e-4 of the largest, largest difference '
                  f'{float(diff.max()) / lr_sum:.3g} of the summed lr, '
                  f'update {rel:.3g} off')
        assert rel <= 5e-3, (k, rel)
        assert float(diff.max()) <= 0.25 * lr_sum, (k, float(diff.max()))
        assert off <= max(2, 0.02 * w.numel()), (k, off, w.numel())
        n_off += off
        n_all += w.numel()
    print(f'{n_off} of {n_all} parameters beyond 1e-4 of their tensor\'s '
          f'largest value')
    assert n_off <= 5e-3 * n_all
    with open(os.path.join(runs['twork'], f'meta_{STEPS}.json')) as f:
        meta = json.load(f)
    assert meta['step'] == STEPS and meta['classes'] == [
        'Pedestrian', 'Cyclist', 'Car']


def test_resume_restores_bitwise(runs):
    cfg = config(runs['root'])
    cfg['max_epochs'] = 3
    ckpt_path = os.path.join(runs['twork'], f'ckpt_{STEPS}.pt')
    saved = torch.load(ckpt_path, weights_only=True)
    det = tdet.PointPillarsDetector(dict(cfg['model']), dict(cfg['head']),
                                    device='cpu', seed=5)
    state = det.init_train(optimizer=tts.make_optimizer_from_cfg(
        TConfig(cfg), 10))
    state = tloop.restore_checkpoint(ckpt_path, det, state)
    assert state.step == STEPS and state.opt_state.count == STEPS
    for k, v in det.trunk.state_dict().items():
        assert torch.equal(v, saved['state_dict'][k]), k
    for which in ('mu', 'nu'):
        moments = getattr(state.opt_state, which)
        assert set(moments) == set(saved['opt_state'][which])
        for k, v in moments.items():
            assert torch.equal(v, saved['opt_state'][which][k]), k
    work = str(runs['tmp'] / 'resumed')
    os.makedirs(work)
    state = tloop.run_training(det, TConfig(cfg), work, max_steps=STEPS + 2,
                               log_interval=1, resume_from=ckpt_path)
    assert [r['step'] for r in read_log(work)] == [STEPS + 1, STEPS + 2]
    assert state.step == STEPS + 2 and state.opt_state.count == STEPS + 2
    assert os.path.exists(os.path.join(work, f'ckpt_{STEPS + 2}.pt'))


def test_eval_interval_logs_map(runs):
    cfg = config(runs['root'])
    cfg['data']['val'] = dict(cfg['data']['train'],
                              pipeline=pipeline()[:1] + pipeline()[4:5]
                              + pipeline()[-1:])
    det = tdet.PointPillarsDetector(dict(cfg['model']), dict(cfg['head']),
                                    device='cpu')
    work = str(runs['tmp'] / 'with_eval')
    os.makedirs(work)
    tloop.run_training(det, TConfig(cfg), work, max_steps=2, log_interval=1,
                       eval_interval=1)
    val = [r for r in read_log(work) if 'val/mAP' in r]
    assert len(val) == 1 and np.isfinite(val[0]['val/mAP'])
    assert val[0]['step'] == 2


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, '-m', *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_clis_on_cpu(runs):
    cfg = config(runs['root'])
    cfg['data']['val'] = dict(cfg['data']['train'],
                              pipeline=pipeline()[:1] + pipeline()[4:5]
                              + pipeline()[-1:])
    tmp = runs['tmp']
    cfg_path = tmp / 'tiny_cfg.py'
    cfg_path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    work = tmp / 'cli'
    train = ['mmdet3d_gaussian_tpu_torch.tools.train', str(cfg_path),
             '--work-dir', str(work), '--max-steps', '2',
             '--log-interval', '1']
    out = _cli(train + ['--device', 'cpu'], tmp)
    assert out.returncode == 0, out.stderr[-3000:]
    assert [r['step'] for r in read_log(work)] == [1, 2]
    test = ['mmdet3d_gaussian_tpu_torch.tools.test', str(cfg_path),
            str(work / 'ckpt_2.pt')]
    out = _cli(test + ['--device', 'cpu'], tmp)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'AP11' in out.stdout and 'frames 6,' in out.stdout
    out = _cli(test + ['--device', 'cpu', '--metric', 'cowa'], tmp)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"mAP"' in out.stdout
    # no card here: without --device both CLIs raise
    for args in (train, test):
        out = _cli(args, tmp)
        assert out.returncode != 0
        assert 'CUDA is not available' in out.stderr, out.stderr[-2000:]


def test_unported_paths_raise(tmp_path, monkeypatch):
    """``--show-dir`` names what is missing instead of running; the train
    CLI in a job of several processes refuses to run without
    ``--distributed`` (it would train independent copies).  PV-RCNN and
    the MVX detector, whose data-parallel step is now ported, take a group
    of more than one rank into their capacities (``mesh.sync_batchnorms``)
    instead of raising.  (``--distributed`` itself runs:
    ``tests/test_torch_dist.py``; every family's step under 2 ranks:
    ``tests/test_torch_dist_families.py`` and its siblings.)"""
    from mmdet3d_gaussian_tpu_torch.engine.mvx import MVXDetector
    from mmdet3d_gaussian_tpu_torch.engine.pvrcnn import PVRCNNDetector
    from mmdet3d_gaussian_tpu_torch.parallel.mesh import (Group,
                                                          sync_batchnorms)
    from mmdet3d_gaussian_tpu_torch.tools import test, train
    from tests.test_mvx_fusion import TINY_MVX, TINY_MVX_HEAD
    from tests.test_pvrcnn import TINY_PVRCNN, TINY_RPN
    cfg_path = tmp_path / 'cfg.py'
    cfg_path.write_text('model = dict()\n')
    with pytest.raises(NotImplementedError, match='item 8'):
        test.main([str(cfg_path), '--show-dir', str(tmp_path),
                   '--device', 'cpu'])
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(RuntimeError, match='--distributed'):
        train.main([str(cfg_path), '--device', 'cpu'])
    two = Group(rank=1, world=2, device=torch.device('cpu'))
    pv = PVRCNNDetector(TINY_PVRCNN, TINY_RPN, device='cpu')
    sync_batchnorms(pv.trunk, two)
    assert pv.trunk.first.middle_encoder.group is two
    mvx = MVXDetector(TINY_MVX, TINY_MVX_HEAD, device='cpu')
    sync_batchnorms(mvx.trunk, two)
    assert mvx.trunk.group is two


def _eval_boxes(maps, decode):
    """NHWC eval maps -> (the box map (B, H, W, A * 7), every anchor's
    decoded box (B, A, 7)), numpy."""
    bbox = np.asarray(maps[1], np.float32)
    return bbox, decode(bbox.reshape(bbox.shape[0], -1, 7))


def test_eval_after_steps_matches_jax(runs):
    """The eval-mode predict after the 3 steps: the box map, the decoded
    box of every anchor and the predict's boxes, from JAX's trained
    weights in both packages and from each package's own training, on a
    batch as trained; and from JAX's weights on the same batch with its
    intensities 1e4 times larger, which makes the eval maps overflow
    (BatchNorm's running statistics, a few steps from their initial
    values, no longer hold the activations down).  The count of non-finite
    elements must be equal, the box maps agree within 1e-5 of their scale
    (1e-3 from each package's own weights, as far as the final parameters
    agree) and so do the finite boxes of the batch as trained.  On the
    overflowing batch the boxes are held through their map and their
    non-finite elements only: a size there is the exp of a map value near
    88, and x and y cancel a large offset against the anchor, so the map's
    f32 rounding shows in them at any scale.  Whether the eval predict's
    sizes overflow after a few steps is then a property of the model and
    its weights, not of the port."""
    cfg = runs['cfg']
    jd = jdet.PointPillarsDetector(model_cfg=dict(cfg['model']),
                                   head_cfg=dict(cfg['head']))
    jstate = runs['jstate']
    variables = {'params': jstate.params, 'batch_stats': jstate.batch_stats}
    anchors = np.asarray(jd.anchors, np.float32).reshape(-1, 7)
    tdet_same = tdet.PointPillarsDetector(dict(cfg['model']),
                                          dict(cfg['head']), device='cpu')
    tdet_same.trunk.load_state_dict(jax_variables_to_torch({
        'params': jax.tree_util.tree_map(np.asarray, jstate.params),
        'batch_stats': jax.tree_util.tree_map(np.asarray,
                                              jstate.batch_stats)}),
        strict=True)

    def jax_decode(deltas):
        return np.stack([np.asarray(jd.head.coder.decode(
            jax.numpy.asarray(anchors), jax.numpy.asarray(d)))
            for d in deltas])

    def port_decode(deltas):
        return tdet_same.head.coder.decode(
            torch.from_numpy(anchors), torch.from_numpy(deltas)).numpy()

    jpredict = jax.jit(jd.predict)
    overflowed = 0
    for intensity, det, atol in ((1.0, tdet_same, 1e-5),
                                 (1.0, runs['tdet'], 1e-3),
                                 (1e4, tdet_same, 1e-5)):
        batch = jdet.synthetic_batch(batch_size=2, num_points=1024,
                                     num_gt=8, pc_range=PCR, seed=7)
        batch['points'] = np.asarray(batch['points']).copy()
        batch['points'][..., 3] *= intensity
        tbatch = {k: torch.from_numpy(np.asarray(v))
                  for k, v in batch.items()}
        want_map, want = _eval_boxes(jd.apply_eval(variables, batch),
                                     jax_decode)
        want_pred = np.asarray(jpredict(variables, batch)[0])
        got_map, got = _eval_boxes(det.apply_eval(tbatch), port_decode)
        got_pred = det.predict(tbatch)[0].numpy()
        overflowed += int((~np.isfinite(want)).sum())
        np.testing.assert_allclose(got_map, want_map, rtol=0, atol=max(
            atol, 1e-5) * float(np.abs(want_map).max()), err_msg='box map')
        for what, g, w in (('anchor boxes', got, want),
                           ('predict boxes', got_pred, want_pred)):
            fin = np.isfinite(w)
            print(f'intensity x{intensity:g}, {what}: {int((~fin).sum())} '
                  f'of {w.size} elements not finite in JAX, '
                  f'{int((~np.isfinite(g)).sum())} in the port')
            np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=what)
            if intensity == 1.0 and fin.any():
                np.testing.assert_allclose(
                    g[fin], w[fin], rtol=0,
                    atol=atol * float(np.abs(w[fin]).max()), err_msg=what)
    assert overflowed, 'the scaled batch no longer overflows in JAX'
