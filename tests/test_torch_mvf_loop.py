"""The port's MVF CenterPoint, MVF under ``compute_dtype='bfloat16'``, and
an MVF config through the loop and the CLIs, against the JAX package on
the CPU.

At ``tests/test_torch_mvf.py``'s TINY MVF shapes (a 64 x 48 BEV canvas,
so the center head's 32 x 24 map has H != W, and a 39 x 11 cylindrical
canvas): the MVF CenterPoint predict and one train step (yaw mode with
the GD loss, as the KITTI MVF CenterPoint config); the bf16 compute dtype,
which an MVF trunk ignores in both packages; and ``run_training`` on
``tests/test_torch_loop.py``'s KITTI tree with the MVF encoder, its
loss log held to JAX's (rtol 1e-4), then both CLIs.  Tolerances
as ``tests/test_torch_mvf.py``.
"""
import copy
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

from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.engine import loop as tloop
from mmdet3d_gaussian_tpu_torch.utils.config import Config as TConfig
from mmdet3d_gaussian_tpu_torch.weights import jax_variables_to_torch

from tests.test_torch_loop import config as loop_config
from tests.test_torch_loop import read_log
from tests.test_torch_mvf import (LOSS_RTOL, TINY_MVF, _t, close,
                                  grads_close, jax_step, np_tree, randomize,
                                  tiny_batch)
from tests.test_train_loop import make_kitti_tree

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the KITTI MVF CenterPoint config's head at TINY widths: tasks of 2 and 1
# classes, out_size_factor 2 (the neck's strides 1, 2, 4), yaw mode with
# the BD loss, its code weights and test_cfg
TINY_MVF_CP = dict({k: v for k, v in TINY_MVF.items() if k != 'head_cfg'},
                   head_type='center')
TINY_MVF_CP_HEAD = dict(
    tasks=[dict(num_classes=2), dict(num_classes=1)], out_size_factor=2,
    with_vel=False, yaw_mode=True, max_objs=16,
    loss_gd=dict(type='GDLoss', loss_type='bd3d', fun='log1p', tau=1.0,
                 loss_weight=1.0),
    code_weights=[1.0] * 9,
    # every candidate of both tasks in the output, the suppressed too
    test_cfg=dict(max_per_img=32, score_threshold=0.05, nms_type='rotate',
                  nms_thr=0.2, post_max_size=64))


@pytest.fixture(scope='module')
def cp_variables():
    jd = jdet.CenterPointDetector(model_cfg=TINY_MVF_CP,
                                  head_cfg=TINY_MVF_CP_HEAD)
    return np_tree(jax.jit(jd.init)(jax.random.PRNGKey(0), tiny_batch(3)))


def cp_pair(variables):
    jd = jdet.CenterPointDetector(model_cfg=TINY_MVF_CP,
                                  head_cfg=TINY_MVF_CP_HEAD)
    td = tdet.CenterPointDetector(TINY_MVF_CP, TINY_MVF_CP_HEAD,
                                  device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(
        variables, TINY_MVF_CP['neck_cfg']['upsample_strides']),
        strict=True)
    return jd, td


def test_mvf_centerpoint_predict(cp_variables):
    """Heatmaps on a map of H != W (24 x 32): each class's median logit
    put on the score threshold's, so candidates of every class clear it
    and some do not; boxes, scores, labels and valid (labels of both
    tasks among the kept)."""
    v = copy.deepcopy(randomize(cp_variables, np.random.RandomState(11)))
    batch = tiny_batch(4)
    jd, _ = cp_pair(v)
    assert jd.featmap_size == (24, 32)
    for t, maps in enumerate(jd.apply_eval(v, batch)):
        head = v['params']['bbox_head'][f'task{t}']['heatmap_out']
        logits = np.asarray(maps['heatmap']) - head['bias']
        med = np.median(logits.reshape(-1, logits.shape[-1]), axis=0)
        head['bias'][:] = np.log(0.05 / 0.95) - med
    jd, td = cp_pair(v)
    assert td.featmap_size == (24, 32)
    tb = {k: _t(a) for k, a in batch.items()}
    for w, g in zip(jd.apply_eval(v, batch), td.apply_eval(tb)):
        for k in w:
            close(g[k], np.asarray(w[k]), what=k)
    want = [np.asarray(x) for x in jax.jit(jd.predict)(v, batch)]
    boxes, scores, labels, valid = [x.numpy() for x in td.predict(tb)]
    assert boxes.shape == want[0].shape == (2, 64, 7)
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_array_equal(labels, want[2])
    assert valid.any() and not valid.all()
    assert len(set(labels[valid].tolist())) >= 2
    close(scores, want[1], what='scores')
    close(boxes[valid], want[0][valid], what='boxes')


def test_mvf_centerpoint_step(cp_variables):
    """One step: every loss term (rtol 1e-5), every gradient (the
    encoder's through ``jax_step``'s VJP) and the running statistics."""
    v = dict(params=cp_variables['params'], batch_stats=randomize(
        cp_variables['batch_stats'], np.random.RandomState(12)))
    batch = tiny_batch(5)
    jd, td = cp_pair(v)
    total, losses, grads, state = jax_step(jd, v, batch)
    tb = {k: _t(a) for k, a in batch.items()}
    total_t, losses_t = td.loss(td.apply_train(tb), tb)
    assert set(losses_t) == set(losses) == {
        f'task{t}.{k}' for t in range(2)
        for k in ('loss_heatmap', 'loss_gd', 'loss_l1')}
    for k, x in losses.items():
        assert x > 0, k
        np.testing.assert_allclose(float(losses_t[k]), x, rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(total_t), total, rtol=LOSS_RTOL)
    params = dict(td.trunk.named_parameters())
    got = torch.autograd.grad(total_t, list(params.values()))
    grads_close({k: g.numpy() for k, g in zip(params, got)},
                {k: g.numpy() for k, g in grads.items()})
    mine = td.trunk.state_dict()
    keys = [k for k in state if 'running_' in k]
    assert any(k.startswith('voxel_encoder.views.') for k in keys)
    for k in keys:
        close(mine[k], state[k].numpy(), what=k)


def test_mvf_bf16_computes_f32():
    """``compute_dtype='bfloat16'`` with MVF: JAX's MVF branch builds its
    backbone, neck and head without a dtype, so both packages compute in
    f32; the port's maps are f32, equal to its f32 model's and within
    1e-5 of JAX's (with the same config)."""
    cfg16 = dict(TINY_MVF, compute_dtype='bfloat16')
    jd = jdet.PointPillarsDetector(model_cfg=cfg16)
    batch = tiny_batch(6)
    v = randomize(np_tree(jax.jit(jd.init)(jax.random.PRNGKey(0), batch)),
                  np.random.RandomState(13))
    want = jax.jit(jd.apply_eval)(v, batch)[:3]
    assert all(np.asarray(w).dtype == np.float32 for w in want)
    tb = {k: _t(a) for k, a in batch.items()}
    outs = {}
    for name, cfg in (('bf16', cfg16), ('f32', TINY_MVF)):
        td = tdet.PointPillarsDetector(cfg, device='cpu')
        td.trunk.load_state_dict(jax_variables_to_torch(v), strict=True)
        assert td.trunk.compute_dtype is None
        outs[name] = td.apply_eval(tb)[:3]
    for g, f, w in zip(outs['bf16'], outs['f32'], want):
        assert g.dtype == torch.float32
        assert torch.equal(g, f)
        close(g, np.asarray(w), what='bf16 config map')


# ------------------------------------------------------- loop and CLIs
def mvf_loop_config(root):
    """``tests/test_torch_loop.py``'s TINY config with the MVF encoder
    (its 64 x 64 canvas and a 39 x 11 cylindrical one)."""
    cfg = loop_config(root)
    enc = copy.deepcopy(TINY_MVF['encoder_cfg'])
    enc['point_cloud_range'] = (tuple(cfg['model']['point_cloud_range']),
                                enc['point_cloud_range'][1])
    cfg['model'].update(voxelize_mode='mvf', encoder_cfg=enc)
    return cfg


@pytest.fixture(scope='module')
def loop_runs(tmp_path_factory):
    """JAX's 3-step ``run_training`` and the port's from JAX's initial
    weights (the port's transforms advanced past JAX's init batch, as in
    ``tests/test_torch_loop.py``)."""
    from mmdet3d_gaussian_tpu_torch.datasets.kitti import KittiDataset
    from mmdet3d_gaussian_tpu_torch.registry import PIPELINES
    tmp = tmp_path_factory.mktemp('mvf_loop')
    root = tmp / 'kitti'
    make_kitti_tree(root)
    cfg = mvf_loop_config(root)
    jd = jdet.PointPillarsDetector(model_cfg=dict(cfg['model']),
                                   head_cfg=dict(cfg['head']))
    jwork = str(tmp / 'jax')
    os.makedirs(jwork)
    jloop.run_training(jd, JConfig(copy.deepcopy(cfg)), jwork, max_steps=3,
                       log_interval=1)
    first = jdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                 pc_range=tuple(cfg['model'][
                                     'point_cloud_range']))
    init = str(tmp / 'jax_init.pt')
    torch.save(dict(state_dict=jax_variables_to_torch(
        jax.jit(jd.init)(jax.random.PRNGKey(0), first))), init)
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
    tloop.run_training(td, TConfig(tcfg), twork, max_steps=3,
                       log_interval=1, load_from=init)
    return dict(tmp=tmp, root=root, cfg=cfg, jwork=jwork, twork=twork,
                init=init)


def test_mvf_loop_logs_agree(loop_runs):
    """Each step's loss terms and gradient norm equal JAX's within rtol
    1e-4 (as ``tests/test_torch_loop.py``), and the loss moves."""
    jlog, tlog = read_log(loop_runs['jwork']), read_log(loop_runs['twork'])
    assert [r['step'] for r in tlog] == [r['step'] for r in jlog] == [1, 2, 3]
    for t, j in zip(tlog, jlog):
        for k in ('loss', 'grad_norm', 'loss_cls', 'loss_bbox', 'loss_dir'):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                       err_msg=f'step {j["step"]} {k}')
    assert tlog[0]['loss'] != tlog[1]['loss']


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, '-m', *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_mvf_clis_on_cpu(loop_runs):
    """The train CLI runs 3 steps of the MVF config with ``--device cpu``
    (finite losses) and the test CLI evaluates its checkpoint; without
    ``--device`` both raise (no card here)."""
    cfg = mvf_loop_config(loop_runs['root'])
    cfg['data']['val'] = dict(cfg['data']['train'], pipeline=[
        t for t in cfg['data']['train']['pipeline']
        if t['type'] in ('LoadPointsFromFile', 'PointsRangeFilter',
                         'Pad3D')])
    tmp = loop_runs['tmp']
    cfg_path = tmp / 'tiny_mvf_cfg.py'
    cfg_path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    work = tmp / 'cli'
    train = ['mmdet3d_gaussian_tpu_torch.tools.train', str(cfg_path),
             '--work-dir', str(work), '--max-steps', '3',
             '--log-interval', '1']
    out = _cli(train + ['--device', 'cpu'], tmp)
    assert out.returncode == 0, out.stderr[-3000:]
    log = read_log(work)
    assert [r['step'] for r in log] == [1, 2, 3]
    assert all(np.isfinite(r['loss']) for r in log)
    test = ['mmdet3d_gaussian_tpu_torch.tools.test', str(cfg_path),
            str(work / 'ckpt_3.pt')]
    out = _cli(test + ['--device', 'cpu'], tmp)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'AP11' in out.stdout and 'frames 6,' in out.stdout
    for args in (train, test):
        out = _cli(args, tmp)
        assert out.returncode != 0
        assert 'CUDA is not available' in out.stderr, out.stderr[-2000:]
