"""Data-parallel training of the port on 2 gloo ranks on the CPU.

One group of 2 ranks (``tests/torch_dist_worker.py``: spawned processes,
a ``file://`` store, 60 s a collective, killed and failed past 90 s) runs
every check in turn and saves what it got; the tests compare:

* BatchNorm under the group (K4's plain version in ``bn_train`` on a
  channels-last NCHW batch and on an unevenly split matrix,
  ``BatchNorm2d`` in f32, bf16 and bf16 promoted, ``MaskedBatchNorm``
  with a slot mask whose live slots sit nearly all on rank 0 and without
  one) against one process on the concatenated rows: the outputs,
  statistics and ``dx`` (concatenated) and ``dscale`` / ``dbias`` summed
  over the ranks, within 1e-6 of each tensor's largest value (the same
  sums in another order), bf16 tensors within one bf16 rounding of their
  own size too (an f32 difference of that order can round to the other
  neighbour).
* The TINY hard PointPillars train step on global B = 4 (2 + 2), in f32
  and bf16, with sparse and dense targets (the dense ones through K3's
  plain version), 2 steps: (a) against the port's one-process step on the
  4 samples at 1e-5 of each leaf's largest value (loss terms relative);
  (b) in f32, against JAX's ``make_train_step`` jitted with the batch on
  ``Mesh(jax.devices()[:2], ('data',))`` sharded ``P('data')`` at 1e-4, as
  the other TINY steps: the loss terms, every gradient leaf of both
  steps, the running statistics after each step and the parameters after
  2 steps; and both ranks end with bitwise equal parameters and buffers.
  Parameters (:func:`_params_close`): Adam divides each gradient by its
  own running scale, so a relative difference r of an element's two
  gradients (large where a gradient is at the f32 rounding of its sum, or
  in bf16) may move its update by 2 r times the learning rate, at most
  the learning rate, on top of the tolerance.  bf16 (a): each
  one-process step starts from the 2-rank run's state before it and
  replays its forward BatchNorm statistics (``tests/test_torch_bf16.py``'s
  practice: otherwise their other f32 sum order goes through every later
  bf16 rounding, and a bf16 gradient's rounding, through Adam, moves many
  elements of the next step's parameters by the learning rate); each
  rank's bf16 weight gradients are rounded to bf16 before the f32 sum, so
  the gradients are held to one bf16 step (the largest relative spacing,
  2^-7) of the leaf's largest value and their norm to one bf16 step.
* The train CLI with ``--distributed --device cpu`` on the TINY
  KITTI-format tree of ``tests/test_torch_loop.py`` (8 frames, global
  batch 4, a pipeline without random transforms: each rank's transforms
  draw their own random stream), 2 steps: rank 0 alone writes the log and
  the checkpoint, equal to a one-process run: the logged losses at 1e-5;
  AdamW's first moment and the running statistics, which hold the second
  step's gradient and statistics, at 1e-4; the parameters at 1e-5 but for
  at most 1 % of them, within the summed learning rate.  The same CLI
  under the same 2 ranks trains a TINY CenterPoint config over a
  nuScenes-format tree (``CBGSDataset``, ``tests/test_torch_nuscenes.py``'s
  loop config) and a TINY PV-RCNN config over the KITTI tree
  (``tests/test_torch_pvrcnn_loop.py``'s), each held to its one-process
  run the same way.  (Data parallel for these families and for MVF and
  MVX, at capacities that overflow: ``tests/test_torch_dist_families.py``,
  ``tests/test_torch_dist_mvf.py`` and ``tests/test_torch_dist_pvrcnn.py``.)
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.parallel import train_state as jts

from mmdet3d_gaussian_tpu_torch.parallel import train_state as tts
from mmdet3d_gaussian_tpu_torch.tools.common import load_config
from mmdet3d_gaussian_tpu_torch.tools import train as ttrain
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

from . import torch_dist_worker as worker
from .test_nuscenes_path import make_nus_tree
from .test_torch_nuscenes import loop_config as nus_loop_config
from .test_torch_pvrcnn_loop import pvrcnn_config
from .test_torch_train import TINY_HEAD, TINY_MODEL, _np_tree, randomize
from .test_train_loop import make_kitti_tree

torch.set_num_threads(2)

HARD = dict(TINY_MODEL, voxelize_mode='hard')
PCR = TINY_MODEL['point_cloud_range']
SPARSE = dict(TINY_HEAD, pos_cap=1024)
DENSE = dict(TINY_HEAD, pos_cap=0)
LR, TOTAL = 1e-3, 10
CASES = {'f32_sparse': (HARD, SPARSE), 'f32_dense': (HARD, DENSE),
         'bf16_sparse': (dict(HARD, compute_dtype='bfloat16'), SPARSE),
         'bf16_dense': (dict(HARD, compute_dtype='bfloat16'), DENSE)}
TOL_ONE = 1e-5      # against one process: the same sums in another order
TOL_JAX = 1e-4      # against JAX, as tests/test_torch_hard.py's steps
CLI_STEPS = 2
CLI_FAMILY_LR = 1e-7


def _pipeline():
    return [dict(type='LoadPointsFromFile', load_dim=4, use_dim=4),
            dict(type='PointsRangeFilter', point_cloud_range=list(PCR)),
            dict(type='ObjectRangeFilter', point_cloud_range=list(PCR)),
            dict(type='Pad3D', num_points=1024, num_gt=8)]


def _write_config(path, cfg):
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    return str(path)


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    """The weights and global batch, the 2-rank run of every check, and
    JAX's initial variables."""
    tmp = tmp_path_factory.mktemp('dist')
    jd = jdet.PointPillarsDetector(model_cfg=HARD, head_cfg=SPARSE)
    jbatch = jdet.synthetic_batch(batch_size=4, num_points=1024, num_gt=8,
                                  pc_range=PCR)
    variables = randomize(_np_tree(jax.jit(jd.init)(jax.random.PRNGKey(0),
                                                    jbatch)),
                          np.random.RandomState(0))
    torch.save(jax_variables_to_torch(variables), tmp / 'weights.pt')
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    torch.save(batch, tmp / 'batch.pt')
    steps = {name: dict(model=model, head=head, weights=str(tmp /
                                                            'weights.pt'),
                        batch=str(tmp / 'batch.pt'), lr=LR,
                        total_steps=TOTAL)
             for name, (model, head) in CASES.items()}

    root = tmp / 'kitti'
    make_kitti_tree(root, num_frames=8)
    train = dict(type='KittiDataset', data_root=str(root),
                 ann_file=str(root / 'kitti_infos_train.pkl'),
                 pipeline=_pipeline())
    cfg = dict(model=dict(HARD, max_points_per_voxel=8),
               head=dict(test_cfg=TINY_HEAD['test_cfg']),
               data=dict(samples_per_gpu=4, workers_per_gpu=1, train=train),
               optimizer=dict(lr=1e-3), max_epochs=1)
    # CenterPoint over a nuScenes-format tree (CBGS) and PV-RCNN over the
    # KITTI tree, pipelines without random transforms, a global batch of
    # 4, at lr 1e-7: AdamW moves a weight by about lr whatever the size of
    # its gradient, so a gradient at the f32 rounding of its sum moves
    # that weight by up to lr on one side only.  At these configs' lr
    # (1e-4, 1e-3), and still at 1e-5, that moves an activation of the
    # second step across a ReLU's kink: the CenterPoint run's second
    # gradient norm differs by 4.8e-4 at 1e-5 (its losses by 8.6e-6).
    # The tree of seed 0 gives, at lr 1e-7 too, a dynamic-encoder
    # BatchNorm weight's first moment 1.4e-4 of its leaf's largest apart
    # on 2 ranks and on one (its f32 sums in another order); the tree of
    # seed 1 stays within the tolerances
    cp = nus_loop_config(make_nus_tree(tmp / 'nus', num_frames=4, seed=1))
    cp['data'] = dict(cp['data'], samples_per_gpu=4)
    cp['data'].pop('val')
    pv = pvrcnn_config(root)
    pv['data'] = dict(pv['data'], samples_per_gpu=4,
                      train=dict(train, pipeline=_pipeline()))
    pv['data'].pop('val')
    for c in (cp, pv):
        c['optimizer'] = dict(lr=CLI_FAMILY_LR)
    configs = dict(pointpillars=_write_config(tmp / 'cfg.py', cfg),
                   centerpoint=_write_config(tmp / 'cp.py', cp),
                   pvrcnn=_write_config(tmp / 'pv.py', pv))
    cli = dict(configs=configs,
               work_dirs={k: str(tmp / f'dist_work_{k}') for k in configs},
               steps=CLI_STEPS)
    runs = [(configs[k], cli['work_dirs'][k]) for k in configs]
    ranks = worker.spawn(dict(steps=steps, cli=dict(runs=runs,
                                                    steps=CLI_STEPS)),
                         str(tmp))
    return dict(tmp=tmp, ranks=ranks, steps=steps, cli=cli,
                variables=variables, jbatch=jbatch)


def _close(got, want, tol, what):
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape, what
    scale = max(float(want.abs().max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=tol * scale, err_msg=what)


# ---------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize('name', [
    'bn_train_nchw', 'bn_train_mat', 'bn2d_f32', 'bn2d_bf16',
    'bn2d_bf16_promote', 'masked_pfn', 'masked_pts'])
def test_batchnorm_under_two_ranks(job, name):
    want = worker.bn_checks(worker.bn_inputs(), None)[name]
    got = [r['bn'][name] for r in job['ranks']]
    for key, w in want.items():
        if key in ('dscale', 'dbias'):
            g = got[0][key] + got[1][key]
        elif key in ('y', 'dx'):
            g = torch.cat([r[key] for r in got])
        else:       # statistics: the same on both ranks
            torch.testing.assert_close(got[0][key], got[1][key], rtol=0,
                                       atol=0)
            g = got[0][key]
        assert g.dtype == w.dtype, (key, g.dtype, w.dtype)
        tol = 1e-6 * max(float(w.float().abs().max()), 1e-30)
        if w.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -8 * w.float().abs().numpy()
        np.testing.assert_array_less(
            np.abs(g.float().numpy() - w.float().numpy()), tol + 1e-30,
            err_msg=f'{name} {key}')
    if name == 'masked_pfn':
        assert float(worker.bn_inputs()['pfn_mask'][10:].sum()) == 2


# ------------------------------------------------------------- train steps
LR_SUM = sum(tts.make_optimizer(LR, TOTAL).lr_schedule(t) for t in range(2))
BF16_STEP = 2.0 ** -7       # the largest relative spacing of bf16 values
# most elements of f32 parameters the rule of _params_close may loosen
LOOSE_SHARE = 1e-2


def _params_close(got, want, grads_got, grads_want, tol):
    """Parameters after the steps: Adam's update of an element is its
    moments' ratio, of degree 0 in its gradients, so a relative difference
    r of an element's gradient (the largest over the steps) moves its
    update by up to about 2 r times the learning rate: each element within
    ``tol`` of its leaf's largest value plus ``min(1, 2 r)`` times the
    summed learning rate.  -> the share of elements with r > 1e-3 (at the
    f32 rounding of their sums, or bf16 gradients)."""
    n_loose = n_all = 0
    for k, w in want.items():
        rel = torch.zeros_like(w)
        for gg, gw in zip(grads_got, grads_want):
            rel = torch.maximum(rel, (gg[k] - gw[k]).abs()
                                / gw[k].abs().clamp(min=1e-30))
        diff = (got[k] - w).abs()
        bound = tol * float(w.abs().max()) + LR_SUM * (2 * rel).clamp(max=1)
        bad = diff > bound
        assert not bad.any(), (k, float(diff[bad].max()), int(bad.sum()))
        n_loose += int((rel > 1e-3).sum())
        n_all += w.numel()
    return n_loose / n_all


@pytest.fixture(scope='module')
def one_process(job):
    """The one-process steps on the 4 samples.  bf16: each step from the
    2-rank run's state before it, with its forward BatchNorm
    statistics."""
    rank0 = job['ranks'][0]['steps']
    out = {}
    for name, case in job['steps'].items():
        if not name.startswith('bf16'):
            out[name] = worker.step_run(case)
            continue
        dp = rank0[name]
        first = worker.step_run(case, steps=1, replay=dp['sums'][:1])
        second = worker.step_run(case, steps=1, replay=dp['sums'][1:],
                                 start=dp['states'][0])
        out[name] = {k: first[k] + second[k] for k in
                     ('metrics', 'grads', 'stats')}
        out[name]['params'] = second['params']
    return out


@pytest.mark.parametrize('case', list(CASES))
def test_step_matches_one_process(job, one_process, case):
    want = one_process[case]
    bf16 = case.startswith('bf16')
    for rank in job['ranks']:
        got = rank['steps'][case]
        for s in range(2):
            w, g = want['metrics'][s], got['metrics'][s]
            assert set(g) == set(w)
            for k in w:
                # bf16: the norm of the gradients to one bf16 step
                rtol = BF16_STEP if bf16 and k == 'grad_norm' else TOL_ONE
                np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                           err_msg=f'step {s} {k}')
            for k, v in want['stats'][s].items():
                _close(got['stats'][s][k], v, TOL_ONE, f'step {s} {k}')
            for k, v in want['grads'][s].items():
                diff = (got['grads'][s][k] - v).abs()
                bound = (BF16_STEP if bf16 else TOL_ONE) * float(
                    v.abs().max())
                assert bool((diff <= bound).all()), (s, k, float(diff.max()))
        loose = _params_close(got['params'], want['params'], got['grads'],
                              want['grads'], TOL_ONE)
        if not bf16:
            assert loose < LOOSE_SHARE, loose
    assert want['metrics'][0]['loss_bbox'] > 0


@pytest.mark.parametrize('case', list(CASES))
def test_ranks_end_bitwise_equal(job, case):
    a, b = (r['steps'][case] for r in job['ranks'])
    for k in a['params']:
        assert torch.equal(a['params'][k], b['params'][k]), k
    for k in a['stats'][-1]:
        assert torch.equal(a['stats'][-1][k], b['stats'][-1][k]), k
    assert a['metrics'] == b['metrics']


def _capture():
    """An optax link that passes the gradients on and keeps them as its
    state, so the jitted step returns them."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def jax_sharded_steps(model, head, variables, jbatch, steps=2):
    """JAX's make_train_step jitted on a 2-device mesh, the batch sharded
    ``P('data')`` and the state replicated."""
    jd = jdet.PointPillarsDetector(model_cfg=model, head_cfg=head)
    opt = optax.chain(_capture(), jts.make_optimizer(LR, TOTAL))
    step = jax.jit(jts.make_train_step(
        lambda vs, b, train: jd.apply_train(vs, b), jd.loss, opt))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ('data',))
    state = jax.device_put(
        jts.init_state(variables['params'], variables['batch_stats'], opt),
        NamedSharding(mesh, P()))
    batch = jax.device_put(jbatch, NamedSharding(mesh, P('data')))
    out = dict(metrics=[], grads=[], stats=[])
    for _ in range(steps):
        state, metrics = step(state, batch)
        out['metrics'].append({k: float(v) for k, v in metrics.items()})
        out['grads'].append(jax_grads_to_torch(_np_tree(state.opt_state[0])))
        out['stats'].append({k: v for k, v in jax_variables_to_torch(
            {'params': _np_tree(state.params),
             'batch_stats': _np_tree(state.batch_stats)}).items()
            if 'running_' in k})
    out['params'] = jax_variables_to_torch(
        {'params': _np_tree(state.params),
         'batch_stats': _np_tree(state.batch_stats)})
    return out


@pytest.mark.parametrize('case', ['f32_sparse', 'f32_dense'])
def test_step_matches_jax_sharded(job, case):
    model, head = CASES[case]
    want = jax_sharded_steps(model, head, job['variables'], job['jbatch'])
    got = job['ranks'][0]['steps'][case]
    for s in range(2):
        for k, v in want['metrics'][s].items():
            np.testing.assert_allclose(got['metrics'][s][k], v,
                                       rtol=TOL_JAX, err_msg=f'step {s} {k}')
        assert set(got['grads'][s]) == set(want['grads'][s])
        for k, v in want['grads'][s].items():
            _close(got['grads'][s][k], v, TOL_JAX, f'step {s} grad {k}')
        for k, v in want['stats'][s].items():
            _close(got['stats'][s][k], v, TOL_JAX, f'step {s} {k}')
    params = {k: v for k, v in want['params'].items()
              if k in got['params']}
    assert _params_close(got['params'], params, got['grads'], want['grads'],
                         TOL_JAX) < LOOSE_SHARE


# ------------------------------------------------------------------ the CLI
def _cli_matches_one_process(job, family, tmp_path):
    """Rank 0 alone wrote ``train_log.jsonl`` and the checkpoint; both
    equal a one-process run on the same global batches."""
    cli = job['cli']
    work = cli['work_dirs'][family]
    assert sorted(os.listdir(work)) == ['ckpt_2.pt', 'meta_2.json',
                                        'train_log.jsonl']
    one = str(tmp_path / 'one')
    ttrain.main([cli['configs'][family], '--device', 'cpu', '--work-dir',
                 one, '--max-steps', str(CLI_STEPS), '--log-interval',
                 '1'])

    def log(d):
        with open(os.path.join(d, 'train_log.jsonl')) as f:
            return [json.loads(line) for line in f]
    got, want = log(work), log(one)
    assert [r['step'] for r in got] == [r['step'] for r in want] == [1, 2]
    for g, w in zip(got, want):
        keys = [k for k in w if k == 'grad_norm' or 'loss' in k]
        assert 'loss' in keys and set(keys) <= set(g)
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL_ONE, err_msg=k)
    a = torch.load(os.path.join(work, 'ckpt_2.pt'), weights_only=True)
    b = torch.load(os.path.join(one, 'ckpt_2.pt'), weights_only=True)
    assert a['step'] == b['step'] == 2
    # AdamW's first moment and the running statistics hold the second
    # step's gradient and batch statistics, which inherit the first
    # update's loosened elements (_params_close): 1e-4
    for k, v in b['opt_state']['mu'].items():
        _close(a['opt_state']['mu'][k], v, 10 * TOL_ONE, f'mu {k}')
    for k, v in b['state_dict'].items():
        if k not in b['opt_state']['mu']:       # the buffers
            _close(a['state_dict'][k], v, 10 * TOL_ONE, k)
    # the parameters: the log holds no gradients, so each element within
    # 1e-5 of its tensor's largest value or, at most LOOSE_SHARE of them,
    # within the summed learning rate (_params_close's loosened elements)
    lr_sum = sum(tts.make_optimizer_from_cfg(
        load_config(cli['configs'][family]), CLI_STEPS).lr_schedule(t)
        for t in range(CLI_STEPS)) if family != 'pointpillars' else LR_SUM
    n_loose = n_all = 0
    for k in b['opt_state']['mu']:
        w = b['state_dict'][k]
        diff = (a['state_dict'][k] - w).abs()
        assert float(diff.max()) <= lr_sum, k
        n_loose += int((diff > TOL_ONE * float(w.abs().max())).sum())
        n_all += w.numel()
    assert n_loose < LOOSE_SHARE * n_all, (n_loose, n_all)


def test_train_cli_distributed(job, tmp_path):
    _cli_matches_one_process(job, 'pointpillars', tmp_path)


@pytest.mark.parametrize('family', ['centerpoint', 'pvrcnn'])
def test_train_cli_distributed_families(job, family, tmp_path):
    """CenterPoint (nuScenes, ``CBGSDataset``) and PV-RCNN (KITTI) through
    the train CLI under the same 2 ranks."""
    assert all(r['cli']['world'] == 2 for r in job['ranks'])
    _cli_matches_one_process(job, family, tmp_path)
