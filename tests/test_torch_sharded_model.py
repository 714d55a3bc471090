"""The point-sharded detector against the JAX package's, in one process and
on a 2 x 2 grid of gloo ranks on the CPU.

* ``point_axis=None`` (one process): the TINY detector of
  ``tests/test_sharded_model.py`` with JAX's weights against JAX's
  ``point_axis=None`` program: the head maps in training and eval mode,
  the loss terms and every gradient leaf (sparse and dense targets) at
  1e-4 of the leaf's largest, the predict's keep masks and labels equal.
* One job of 4 ranks (``tests/torch_dist_worker.py``'s ``sharded_run``)
  on a 2 x 2 (data, points) grid, each rank on its samples and point
  slice (``mesh.shard_points``) of a global batch of 4 x 1,024 points, 2
  dense-target steps with ``merge='dense'``, ``'sparse'`` (the default
  capacity, which keeps every cell) and ``'sparse'`` at a capacity that
  overflows: (a) against the port's one process on the whole batch, step
  by step from the same state, at 1e-5 (the one process replays the
  grid's forward BatchNorm sums for its gradients,
  ``tests/torch_dist_families.py::one_process``; the overflowing capacity
  drops cells, so not that one); (b) against JAX's step jitted with the
  batch on ``Mesh(jax.devices()[:4].reshape(2, 2), ('data', 'points'))``
  at the port's state before each step, at 1e-4 (dense, and sparse at the
  overflowing capacity); (c) the ranks end bitwise equal; (d) the predict
  of each rank is its data rank's samples, equal over its points group
  and to one process; (e) a dense merge whose backward sums over the
  points group gives the encoder P = 2 times its gradient (the
  regression that (a) catches); (f) ``train_state.reduce_gradients``
  gives the trunk's gradients bitwise equal to an all-reduce over the data
  group, and the encoder's their sum over the world.
* The weight converter carries the encoder's leaves and raises on an
  unknown one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import flax.linen as fnn

from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.parallel.mesh import use_mesh

from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

from . import torch_dist_families as fam
from . import torch_dist_worker as worker
from .test_sharded_model import TINY, TINY_HEAD
from .test_torch_train import _np_tree, randomize

torch.set_num_threads(2)

B, N, G = 4, 1024, 4
GRID = (2, 2)
DENSE_HEAD = dict(TINY_HEAD, pos_cap=0)
# live cells a (rank, sample, stripe): ~240 of 2,048; the default capacity
# (512) keeps all, 64 drops some
OVERFLOW_CAP = 64
CASES = dict(dense=dict(merge='dense'), sparse=dict(merge='sparse'),
             sparse_overflow=dict(merge='sparse', capacity=OVERFLOW_CAP))
TOL_JAX = 1e-4


def global_batch():
    return tdet.synthetic_batch(B, N, G, pc_range=TINY['point_cloud_range'],
                                device='cpu')


def jax_batch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@pytest.fixture(scope='module')
def variables():
    """JAX's initial variables, BN statistics, scales and biases
    redrawn."""
    jd = jdet.ShardedPointPillarsDetector(TINY, TINY_HEAD, point_axis=None)
    v = jax.jit(jd.init)(jax.random.PRNGKey(0), jax_batch(global_batch()))
    return randomize(_np_tree(v), np.random.RandomState(0))


def close(got, want, tol, what):
    fam.close(torch.as_tensor(np.asarray(got)),
              torch.as_tensor(np.asarray(want)), tol, what)


# ----------------------------------------------------------- one process
@pytest.mark.parametrize('pos_cap', [1024, 0])
def test_one_process_matches_jax(variables, pos_cap):
    head = dict(TINY_HEAD, pos_cap=pos_cap)
    jd = jdet.ShardedPointPillarsDetector(TINY, head, point_axis=None)
    td = tdet.ShardedPointPillarsDetector(TINY, head, point_axis=None,
                                          device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(variables), strict=True)
    batch = global_batch()
    jb = jax_batch(batch)

    def f(params):
        outs, _ = jd.apply_train({'params': params,
                                  'batch_stats': variables['batch_stats']},
                                 jb)
        total, losses = jd.loss(outs, jb)
        return total, (losses, outs)
    (_, (losses, outs)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(variables['params'])
    eval_maps = jax.jit(jd.apply_eval)(variables, jb)
    dets = [np.asarray(x) for x in jax.jit(jd.predict)(variables, jb)]

    with torch.inference_mode():                    # before the running
        got_eval = td.apply_eval(batch)             # statistics move
        got_dets = [x.numpy() for x in td.predict(batch)]
    got_outs = td.apply_train(batch)
    total, got_losses = td.loss(got_outs, batch)
    names, leaves = zip(*td.trunk.named_parameters())
    got_grads = dict(zip(names, torch.autograd.grad(total, leaves)))

    for i in range(3):
        close(got_outs[i].detach(), outs[i], TOL_JAX, f'train map {i}')
        close(got_eval[i], eval_maps[i], TOL_JAX, f'eval map {i}')
    assert set(got_losses) == set(losses)
    for k, w in losses.items():
        np.testing.assert_allclose(float(got_losses[k]), float(w),
                                   rtol=TOL_JAX, err_msg=k)
    want = jax_grads_to_torch(_np_tree(grads))
    assert set(want) == set(got_grads)
    for k, w in want.items():
        fam.close(got_grads[k], w, TOL_JAX, f'grad {k}')
    keep = got_dets[3]
    assert keep.sum() >= 10
    np.testing.assert_array_equal(keep, dets[3])
    np.testing.assert_array_equal(got_dets[2][keep], dets[2][keep])
    np.testing.assert_allclose(got_dets[1][keep], dets[1][keep], atol=1e-5)
    close(got_dets[0][keep], dets[0][keep], TOL_JAX, 'boxes')


# ------------------------------------------------------------- the grid
@pytest.fixture(scope='module')
def job(variables, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('sharded_model')
    torch.save(jax_variables_to_torch(variables), tmp / 'weights.pt')
    torch.save(global_batch(), tmp / 'batch.pt')
    cases = {name: dict(family='sharded', model=TINY, head=DENSE_HEAD,
                        weights=str(tmp / 'weights.pt'),
                        batch=str(tmp / 'batch.pt'), lr=fam.LR,
                        total_steps=fam.TOTAL, **kw)
             for name, kw in CASES.items()}
    ranks = worker.spawn(dict(bn=False, sharded=dict(grid=GRID,
                                                     cases=cases)),
                         str(tmp), world=4, limit_s=150.0)
    return dict(ranks=[r['sharded'] for r in ranks], cases=cases)


@pytest.fixture(scope='module')
def one_process(job):
    return {name: fam.one_process(job['cases'][name],
                                  job['ranks'][0][name])
            for name in ('dense', 'sparse')}


def jax_step(name, params_like, batch, sums):
    """JAX's step at ``params_like`` on ``batch`` with the points sharded
    ``P('data', 'points')`` and the ground truth ``P('data')`` over the
    2 x 2 mesh, jitted, its BatchNorms on the grid's forward sums
    (``fam.bn_replay``): -> (loss terms, gradients and new running
    statistics under port names)."""
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(GRID),
                ('data', 'points'))
    case = CASES[name]
    sparse = case['merge'] == 'sparse'
    jd = jdet.ShardedPointPillarsDetector(
        TINY, DENSE_HEAD, merge=case['merge'], mesh=mesh if sparse else None,
        bucket_capacity=case.get('capacity'))
    jb = jax_batch(batch)
    with use_mesh(mesh):
        jb = {k: jax.device_put(v, NamedSharding(
            mesh, P('data', 'points') if k.startswith('points')
            else P('data'))) for k, v in jb.items()}

        def f(params, b):
            outs, stats = jd.apply_train(
                {'params': params,
                 'batch_stats': params_like['batch_stats']}, b)
            total, losses = jd.loss(outs, b)
            return total, (losses, stats)
        with fnn.intercept_methods(fam.bn_replay(sums)):
            (_, (losses, stats)), grads = jax.jit(jax.value_and_grad(
                f, has_aux=True))(params_like['params'], jb)
    state = jax_variables_to_torch({'params': params_like['params'],
                                    'batch_stats': _np_tree(stats)})
    return ({k: float(x) for k, x in losses.items()},
            jax_grads_to_torch(_np_tree(grads)), state)


@pytest.mark.parametrize('name', ['dense', 'sparse'])
def test_grid_step_matches_one_process(job, one_process, name):
    for rank in job['ranks']:
        fam.check_against_one_process(rank[name], one_process[name])


@pytest.mark.parametrize('name', ['dense', 'sparse_overflow'])
def test_grid_step_matches_jax_sharded(job, variables, name):
    rank0 = job['ranks'][0][name]
    batch = global_batch()
    want = [jax_step(name, variables, batch, rank0['sums'][0]),
            jax_step(name, fam.torch_to_jax(rank0['states'][0]['trunk'],
                                            variables),
                     batch, rank0['sums'][1])]
    fam.check_against_jax(name, rank0, want)


def test_overflow_drops_cells(job, one_process):
    """The overflowing capacity trains on another canvas than the dense
    merge's (so its agreement with JAX holds the drop rule)."""
    ranks = job['ranks']
    a, b = ranks[0]['sparse_overflow'], ranks[0]['dense']
    assert a['metrics'][0]['loss'] != pytest.approx(b['metrics'][0]['loss'],
                                                    rel=1e-4)


@pytest.mark.parametrize('name', list(CASES))
def test_ranks_end_bitwise_equal(job, name):
    a = job['ranks'][0][name]
    for r in job['ranks'][1:]:
        b = r[name]
        for k in a['params']:
            assert torch.equal(a['params'][k], b['params'][k]), k
        for k in a['stats'][-1]:
            assert torch.equal(a['stats'][-1][k], b['stats'][-1][k]), k
        assert a['metrics'] == b['metrics']


@pytest.mark.parametrize('name', ['dense', 'sparse'])
def test_grid_predict_is_each_data_ranks_samples(job, variables, name):
    td = tdet.ShardedPointPillarsDetector(TINY, DENSE_HEAD, point_axis=None,
                                          device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(variables), strict=True)
    want = [x.numpy() for x in td.predict(global_batch())]
    per = B // GRID[0]
    for r in job['ranks']:
        d = r['mesh'][0]
        got = [x.numpy() for x in r['predict'][name]]
        rows = slice(d * per, (d + 1) * per)
        keep = got[3]
        np.testing.assert_array_equal(keep, want[3][rows])
        np.testing.assert_array_equal(got[2][keep], want[2][rows][keep])
        np.testing.assert_allclose(got[1][keep], want[1][rows][keep],
                                   atol=1e-5)
        close(got[0][keep], want[0][rows][keep], 1e-5, 'boxes')
        mate = job['ranks'][d * GRID[1]]['predict'][name]
        assert all(np.array_equal(x.numpy(), y) for x, y in zip(mate, got))


def test_dense_merge_backward_counts_the_loss_once(job, one_process):
    """The dense merge's backward passes each rank's cotangent through.
    Summed over the points group (``_AllReduce``'s backward), every
    encoder gradient is P = 2 times the one-process one; the trunk's are
    unchanged."""
    want = one_process['dense']['grads'][0]
    good = job['ranks'][0]['dense']['grads'][0]
    bad = job['ranks'][0]['summing_backward']['grads'][0]
    encoder = [k for k in want if k.startswith('voxel_encoder.')]
    assert len(encoder) == 3
    for k in encoder:
        fam.close(good[k], want[k], fam.TOL_ONE, k)
        fam.close(bad[k], GRID[1] * want[k], fam.TOL_ONE, k)
        assert not torch.allclose(bad[k], want[k], rtol=0.5)
    for k in job['ranks'][0]['trunk_names']:
        fam.close(bad[k], want[k], fam.TOL_ONE, k)


def test_reduce_gradients_is_the_grouped_reduction(job):
    """The trunk's gradients bitwise equal to the data group's all-reduce
    (two nonzero terms, the other two exact zeros); the encoder's are the
    world's sum either way, in the order that the flat buffer's layout
    gives gloo's ring (1e-6)."""
    for r in job['ranks']:
        got, want = r['grouped']['got'], r['grouped']['want']
        trunk = r['trunk_names']
        assert len(trunk) == len(got) - 3 and set(got) == set(want)
        for k in trunk:
            assert torch.equal(got[k], want[k]), k
        for k in set(got) - set(trunk):
            fam.close(got[k], want[k], 1e-6, k)


# --------------------------------------------------------- the converter
def test_converter_carries_the_encoder(variables):
    sd = jax_variables_to_torch(variables)
    td = tdet.ShardedPointPillarsDetector(TINY, TINY_HEAD, point_axis=None,
                                          device='cpu')
    td.trunk.load_state_dict(sd, strict=True)
    enc = variables['params']['voxel_encoder']
    stats = variables['batch_stats']['voxel_encoder']
    assert set(enc) == {'linear_0', 'norm_0'}
    pre = 'voxel_encoder.pfn_layers.0.'
    np.testing.assert_array_equal(sd[pre + 'linear.weight'],
                                  enc['linear_0']['kernel'].T)
    np.testing.assert_array_equal(sd[pre + 'norm.weight'],
                                  enc['norm_0']['scale'])
    np.testing.assert_array_equal(sd[pre + 'norm.running_var'],
                                  stats['norm_0']['var'])


@pytest.mark.parametrize('where', ['params', 'batch_stats', 'grads'])
def test_converter_raises_on_unknown_encoder_leaf(variables, where):
    tree = variables['params'] if where == 'grads' else variables[where]
    tree = dict(tree, voxel_encoder=dict(tree['voxel_encoder'],
                                         dense_0={'kernel': np.zeros(3)}))
    with pytest.raises(KeyError, match='dense_0'):
        if where == 'grads':
            jax_grads_to_torch(tree)
        else:
            jax_variables_to_torch(dict(variables, **{where: tree}))
