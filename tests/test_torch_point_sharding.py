"""The port's pillar merges of point sharding against the JAX package's.

One job of 4 gloo ranks on the CPU (``tests/torch_dist_worker.py``'s
``spawn`` and ``points_checks``) runs every check in turn, as a 1 x 4 and
as a 2 x 2 (data, points) grid (``mesh.init_mesh``): each rank passes its
contiguous slice of the points to ``sharded_pillar_reduce`` and
``sharded_pillar_reduce_sparse`` (sum, mean, max; a capacity that keeps
every cell and one that overflows; ``replicate_out`` both ways), merges
one pillar whose points are split over its points group, and runs
``sharded_feature_splat_sparse`` on its samples and slice with the
gradient of ``sum(out * grad)``.  JAX runs the same functions on the whole
arrays on ``Mesh(jax.devices()[:4].reshape(data, points), ('data',
'points'))`` over the ``points`` axis (the splat's samples over ``data``),
and every rank's result equals JAX's at 1e-5: the canvas (a rank's stripe
without ``replicate_out``), the cells an overflowing capacity keeps, and
the splat's input gradient (``jax.grad``).  ``reference_pillar_reduce``
equals JAX's without ranks.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mmdet3d_gaussian_tpu.parallel import point_sharding as jps

from mmdet3d_gaussian_tpu_torch.parallel import point_sharding as tps

from . import torch_dist_worker as worker

torch.set_num_threads(2)

TOL = 1e-5
GEO = (worker.PS_PC_RANGE, worker.PS_VOXEL, worker.PS_NX, worker.PS_NY)
GRIDS = worker.PS_GRIDS
OPS = worker.PS_OPS


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    out = worker.spawn(dict(bn=False, points=True),
                       str(tmp_path_factory.mktemp('point_sharding')),
                       world=4)
    return [r['points'] for r in out]


@pytest.fixture(scope='module')
def inputs():
    return worker.ps_inputs()


def jax_mesh(grid):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(grid),
                ('data', 'points'))


def jitted(fn, *args, **kw):
    """``fn(*args, **kw)`` jitted in its array arguments (eager shard_map
    runs op by op, ~5 s a call on the CPU)."""
    arrays = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]

    def call(*xs):
        full = list(args)
        for i, x in zip(arrays, xs):
            full[i] = x
        return fn(*full, **kw)
    return np.asarray(jax.jit(call)(*[args[i] for i in arrays]))


def of_rank(want, rank, grid, rep=True):
    """JAX's whole canvas -> what ``rank`` of the grid holds: all of it,
    or its points rank's y-stripe without ``replicate_out``."""
    if rep:
        return want
    p = grid[1]
    rows = want.shape[0] // p
    q = rank['mesh'][1]
    return want[q * rows:(q + 1) * rows]


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def test_ranks_sit_on_the_grid(ranks):
    """rank = d P + p, as JAX's ``reshape(data, points)``."""
    for grid in GRIDS:
        assert [r[grid]['mesh'] for r in ranks] == [
            divmod(i, grid[1]) for i in range(4)]


@pytest.mark.parametrize('op', OPS)
def test_reference_matches_jax(inputs, op):
    got = tps.reference_pillar_reduce(torch.from_numpy(inputs['points']),
                                      torch.from_numpy(inputs['mask']),
                                      *GEO, op)
    want = jps.reference_pillar_reduce(jnp.asarray(inputs['points']),
                                       jnp.asarray(inputs['mask']), *GEO, op)
    close(got, want, op)


@pytest.mark.parametrize('op', OPS)
@pytest.mark.parametrize('grid', GRIDS)
def test_dense_merge_matches_jax(ranks, inputs, grid, op):
    want = jitted(jps.sharded_pillar_reduce, jnp.asarray(inputs['points']),
                  jnp.asarray(inputs['mask']), *GEO, jax_mesh(grid),
                  axis='points', op=op)
    for i, r in enumerate(ranks):
        close(r[grid]['dense', op], want, f'{grid} rank {i} {op}')


@pytest.mark.parametrize('cap', worker.PS_CAPS)
@pytest.mark.parametrize('op', OPS)
@pytest.mark.parametrize('grid', GRIDS)
def test_sparse_merge_matches_jax(ranks, inputs, grid, op, cap):
    """Both ``replicate_out`` ways; at capacity 16 the kept cells (and so
    the canvas) are JAX's, and another set than the dense merge's."""
    pts, mask = jnp.asarray(inputs['points']), jnp.asarray(inputs['mask'])
    mesh = jax_mesh(grid)
    dense = jitted(jps.sharded_pillar_reduce, pts, mask, *GEO, mesh,
                   axis='points', op=op)
    for rep in (True, False):
        want = jitted(jps.sharded_pillar_reduce_sparse, pts, mask, *GEO,
                      mesh, axis='points', op=op, bucket_capacity=cap,
                      replicate_out=rep)
        if cap < worker.PS_NX * worker.PS_NY:
            assert not np.allclose(want, dense), 'the capacity overflows'
        else:
            close(want, dense, 'no overflow')
        for i, r in enumerate(ranks):
            got = r[grid]['sparse', op, cap, rep]
            assert got.shape == of_rank(want, r[grid], grid, rep).shape
            close(got, of_rank(want, r[grid], grid, rep),
                  f'{grid} rank {i} {op} cap {cap} replicate_out {rep}')


@pytest.mark.parametrize('grid', GRIDS)
def test_one_pillar_split_over_ranks(ranks, inputs, grid):
    """JAX's ``test_cross_shard_pillar_merge``: the 64 points of one
    pillar, 64 / P a points rank, merge into one cell, dense and sparse,
    equal to JAX's."""
    one = jnp.asarray(inputs['one_pillar'])
    ones = jnp.ones(one.shape[0], bool)
    want = jitted(jps.sharded_pillar_reduce, one, ones, *GEO,
                  jax_mesh(grid), axis='points', op='sum')
    ix = int((5.03 - GEO[0][0]) / GEO[1][0])
    iy = int((-1.17 - GEO[0][1]) / GEO[1][1])
    assert want[iy, ix, 3] == 64 and np.abs(want).sum() == pytest.approx(
        np.abs(want[iy, ix]).sum())
    for r in ranks:
        for merge in ('dense', 'sparse'):
            close(r[grid]['one_pillar', merge], want, merge)


@pytest.mark.parametrize('cap', worker.PS_SPLAT_CAPS)
@pytest.mark.parametrize('grid', GRIDS)
def test_feature_splat_and_gradient_match_jax(ranks, inputs, grid, cap):
    """The canvas and the input gradient of ``sum(out * grad)``
    (``jax.grad``), ``replicate_out`` both ways, each rank on its samples
    and point slice; capacity 8 overflows."""
    mesh = jax_mesh(grid)
    lin, valid = jnp.asarray(inputs['lin']), jnp.asarray(inputs['valid'])
    g = jnp.asarray(inputs['grad'])

    def splat(f, c=cap):
        return jps.sharded_feature_splat_sparse(
            f, lin, valid, worker.PS_NX, worker.PS_NY, mesh,
            bucket_capacity=c, replicate_out=True)

    def out_and_grad(f):
        out, vjp = jax.vjp(splat, f)
        return out, vjp(g)[0]
    feats = jnp.asarray(inputs['feats'])
    out, grad = (np.asarray(x) for x in jax.jit(out_and_grad)(feats))
    if cap is not None:
        full = np.asarray(jax.jit(partial(
            splat, c=worker.PS_NX * worker.PS_NY))(feats))
        assert out[..., -1].sum() < full[..., -1].sum(), \
            'the capacity overflows'
    b, n = inputs['feats'].shape[:2]
    d, p = grid
    for i, r in enumerate(ranks):
        dr, pr = r[grid]['mesh']
        rows = slice(dr * b // d, (dr + 1) * b // d)
        cols = slice(pr * n // p, (pr + 1) * n // p)
        for rep in (True, False):
            got, got_g = r[grid]['splat', cap, rep]
            want = out[rows] if rep else out[
                rows, pr * worker.PS_NY // p:(pr + 1) * worker.PS_NY // p]
            close(got, want, f'{grid} rank {i} cap {cap} canvas {rep}')
            close(got_g, grad[rows, cols],
                  f'{grid} rank {i} cap {cap} gradient {rep}')
