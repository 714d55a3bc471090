"""The port's set-abstraction ops and modules against the JAX package on
the CPU: furthest point sampling, ball query, grouping, voxel query, the
BEV bilinear sample and ``GuidedSAModuleMSG`` on a shared support table.

Inputs are drawn from a seed with numpy (the JAX functions vmapped over
the samples).  Tolerances: every index exactly (FPS, ball query with its
strict boundary, padding and empty balls, voxel query); grouped
coordinates and features, the BEV sample and the module's outputs within
1e-5 of the output's largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu.models import middle_encoders as jme
from mmdet3d_gaussian_tpu.ops import vsa as jvsa

from mmdet3d_gaussian_tpu_torch.models import middle_encoders as tme
from mmdet3d_gaussian_tpu_torch.ops import vsa as tvsa

from tests.test_torch_sparse_conv import _t, close, randomize

torch.set_num_threads(2)


def cloud(rng, b, n, lo=-2.0, hi=2.0):
    return rng.uniform(lo, hi, (b, n, 3)).astype(np.float32)


@pytest.mark.parametrize('case', ['random', 'masked', 'first_invalid',
                                  'duplicates'])
def test_fps_matches_jax(case):
    rng = np.random.RandomState(0)
    pts = cloud(rng, 3, 257)
    mask = np.ones((3, 257), bool)
    if case in ('masked', 'first_invalid'):
        mask = rng.rand(3, 257) > 0.3
    if case == 'first_invalid':
        mask[:, :5] = False
    if case == 'duplicates':          # equal distances: the first max wins
        pts[:, 128:] = pts[:, :129]
    want = np.asarray(jax.jit(jax.vmap(
        lambda p, m: jvsa.furthest_point_sample(p, 64, m)))(
        jnp.asarray(pts), jnp.asarray(mask)))
    got = tvsa.furthest_point_sample(_t(pts), 64, _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert mask[np.arange(3)[:, None], got].all()
    if case == 'first_invalid':
        assert (got[:, 0] >= 5).all()


def ball_case(case, rng):
    """(support (B, N, 3), queries (B, M, 3), mask (B, N), radius,
    nsample)."""
    b, n, m = 2, 300, 50
    sup, q = cloud(rng, b, n), cloud(rng, b, m)
    mask = np.ones((b, n), bool)
    r, k = 0.5, 8
    if case == 'boundary':
        # supports at exactly r (d^2 = r^2 = 0.25, representable) from
        # integer queries: excluded by the strict test; inside ones kept
        q = rng.randint(-2, 3, (b, m, 3)).astype(np.float32)
        off = np.zeros((b, m, 3), np.float32)
        off[..., rng.randint(0, 3)] = 0.5
        sup[:, :m] = q + off
        sup[:, m:2 * m] = q + off * 0.5
    elif case == 'empty':
        q[:, ::2] += 10.0             # far from every support point
    elif case == 'padding':
        r, k = 0.3, 32                # few hits: first hit repeated
    elif case == 'masked':
        mask = rng.rand(b, n) > 0.5
    elif case == 'short_support':
        sup, mask, k = sup[:, :5], mask[:, :5], 8   # N < nsample
        r = 3.0
    return sup, q, mask, r, k


BALL_CASES = ['random', 'boundary', 'empty', 'padding', 'masked',
              'short_support']


@pytest.mark.parametrize('case', BALL_CASES)
def test_ball_query_matches_jax(case):
    sup, q, mask, r, k = ball_case(case, np.random.RandomState(1))
    want = np.asarray(jax.jit(jax.vmap(
        lambda s, qq, mm: jvsa.ball_query(r, k, s, qq, mm)))(
        jnp.asarray(sup), jnp.asarray(q), jnp.asarray(mask)))
    got = tvsa.ball_query(r, k, _t(sup), _t(q), _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == 'boundary':
        m = q.shape[1]
        assert not np.isin(np.arange(m), got).any()   # at r: never in
        assert np.isin(np.arange(m, 2 * m), got).all()
    if case == 'empty':
        assert (got[:, ::2] == -1).all()
    if case == 'padding':
        assert (got[..., -1] == got[..., 0]).mean() > 0.5


def test_ball_query_chunks_agree(monkeypatch):
    """Chunking the queries (7 queries a chunk here) changes nothing."""
    sup, q, mask, r, k = ball_case('masked', np.random.RandomState(2))
    whole = tvsa.ball_query(r, k, _t(sup), _t(q), _t(mask))
    monkeypatch.setattr(tvsa, 'CHUNK_ELEMENTS', 7 * 2 * sup.shape[1])
    assert torch.equal(tvsa.ball_query(r, k, _t(sup), _t(q), _t(mask)),
                       whole)


@pytest.mark.parametrize('normalize', [False, True])
def test_query_and_group_matches_jax(normalize):
    sup, q, mask, r, k = ball_case('empty', np.random.RandomState(3))
    feats = np.random.RandomState(4).randn(*sup.shape[:2], 5).astype(
        np.float32)
    jg, ji = jax.jit(jax.vmap(lambda s, qq, f, mm: jvsa.query_and_group(
        r, k, s, qq, features=f, support_mask=mm,
        normalize_xyz=normalize)))(jnp.asarray(sup), jnp.asarray(q),
                                   jnp.asarray(feats), jnp.asarray(mask))
    tg, ti = tvsa.query_and_group(r, k, _t(sup), _t(q), _t(feats), _t(mask),
                                  normalize_xyz=normalize)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tg, jg, what='grouped')
    assert bool((tg[ti[..., 0] < 0] == 0).all())


@pytest.mark.parametrize('radius', [None, 0.5])
def test_voxel_query_matches_jax(radius):
    rng = np.random.RandomState(5)
    dense = np.full((6, 10, 12), -1, np.int32)
    live = rng.rand(*dense.shape) < 0.3
    dense[live] = np.arange(live.sum())
    pcr, vs = (0., -2., -1., 2.4, 2., 0.2), (0.2, 0.4, 0.2)
    q = np.c_[rng.uniform(-0.2, 2.6, 80), rng.uniform(-2.2, 2.2, 80),
              rng.uniform(-1.1, 0.3, 80)].astype(np.float32)
    want = np.asarray(jvsa.voxel_query(jnp.asarray(q), jnp.asarray(dense),
                                       pcr, vs, (1, 1, 2), 6, radius))
    got = tvsa.voxel_query(_t(q), _t(dense), pcr, vs, (1, 1, 2), 6,
                           radius).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got == -1).any()


@pytest.mark.parametrize('align', ['half', 'halfmin'])
def test_bilinear_sample_bev_matches_jax(align):
    """Points in range and beyond it (the clamps)."""
    rng = np.random.RandomState(6)
    bev = rng.randn(2, 10, 11, 7).astype(np.float32)
    pcr = (0., -4., -3., 8.8, 4., 1.)
    xy = np.c_[rng.uniform(-1, 10, (2 * 90, 1)),
               rng.uniform(-5, 5, (2 * 90, 1))].reshape(2, 90, 2).astype(
        np.float32)
    cell, base = (0.8, 0.8), (0.1, 0.1)
    want = jax.vmap(lambda bv, p: jme.bilinear_sample_bev(
        bv, p, pcr, cell, align, base))(jnp.asarray(bev), jnp.asarray(xy))
    got = tme.bilinear_sample_bev(_t(bev), _t(xy), pcr, cell, align, base)
    close(got, want, what=align)


# ------------------------------------------------------ GuidedSAModuleMSG
SA = dict(radii=(0.6, 1.0), nsamples=(8, 16), mlps=((8, 8), (8, 12)))


def sa_state(params, stats):
    """The JAX module's tree -> the port's state_dict (the converter's
    ``scale{i}_mlp{j}`` rule)."""
    sd = {}
    for leaf in params:
        if '_mlp' not in leaf:
            continue
        i, j = leaf[5:].split('_mlp')
        bn = f'scale{i}_bn{j}'
        pre = f'mlps.{i}.{j}'
        sd[f'{pre}.linear.weight'] = _t(np.asarray(params[leaf]['kernel']).T)
        sd[f'{pre}.norm.weight'] = _t(np.asarray(params[bn]['scale']))
        sd[f'{pre}.norm.bias'] = _t(np.asarray(params[bn]['bias']))
        sd[f'{pre}.norm.running_mean'] = _t(np.asarray(stats[bn]['mean']))
        sd[f'{pre}.norm.running_var'] = _t(np.asarray(stats[bn]['var']))
    return sd


@pytest.mark.parametrize('pool', ['max', 'avg'])
@pytest.mark.parametrize('train', [False, True])
def test_guided_sa_shared_table_matches_jax(pool, train):
    """A shared table of 400 rows (a voxel level: sample ids, invalid
    rows, sample 2 empty) with per-sample masks, queried by 3 x 40
    keypoints: outputs within 1e-5, and in training the new running
    statistics."""
    rng = np.random.RandomState(7)
    n, b, m = 400, 3, 40
    xyz = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    feats = rng.randn(n, 6).astype(np.float32)
    sample = np.sort(rng.randint(0, 2, n))
    valid = rng.rand(n) > 0.1
    mask = valid[None] & (sample[None] == np.arange(b)[:, None])
    q = rng.uniform(-2, 2, (b, m, 3)).astype(np.float32)
    jm = jme.GuidedSAModuleMSG(pool_method=pool, **SA)
    args = tuple(jnp.asarray(a) for a in (xyz, feats, q, mask))
    v = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a))(*args)
    v = randomize(jax.tree_util.tree_map(np.asarray, v),
                  np.random.RandomState(8))
    out = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=train, mutable=['batch_stats'] if train else False))(
        v, *args)
    want, stats = out if train else (out, None)
    tm = tme.GuidedSAModuleMSG(6, pool_method=pool, **SA)
    tm.load_state_dict(sa_state(v['params'], v['batch_stats']), strict=True)
    tm.train(train)
    with torch.set_grad_enabled(train):
        got = tm(_t(xyz), _t(feats), _t(q), _t(mask))
    close(got.detach(), want, what='sa')
    assert bool((got[2] == 0).all())          # sample 2 has no support
    if train:
        ref = sa_state(v['params'], jax.tree_util.tree_map(
            np.asarray, stats['batch_stats']))
        for k, w in ref.items():
            if 'running' in k:
                close(tm.state_dict()[k], w, what=k)
