"""The port's sparse convolutions, multi-level sparse encoder, 3D IoU and
box helpers against the JAX package on the CPU.

Inputs are drawn from a seed with numpy and go through both packages.
Tolerances: integers (sites, keys, lookup rows, overflow counts, point in
box) exactly; convolution outputs, the BEV, ``iou_3d`` and the box helpers
within 1e-5 of the output's largest magnitude (f32 sums of a few hundred
products in another order); ``iou_3d`` NaN in the same places.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu.core.bbox import structures as jstr
from mmdet3d_gaussian_tpu.models import middle_encoders as jme
from mmdet3d_gaussian_tpu.ops import rotated_iou as jiou
from mmdet3d_gaussian_tpu.ops import sparse_conv as jsc

from mmdet3d_gaussian_tpu_torch.core.bbox import structures as tstr
from mmdet3d_gaussian_tpu_torch.models import middle_encoders as tme
from mmdet3d_gaussian_tpu_torch.ops import rotated_iou as tiou
from mmdet3d_gaussian_tpu_torch.ops import sparse_conv as tsc

torch.set_num_threads(2)

TOL = 1e-5
SHAPE = (2, 8, 16, 16)


def _t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL, what=''):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def sites(seed, n=160, shape=SHAPE, pad=24):
    """Unique (b, z, y, x) sites in ``shape``, shuffled, with ``pad``
    invalid -1 rows mixed in, and features (n + pad, 4)."""
    rng = np.random.RandomState(seed)
    c = np.stack([rng.randint(0, s, 4 * n) for s in shape], -1)
    c = np.unique(c, axis=0)[:n]
    c = np.concatenate([c, -np.ones((pad, 4), int)])
    c = c[rng.permutation(len(c))].astype(np.int32)
    feats = rng.randn(len(c), 4).astype(np.float32)
    return feats, c


def pair(seed, **kw):
    feats, coords = sites(seed, **kw)
    shape = kw.get('shape', SHAPE)
    js = jsc.make_sparse_tensor(jnp.asarray(feats), jnp.asarray(coords),
                                shape)
    ts = tsc.make_sparse_tensor(_t(feats), _t(coords), shape)
    return js, ts


def same_sites(t, j):
    np.testing.assert_array_equal(t.coords.numpy(), np.asarray(j.coords))
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
    assert int(t.num_voxels) == int(j.num_voxels)
    assert int(t.overflow) == int(j.overflow)


def test_make_sparse_tensor_matches_jax():
    js, ts = pair(0)
    same_sites(ts, js)
    np.testing.assert_array_equal(ts.feats.numpy(), np.asarray(js.feats))
    assert int(ts.num_voxels) == 160
    assert bool((ts.feats[~ts.valid] == 0).all())


@pytest.mark.parametrize('path', ['dense', 'search'])
def test_lookup_rows_match_jax(path, monkeypatch):
    """Rows of every query key equal JAX's on a hit; a miss gives V here,
    and in JAX's dense map V or a row whose features are zero."""
    if path == 'search':
        monkeypatch.setattr(jsc, 'DENSE_LOOKUP_MAX', 0)
    js, ts = pair(1)
    rng = np.random.RandomState(2)
    q = np.concatenate([np.asarray(js.keys)[:200],
                        rng.randint(0, int(np.prod(SHAPE)), 300),
                        [tsc.INT_MAX] * 4]).astype(np.int32)
    got = tsc._lookup(ts, _t(q)).numpy()
    want = np.asarray(jsc._lookup(js, jnp.asarray(q)))
    v = ts.keys.shape[0]
    hit = got < v
    assert hit.sum() >= 160     # the table's own keys, and random hits
    np.testing.assert_array_equal(got[hit], want[hit])
    miss = ~hit
    assert (want[miss] == v).all() or (
        np.abs(np.asarray(js.feats)[np.minimum(want[miss], v - 1)])
        [want[miss] < v].max() == 0)


@pytest.mark.parametrize('kernel', [(3, 3, 3), (1, 3, 3)])
def test_submanifold_conv_matches_jax(kernel):
    js, ts = pair(3)
    rng = np.random.RandomState(4)
    k = int(np.prod(kernel))
    w = (rng.randn(k, 4, 8) / np.sqrt(4 * k)).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    jo = jsc.submanifold_conv3d(js, jnp.asarray(w), jnp.asarray(b), kernel)
    to = tsc.submanifold_conv3d(ts, _t(w), _t(b), kernel)
    same_sites(to, jo)
    close(to.feats, jo.feats, what='subm')
    assert bool((to.feats[~to.valid] == 0).all())


@pytest.mark.parametrize('capacity', [8, 40, 512])
def test_sparse_conv_matches_jax(capacity):
    """Strided conv (stride 2, 3 x 3 x 3): the deduplicated sites in key
    order, truncated at ``capacity`` (8 and 40 overflow), the overflow
    count and the outputs."""
    js, ts = pair(5)
    w = (np.random.RandomState(6).randn(27, 4, 8) * 0.1).astype(np.float32)
    jo = jsc.sparse_conv3d(js, jnp.asarray(w), 2, capacity)
    to = tsc.sparse_conv3d(ts, _t(w), 2, capacity)
    same_sites(to, jo)
    assert (int(to.overflow) > 0) == (capacity < 512)
    assert to.spatial_shape == tuple(jo.spatial_shape) == (2, 4, 8, 8)
    close(to.feats, jo.feats, what=f'strided {capacity}')


def test_sparse_conv_z_only_matches_jax():
    """The encoder's out conv: (3, 1, 1) kernel, stride (2, 1, 1), no
    padding (z 8 -> 3)."""
    js, ts = pair(7)
    w = (np.random.RandomState(8).randn(3, 4, 6) * 0.1).astype(np.float32)
    jo = jsc.sparse_conv3d(js, jnp.asarray(w), (2, 1, 1), 300,
                           kernel_size=(3, 1, 1), padding=(0, 0, 0))
    to = tsc.sparse_conv3d(ts, _t(w), (2, 1, 1), 300, kernel_size=(3, 1, 1),
                           padding=(0, 0, 0))
    same_sites(to, jo)
    assert to.spatial_shape == (2, 3, 16, 16)
    close(to.feats, jo.feats, what='z only')


def test_sparse_to_dense_and_index_map_match_jax():
    js, ts = pair(9)
    close(tsc.sparse_to_dense(ts), jsc.sparse_to_dense(js), tol=0)
    np.testing.assert_array_equal(tsc.dense_index_map(ts).numpy(),
                                  np.asarray(jsc.dense_index_map(js)))


# -------------------------------------------------------------- encoder
ENC = dict(in_channels=4, sparse_shape=(24, 16, 16), base_channels=8,
           encoder_channels=((8,), (16, 16), (16, 16), (16, 16)),
           out_channels=16)


def encoder_state(params, stats):
    """The JAX encoder's tree -> the port's ``MlvlSparseEncoder``
    state_dict (the converter's ``middle_encoder`` rule)."""
    sd = {}
    for name, sub in params.items():
        sd[f'{name}.weight'] = _t(np.asarray(sub['kernel']))
        sd[f'{name}.bn.weight'] = _t(np.asarray(sub['bn']['scale']))
        sd[f'{name}.bn.bias'] = _t(np.asarray(sub['bn']['bias']))
        sd[f'{name}.bn.running_mean'] = _t(np.asarray(
            stats[name]['bn']['mean']))
        sd[f'{name}.bn.running_var'] = _t(np.asarray(stats[name]['bn']['var']))
    return sd


def randomize(tree, rng):
    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ('bias', 'mean'):
            return (rng.randn(*x.shape) * 0.1).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope='module')
def encoder_pair():
    """Both encoders with the JAX weights (BN statistics, scales and biases
    redrawn) on B = 2 samples of 400 sites in a 24 x 16 x 16 grid, capacity
    150 a sample: level 1 (478 sites) overflows, the last sample loses its
    sites first."""
    cap = 150
    feats, coords = sites(10, n=800, shape=(2, 24, 16, 16), pad=40)
    jm = jme.MlvlSparseEncoder(capacity=cap * 2, **ENC)
    v = jax.jit(lambda f, c: jm.init(jax.random.PRNGKey(0), f, c, 2))(
        jnp.asarray(feats), jnp.asarray(coords))
    v = randomize(jax.tree_util.tree_map(np.asarray, v),
                  np.random.RandomState(0))
    tm = tme.MlvlSparseEncoder(max_voxels=cap, **ENC)
    tm.load_state_dict(encoder_state(v['params'], v['batch_stats']),
                       strict=True)
    return jm, v, tm, feats, coords


@pytest.mark.parametrize('train', [False, True])
def test_encoder_levels_match_jax(encoder_pair, train):
    """Every level's sites, keys and overflow exactly; features and the
    BEV (channel z * C + c) within 1e-5; in training the new running
    statistics too."""
    jm, v, tm, feats, coords = encoder_pair
    out = jax.jit(lambda v, f, c: jm.apply(
        v, f, c, 2, train, mutable=['batch_stats'] if train else False))(
        v, jnp.asarray(feats), jnp.asarray(coords))
    (jlevels, jbev), stats = out if train else (out, None)
    sd = {k: t.clone() for k, t in tm.state_dict().items()}
    tm.train(train)
    with torch.set_grad_enabled(train):
        tlevels, tbev = tm(_t(feats), _t(coords), 2)
    assert len(tlevels) == 4
    assert int(tlevels[-1].overflow) > 0
    for i, (t, j) in enumerate(zip(tlevels, jlevels)):
        same_sites(t, j)
        close(t.feats.detach(), j.feats, what=f'level {i}')
    # samples are batch-major: sample 1 lost its strided sites first
    b1 = tlevels[1].coords[tlevels[1].valid, 0]
    assert int((b1 == 0).sum()) > int((b1 == 1).sum())
    assert tbev.shape == jbev.shape == (2, 2, 2, 16)
    close(tbev.detach(), jbev, what='bev')
    if train:
        want = encoder_state(v['params'], jax.tree_util.tree_map(
            np.asarray, stats['batch_stats']))
        for k, w in want.items():
            if 'running' in k:
                close(tm.state_dict()[k], w, what=k)
    tm.load_state_dict(sd)


# ------------------------------------------------------- 3D IoU, boxes
def boxes(rng, n):
    return np.c_[rng.uniform(-4, 4, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                 rng.uniform(0.5, 4, (n, 3)),
                 rng.uniform(-np.pi, np.pi, (n, 1))].astype(np.float32)


def test_iou_3d_matches_jax():
    """Overlapping, disjoint in z, identical, and boxes with a NaN size or
    a NaN yaw."""
    rng = np.random.RandomState(11)
    a, b = boxes(rng, 40), boxes(rng, 30)
    b[:5] = a[:5]                     # identical pairs
    b[5:8, 2] = 5.0                   # z apart
    a[-1, 3] = np.nan
    b[-1, 6] = np.nan
    want = np.asarray(jiou.iou_3d(jnp.asarray(a), jnp.asarray(b)))
    got = tiou.iou_3d(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    # a NaN size gives NaN; a NaN yaw fails every vertex test: IoU 0
    assert np.isnan(want[-1]).all() and np.isnan(want).sum() == 30
    assert (want[:-1, -1] == 0).all()
    ok = ~np.isnan(want)
    close(got[ok], want[ok], what='iou_3d')
    assert (want[ok] > 0.1).sum() > 5
    np.testing.assert_allclose(np.diag(got[:5, :5]), 1.0, rtol=1e-5)


def test_box_helpers_match_jax():
    rng = np.random.RandomState(12)
    bx = boxes(rng, 16)
    pts = np.c_[rng.uniform(-5, 5, (300, 2)),
                rng.uniform(-2.5, 2, (300, 1))].astype(np.float32)
    ang = rng.uniform(-4, 4, 300).astype(np.float32)
    for axis in (0, 1, 2):
        close(tstr.rotation_3d_in_axis(_t(pts), _t(ang), axis),
              jstr.rotation_3d_in_axis(jnp.asarray(pts), jnp.asarray(ang),
                                       axis), what=f'axis {axis}')
    close(tstr.rotation_2d(_t(pts[:, :2]), _t(ang)),
          jstr.rotation_2d(jnp.asarray(pts[:, :2]), jnp.asarray(ang)))
    close(tstr.corners_3d(_t(bx)), jstr.corners_3d(jnp.asarray(bx)))
    got = tstr.points_in_boxes_3d(_t(pts), _t(bx)).numpy()
    want = np.asarray(jstr.points_in_boxes_3d(jnp.asarray(pts),
                                              jnp.asarray(bx)))
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 10
    np.testing.assert_array_equal(
        tstr.points_in_boxes_bev(_t(pts[:, :2]), _t(bx)).numpy(),
        np.asarray(jstr.points_in_boxes_bev(jnp.asarray(pts[:, :2]),
                                            jnp.asarray(bx))))
