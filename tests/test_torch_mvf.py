"""The port's multi-view-fusion (MVF) encoder and the TINY MVF PointPillars
detector against the JAX package on the CPU.

The pieces of ``models/mvf_encoder.py`` at ``tests/test_mvf.py``'s encoder
shapes (the coordinate views, the bilinear sample with taps off every edge,
``BasicBlock2D``, ``SingleViewNet`` on an odd canvas, the encoder in eval
and in training), the KITTI MVF configs' voxel coords on a full-size
batch, the weight converter's MVF leaves, and the TINY MVF PointPillars
detector (``tests/test_e2e_pointpillars.py``'s TINY model, a 64 x 48 BEV
canvas and a 39 x 11 cylindrical one): predict, and one train step with
dense and with sparse targets.  Inputs come from a seed with numpy and the
weights from JAX through ``weights.jax_variables_to_torch``.

Tolerances (``tests/test_torch_train.py``'s): losses rtol 1e-5; gradients
rtol 1e-4 and atol 1e-7 of each parameter's largest gradient (f32 sums in
another order: the bilinear sample's backward is a scatter-add, JAX sums
its per-sample masked loop); features, maps and boxes 1e-5 of their
scale; voxel coords, keep masks and labels equal.
"""
import copy
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.models import mvf_encoder as jmvf
from mmdet3d_gaussian_tpu.ops import scatter as jsc
from mmdet3d_gaussian_tpu.utils.config import Config as JConfig

from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.models import mvf_encoder as tmvf
from mmdet3d_gaussian_tpu_torch.ops import scatter as tsc
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

torch.set_num_threads(2)

CONFIGS = os.path.join(os.path.dirname(__file__), '..', 'configs', 'kitti')
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
TOL = 1e-5

# tests/test_mvf.py's encoder
ENC = dict(in_channels=4, feat_channels=16,
           views=('cartesian', 'cylindrical'),
           voxel_size=((0.75, 0.75, 4.0), (0.3927, 0.25, 10.0)),
           point_cloud_range=((-6, -6, -2, 6, 6, 2),
                              (-3.1416, -2.0, 0.0, 3.1416, 2.0, 10.0)),
           max_voxels=512)
# a single view whose canvas is 15 wide and 16 high: res2 and res3 give
# 8 x 8 and 4 x 4, the deconvs 16 x 16, cropped to 15
ODD_VIEW = dict(voxel_size=(0.8, 0.75, 4.0),
                point_cloud_range=(-6, -6, -2, 6, 6, 2))

# tests/test_e2e_pointpillars.py's TINY model with the MVF encoder: a 64 x
# 48 BEV canvas (H != W) and a 39 x 11 cylindrical one (both odd)
PCR = (0., -9.6, -3., 25.6, 9.6, 1.)
TINY_MVF = dict(
    voxel_size=(0.4, 0.4, 4.0), point_cloud_range=PCR,
    max_points_per_voxel=16, max_voxels_per_sample=1024,
    voxelize_mode='mvf',
    encoder_cfg=dict(in_channels=4, feat_channels=16,
                     views=('cartesian', 'cylindrical'),
                     voxel_size=((0.4, 0.4, 4.0), (0.04, 0.4, 40.0)),
                     point_cloud_range=(PCR, (-0.78, -3.0, 0.0, 0.78, 1.4,
                                              40.0))),
    backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                      layer_nums=(1, 1, 1), layer_strides=(2, 2, 2)),
    neck_cfg=dict(in_channels=(16, 32, 64), out_channels=(16, 16, 16),
                  upsample_strides=(1, 2, 4)),
    head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=48),
)
TINY_HEAD = dict(test_cfg=dict(use_rotate_nms=True, nms_thr=0.01,
                               score_thr=0.05, nms_pre=128, max_num=32))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize(tree, rng):
    """Redraw BN statistics, scales and biases (so a swapped mean / var or
    scale / bias, or a bias left at its init, cannot pass)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out[k] = randomize(v, rng)
        elif k == 'var':
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k in ('mean', 'bias'):
            out[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
        elif k == 'scale':
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def close(got, want, tol=TOL, what=''):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def grads_close(got, want):
    """Each gradient within GRAD_RTOL of its parameter's largest JAX
    gradient (and GRAD_ATOL).  A bias's gradient sums its layer's output
    gradients, which may cancel to far below each of them (the yaw
    branch's in yaw mode: 1e-3 from terms of 1e-1), so its f32 summation
    error scales with them: it is held to the larger of its own and its
    layer's weight gradient's largest value."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert scale > 0, k
        layer = k[:-len('bias')] + 'weight'
        if k.endswith('.bias') and layer in want:
            scale = max(scale, float(np.abs(np.asarray(want[layer])).max()))
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0,
                                   atol=max(GRAD_RTOL * scale, GRAD_ATOL),
                                   err_msg=k)


def _t(a):
    return torch.from_numpy(np.array(a))


def points(seed, b=2, n=256):
    """tests/test_mvf.py's cloud: (b, n, 4) points, the last 16 of a sample
    padded."""
    rng = np.random.RandomState(seed)
    pts = np.c_[rng.uniform(-6, 6, (b * n, 2)), rng.uniform(-1, 1, (b * n, 1)),
                rng.rand(b * n, 1)].astype(np.float32).reshape(b, n, 4)
    mask = np.ones((b, n), bool)
    mask[:, n - 16:] = False
    return pts, mask


def sub_state(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


# -------------------------------------------------------- views, sample
@pytest.mark.parametrize('view', ['cartesian', 'cylindrical', 'spherical'])
def test_view_transforms_match_jax(view):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-30, 30, (4096, 5)).astype(np.float32)
    pts[:8, :3] = 0.0           # the origin: rho 0, pitch from max(rho, eps)
    want = np.asarray(jmvf.VIEW_TRANSFORMS[view](jnp.asarray(pts)))
    got = tmvf.VIEW_TRANSFORMS[view](_t(pts)).numpy()
    assert got.shape == want.shape == (4096, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[:, 3:], pts[:, 3:])


@pytest.mark.parametrize('name', [
    'pillarmvf_pointpillars_secfpn_8x4_160e_kitti-3d-3class.py',
    'pillarmvf_centerpoint_secfpn_8x4_160e_kitti-3d-3class.py'])
def test_view_coords_equal_at_config_width(name):
    """The KITTI MVF configs' views on a full-size batch (4 x 16,384
    points): every point's voxel coords in every view equal JAX's (a cell
    of the cylindrical view is 0.0038 rad wide, so an atan2 one ulp off
    could move a point across a boundary), and so the cross-view mask."""
    enc = JConfig.fromfile(os.path.join(CONFIGS, name)).to_dict()[
        'model']['encoder_cfg']
    batch = jdet.synthetic_batch(batch_size=4, num_points=16384)
    flat = np.asarray(batch['points']).reshape(-1, 4)
    n_valid = np.ones(len(flat), bool)
    for view, vs, pcr in zip(enc['views'], enc['voxel_size'],
                             enc['point_cloud_range']):
        jp = jmvf.VIEW_TRANSFORMS[view](jnp.asarray(flat))
        want = np.asarray(jsc.compute_voxel_coords(jp[:, :3], pcr, vs)[0])
        tp = tmvf.VIEW_TRANSFORMS[view](_t(flat))
        got = tsc.compute_voxel_coords(tp[:, :3], pcr, vs)[0].numpy()
        differ = int((got != want).any(-1).sum())
        assert differ == 0, f'{view}: {differ} points in other cells'
        n_valid &= (want >= 0).all(-1)
    # the cross-view mask keeps about a third of a uniform cloud
    assert 0.2 < n_valid.mean() < 0.5, n_valid.mean()


def test_bilinear_sample_zeros_matches_jax():
    """Taps off every edge (x and y from -1.5 to beyond the far edge,
    integers and half-integers among them), each point from its own
    sample's canvas, invalid points 0: JAX's per-sample masked sum."""
    rng = np.random.RandomState(1)
    b, h, w, c = 3, 5, 7, 4
    canvas = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    uv = np.c_[rng.uniform(-1.5, w + 0.5, 400), rng.uniform(-1.5, h + 0.5,
                                                            400)]
    grid = np.stack(np.meshgrid(np.arange(-2, w + 2) * 0.5 - 0.5,
                                np.arange(-2, h + 2) * 0.5 - 0.5), -1)
    uv = np.r_[uv, grid.reshape(-1, 2)].astype(np.float32)
    bidx = rng.randint(0, b, len(uv)).astype(np.int32)
    valid = rng.rand(len(uv)) > 0.1
    want = sum(np.asarray(jmvf.bilinear_sample_zeros(
        jnp.asarray(canvas[i]), jnp.asarray(uv)))
        * ((bidx == i) & valid)[:, None] for i in range(b))
    got = tmvf.bilinear_sample_zeros(_t(canvas), _t(uv), _t(bidx),
                                     _t(valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    outside = ((uv[:, 0] <= -1) | (uv[:, 0] >= w) | (uv[:, 1] <= -1)
               | (uv[:, 1] >= h))
    assert outside.any() and not want[outside].any()
    assert (want[~outside & valid] != 0).any()


# ------------------------------------------------------------- modules
def _block_state(p, s):
    """A JAX BasicBlock2D's variables -> the port block's state_dict."""
    sd = {}
    for conv, bn in (('conv1', 'bn1'), ('conv2', 'bn2'),
                     ('down_conv', 'down_bn')):
        if conv not in p:
            continue
        sd[f'{conv}.weight'] = _t(np.transpose(p[conv]['kernel'],
                                               (3, 2, 0, 1)))
        sd[f'{bn}.weight'], sd[f'{bn}.bias'] = (_t(p[bn]['scale']),
                                                _t(p[bn]['bias']))
        if s is not None:
            sd[f'{bn}.running_mean'] = _t(s[bn]['mean'])
            sd[f'{bn}.running_var'] = _t(s[bn]['var'])
            sd[f'{bn}.num_batches_tracked'] = torch.tensor(0)
    return sd


@pytest.mark.parametrize('stride,cin', [(1, 8), (2, 8), (1, 4)])
def test_basic_block_matches_jax(stride, cin):
    """Training mode on a 9 x 11 map: the output, the new running
    statistics and the gradients of the input and every parameter; the 1
    x 1 down branch exactly where the stride or the width changes."""
    rng = np.random.RandomState(stride * 10 + cin)
    x = rng.normal(0, 1, (2, 9, 11, cin)).astype(np.float32)
    g = rng.normal(0, 1, (2, 9 // stride + 9 % stride, 11 // stride
                          + 11 % stride, 8)).astype(np.float32)
    jb = jmvf.BasicBlock2D(8, stride=stride)
    v = jb.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    v = randomize(np_tree(v), rng)

    def f(params, x):
        y, upd = jb.apply({'params': params, 'batch_stats': v['batch_stats']},
                          x, train=True, mutable=['batch_stats'])
        return (y * g).sum(), (y, upd['batch_stats'])

    (_, (want, stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v['params'], jnp.asarray(x))
    tb = tmvf.BasicBlock2D(cin, 8, stride)
    assert tb.down == ('down_conv' in v['params']) == (stride != 1
                                                       or cin != 8)
    tb.load_state_dict(_block_state(v['params'], v['batch_stats']),
                       strict=True)
    tb.train()
    xt = _t(x).requires_grad_(True)
    y = tb(xt)
    close(y, want, what='output')
    params = dict(tb.named_parameters())
    grads = torch.autograd.grad((y * _t(g)).sum(), [xt] + list(
        params.values()))
    close(grads[0], gx, what='input gradient')
    grads_close(dict(zip(params, grads[1:])), {
        k: v for k, v in _block_state(np_tree(gp), None).items()})
    sd = _block_state(v['params'], np_tree(stats))
    for k, t in tb.state_dict().items():
        if 'running_' in k:
            close(t, sd[k], what=k)


def view_scatter(pts, mask, vs, pcr, max_voxels):
    """(JAX Scatter, port Scatter, view points (N, 3)) of one view."""
    flat = pts.reshape(-1, 4)
    bidx = np.repeat(np.arange(pts.shape[0], dtype=np.int32), pts.shape[1])
    c3, _ = jsc.compute_voxel_coords(jnp.asarray(flat[:, :3]), pcr, vs)
    c3 = jnp.where(jnp.asarray(mask.reshape(-1, 1)), c3, -1)
    c4 = np.asarray(jsc.batch_coords(c3, jnp.asarray(bidx)))
    shape = (pts.shape[0],) + tmvf.view_grid(pcr, vs)
    return (jsc.build_scatter(jnp.asarray(c4), shape, max_voxels,
                              key_order=(0, 2, 1, 3)),
            tsc.build_scatter(_t(c4), shape, max_voxels,
                              key_order=tmvf.VIEW_KEY_ORDER), flat[:, :3],
            bidx)


@pytest.mark.parametrize('train', [False, True])
def test_single_view_net_matches_jax(train):
    """One view's tower on a 15 x 16 canvas: the sampled point features
    and, in training, the gradients of its input and every parameter and
    the running statistics."""
    pts, mask = points(2)
    vs, pcr = ODD_VIEW['voxel_size'], ODD_VIEW['point_cloud_range']
    jscat, tscat, xyz, bidx = view_scatter(pts, mask, vs, pcr, 512)
    feats = np.random.RandomState(3).normal(0, 1, (len(xyz), 16)).astype(
        np.float32)
    net = jmvf.SingleViewNet(feat_channels=16, voxel_size=vs,
                             point_cloud_range=pcr)
    v = net.init(jax.random.PRNGKey(0), jnp.asarray(xyz),
                 jnp.asarray(feats), jscat, 2, False)
    v = randomize(np_tree(v), np.random.RandomState(4))
    g = np.random.RandomState(5).normal(0, 1, (len(xyz), 16)).astype(
        np.float32)

    def f(params, feats):
        out, upd = net.apply({'params': params,
                              'batch_stats': v['batch_stats']},
                             jnp.asarray(xyz), feats, jscat, 2, train,
                             mutable=['batch_stats'])
        return (out * g).sum(), (out, upd['batch_stats'])

    (_, (want, stats)), (gp, gf) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v['params'], jnp.asarray(feats))
    tnet = tmvf.SingleViewNet(16, 16, vs, pcr)
    assert (tnet.nx, tnet.ny) == (15, 16)
    wrap = lambda tree: {'voxel_encoder': {'view_cartesian': tree}}  # noqa
    prefix = 'voxel_encoder.views.cartesian.'
    tnet.load_state_dict(sub_state(jax_variables_to_torch(
        {'params': wrap(v['params']),
         'batch_stats': wrap(v['batch_stats'])}), prefix), strict=True)
    tnet.train(train)
    ft = _t(feats).requires_grad_(True)
    out = tnet(_t(xyz), ft, tscat, _t(bidx), 2)
    close(out, want, what='features')
    valid = np.asarray(jscat.valid_point_mask)
    assert (~valid).any() and not np.asarray(want)[~valid].any()
    if not train:
        return
    params = dict(tnet.named_parameters())
    grads = torch.autograd.grad((out * _t(g)).sum(), [ft] + list(
        params.values()))
    close(grads[0], gf, what='feature gradient')
    grads_close(dict(zip(params, grads[1:])), sub_state(
        jax_grads_to_torch(wrap(np_tree(gp))), prefix))
    want_sd = sub_state(jax_variables_to_torch(
        {'params': wrap(v['params']), 'batch_stats': wrap(np_tree(stats))}),
        prefix)
    for k, t in tnet.state_dict().items():
        if 'running_' in k:
            close(t, want_sd[k], what=k)


@pytest.fixture(scope='module')
def encoder_pair():
    """JAX's encoder variables (BN statistics, scales and biases redrawn)
    and its outputs in eval and in training, with the gradients of a
    random projection of the pillar features."""
    pts, mask = points(1)
    enc = jmvf.PillarMVFFeatureNet(**ENC)
    v = enc.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask))
    v = randomize(np_tree(v), np.random.RandomState(7))
    g = np.random.RandomState(8).normal(0, 1, (512, 16)).astype(np.float32)
    out = {}
    for train in (False, True):
        def f(params):
            (pillar, coords, grid), upd = enc.apply(
                {'params': params, 'batch_stats': v['batch_stats']},
                jnp.asarray(pts), jnp.asarray(mask), train=train,
                mutable=['batch_stats'])
            return (pillar * g).sum(), (pillar, coords, grid,
                                        upd['batch_stats'])
        (_, (pillar, coords, grid, stats)), grads = jax.value_and_grad(
            f, has_aux=True)(v['params'])
        out[train] = dict(pillar=np.asarray(pillar),
                          coords=np.asarray(coords), grid=grid,
                          stats=np_tree(stats), grads=np_tree(grads))
    return pts, mask, v, g, out


def _wrap(tree):
    return {'voxel_encoder': tree}


@pytest.mark.parametrize('train', [False, True])
def test_encoder_matches_jax(encoder_pair, train):
    """Pillar features, view 0's voxel coords (equal), the canvas size
    and, in training, every parameter's gradient and the running
    statistics of every BatchNorm (the point nets' masked ones and the
    towers' K4 ones)."""
    pts, mask, v, g, out = encoder_pair
    want = out[train]
    tenc = tmvf.PillarMVFFeatureNet(**ENC)
    tenc.load_state_dict(sub_state(jax_variables_to_torch(
        {'params': _wrap(v['params']),
         'batch_stats': _wrap(v['batch_stats'])}), 'voxel_encoder.'),
        strict=True)
    tenc.train(train)
    pillar, coords, scatter = tenc(_t(pts), _t(mask))
    np.testing.assert_array_equal(coords.numpy(), want['coords'])
    assert tenc.canvas_size() == tuple(want['grid']) == (16, 16)
    live = want['coords'][:, 0] >= 0
    assert live.sum() > 10 and not want['pillar'][~live].any()
    close(pillar, want['pillar'], what='pillar features')
    if not train:
        return
    params = dict(tenc.named_parameters())
    grads = torch.autograd.grad((pillar * _t(g)).sum(),
                                list(params.values()))
    grads_close(dict(zip(params, grads)), sub_state(
        jax_grads_to_torch(_wrap(want['grads'])), 'voxel_encoder.'))
    want_sd = sub_state(jax_variables_to_torch(
        {'params': _wrap(v['params']),
         'batch_stats': _wrap(want['stats'])}), 'voxel_encoder.')
    keys = [k for k in want_sd if 'running_' in k]
    # 3 point nets + 2 views x (point net + 8 tower BatchNorms), mean + var
    assert len(keys) == 2 * (3 + 2 * 9)
    state = tenc.state_dict()
    for k in keys:
        close(state[k], want_sd[k], what=k)


def test_converter_maps_every_mvf_leaf(encoder_pair):
    """Every JAX leaf of the encoder has a port tensor of its size, the
    port has none the tree does not fill (besides BN counters); the
    deconv kernels are flipped; an unknown leaf raises KeyError, in the
    variables and in a gradient tree."""
    _, _, v, _, _ = encoder_pair
    sd = sub_state(jax_variables_to_torch(
        {'params': _wrap(v['params']),
         'batch_stats': _wrap(v['batch_stats'])}), 'voxel_encoder.')
    mine = tmvf.PillarMVFFeatureNet(**ENC).state_dict()
    assert set(sd) == set(mine), set(sd) ^ set(mine)
    for k, t in sd.items():
        assert t.shape == mine[k].shape, k
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(v))
    assert n_jax == sum(t.numel() for k, t in sd.items()
                        if not k.endswith('num_batches_tracked'))
    for view in ('cartesian', 'cylindrical'):
        tree = v['params'][f'view_{view}']
        assert 'down_conv' not in tree['res1'] and all(
            'down_conv' in tree[r] for r in ('res2', 'res3'))
        for name, s in (('deconv2', 2), ('deconv3', 4)):
            k = tree[name]['kernel']                 # (s, s, cin, cout)
            w = sd[f'views.{view}.{name}.weight']    # (cin, cout, s, s)
            np.testing.assert_array_equal(w[:, :, 0, s - 1],
                                          k[s - 1, 0])
    extra = dict(v['params'], view_cartesian=dict(
        v['params']['view_cartesian'], res4={'kernel': np.zeros(3)}))
    with pytest.raises(KeyError, match='res4'):
        jax_variables_to_torch({'params': _wrap(extra),
                                'batch_stats': _wrap(v['batch_stats'])})
    with pytest.raises(KeyError, match='res4'):
        jax_grads_to_torch(_wrap(extra))


# ------------------------------------------------------ TINY detector
@pytest.fixture(scope='module')
def tiny_variables():
    jd = jdet.PointPillarsDetector(model_cfg=TINY_MVF, head_cfg=TINY_HEAD)
    batch = jdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                 pc_range=PCR)
    v = jax.jit(jd.init)(jax.random.PRNGKey(0), batch)
    return randomize(np_tree(v), np.random.RandomState(9))


def tiny_batch(seed=0):
    return {k: np.array(v) for k, v in jdet.synthetic_batch(
        batch_size=2, num_points=1024, num_gt=8, pc_range=PCR,
        seed=seed).items()}


def test_tiny_predict(tiny_variables):
    """The eval head maps and the predict (boxes, scores, labels, valid),
    the cls bias set so that about 0.1 % of the anchors clear the score
    threshold: NMS keeps some and fewer than ``max_num``."""
    v = copy.deepcopy(tiny_variables)
    jd = jdet.PointPillarsDetector(model_cfg=TINY_MVF, head_cfg=TINY_HEAD)
    batch = tiny_batch(1)
    bias = v['params']['bbox_head']['conv_cls']['bias']
    logits = np.asarray(jd.apply_eval(v, batch)[0]) - bias
    bias[:] = np.log(0.05 / 0.95) - np.quantile(logits, 0.999)
    td = tdet.PointPillarsDetector(TINY_MVF, TINY_HEAD, device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(v), strict=True)
    tb = {k: _t(a) for k, a in batch.items()}
    for w, g in zip(jax.jit(jd.apply_eval)(v, batch)[:3],
                    td.apply_eval(tb)[:3]):
        close(g, np.asarray(w), what='eval map')
    assert td.featmap_size == jd.featmap_size == (24, 32)
    want = [np.asarray(x) for x in jax.jit(jd.predict)(v, batch)]
    boxes, scores, labels, valid = [x.numpy() for x in td.predict(tb)]
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_array_equal(labels[valid], want[2][valid])
    assert valid.any() and not valid.all()
    close(scores[valid], want[1][valid], what='scores')
    close(boxes[valid], want[0][valid], what='boxes')


def jax_step(jd, v, batch):
    """JAX's TINY MVF train step: (total, loss terms, gradients as port
    names, new running statistics as a port state_dict).

    The trunk after the encoder, the head and the loss run under jit, as
    JAX's train step runs them.  The encoder's gradients are its VJP run op
    by op, fed the jitted gradient of the loss at the pillar features (the
    encoder intercepted there): under jit, XLA on the CPU drops the voxel
    max's gradient from some voxel-channels of the unsorted segment max
    (``ops/scatter.py::_smax_fwd`` finds no winner for them: 61 of 3,178
    positive maxima of one TINY view net; ROADMAP section 3), so the
    jitted step's encoder gradients are not the function's."""
    points = jnp.asarray(batch['points'])
    mask = jnp.asarray(batch['points_mask'])

    def f(params):
        outs, stats = jd.apply_train(
            {'params': params, 'batch_stats': v['batch_stats']}, batch)
        total, losses = jd.loss(outs, batch)
        return total, (losses, stats)

    (total, (losses, stats)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(v['params'])
    enc = jmvf.PillarMVFFeatureNet(max_voxels=jd.model_cfg[
        'max_voxels_per_sample'] * points.shape[0],
        **jd.model_cfg['encoder_cfg'])
    enc_stats = v['batch_stats']['voxel_encoder']

    def encode(params):
        return enc.apply({'params': params, 'batch_stats': enc_stats},
                         points, mask, train=True,
                         mutable=['batch_stats'])[0]

    pillar, coords, grid = encode(v['params']['voxel_encoder'])

    def after_encoder(pillar):
        def at_encoder(call, args, kwargs, context):
            if isinstance(context.module, jmvf.PillarMVFFeatureNet):
                return pillar, coords, grid
            return call(*args, **kwargs)
        with fnn.intercept_methods(at_encoder):
            outs, _ = jd.apply_train(v, batch)
        return jd.loss(outs, batch)[0]

    g_pillar = jax.jit(jax.grad(after_encoder))(pillar)
    _, vjp = jax.vjp(lambda p: encode(p)[0], v['params']['voxel_encoder'])
    grads = dict(np_tree(grads), voxel_encoder=np_tree(vjp(g_pillar)[0]))
    strides = jd.model_cfg['neck_cfg']['upsample_strides']
    return (float(total), {k: float(x) for k, x in losses.items()},
            jax_grads_to_torch(grads, strides),
            jax_variables_to_torch({'params': v['params'],
                                    'batch_stats': np_tree(stats)},
                                   strides))


@pytest.fixture(scope='module')
def step_variables():
    """JAX's TINY MVF initial parameters (the focal prior on the cls
    bias, so the losses stay near their working range) and its BN running
    statistics redrawn."""
    jd = jdet.PointPillarsDetector(model_cfg=TINY_MVF, head_cfg=TINY_HEAD)
    v = np_tree(jax.jit(jd.init)(jax.random.PRNGKey(0), tiny_batch(2)))
    return dict(params=v['params'], batch_stats=randomize(
        v['batch_stats'], np.random.RandomState(10)))


@pytest.fixture(scope='module', params=['dense', 'sparse'])
def step_pair(request, step_variables):
    """One TINY MVF train step (dense targets: ``pos_cap=0``, the decoded
    loss through K3's plain version; sparse: ``pos_cap=1024``) from both
    packages on the same weights and batch: loss terms, gradients and the
    new running statistics."""
    hc = dict(TINY_HEAD, pos_cap=0 if request.param == 'dense' else 1024)
    v = step_variables
    batch = tiny_batch(2)
    total, losses, grads, state = jax_step(
        jdet.PointPillarsDetector(model_cfg=TINY_MVF, head_cfg=hc), v, batch)
    want = dict(total=total, losses=losses, grads=grads, state=state)
    td = tdet.PointPillarsDetector(TINY_MVF, hc, device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(v), strict=True)
    tb = {k: _t(a) for k, a in batch.items()}
    total_t, losses_t = td.loss(td.apply_train(tb), tb)
    params = dict(td.trunk.named_parameters())
    grads_t = torch.autograd.grad(total_t, list(params.values()))
    got = dict(total=float(total_t.detach()),
               losses={k: float(x.detach()) for k, x in losses_t.items()},
               grads=dict(zip(params, grads_t)),
               state=td.trunk.state_dict())
    return want, got


def test_tiny_step_losses(step_pair):
    want, got = step_pair
    assert set(got['losses']) == set(want['losses']) == {
        'loss_cls', 'loss_bbox', 'loss_dir'}
    for k, x in want['losses'].items():
        assert x > 0, k
        np.testing.assert_allclose(got['losses'][k], x, rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(got['total'], want['total'], rtol=LOSS_RTOL)


def test_tiny_step_gradients(step_pair):
    want, got = step_pair
    assert any(k.startswith('voxel_encoder.views.cylindrical.')
               for k in want['grads'])
    grads_close({k: g.numpy() for k, g in got['grads'].items()},
                {k: g.numpy() for k, g in want['grads'].items()})


def test_tiny_step_running_stats(step_pair):
    want, got = step_pair
    keys = [k for k in want['state'] if 'running_' in k]
    # the encoder's 21 BatchNorms, SECOND's 6 and the neck's 3
    assert len(keys) == 2 * (21 + 6 + 3)
    for k in keys:
        close(got['state'][k], want['state'][k].numpy(), what=k)
