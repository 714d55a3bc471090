"""The PyTorch port of MVX (image branch, point fusion, the image-painted
pillar trunk, predict) against the JAX package on the CPU.

Inputs come from numpy seeds, weights from the JAX modules' ``init`` (BN
statistics, scales and biases redrawn) carried over by
``jax_variables_to_torch``.  The projection's ``uv`` is held within 1e-5
(pixels; f32 rounding of a 4 x 4 product and a division at ~100 pixels)
and ``valid`` equal; the bilinear sample within 1e-6 and its gradient (the
JAX VJP) within 1e-6; the image branch's maps, its input gradient and its
parameters' gradients within 1e-5 (maps) and 1e-4 (gradients) of each
tensor's largest magnitude (f32 convolutions summed in another order; the
gradients measured ~1.2e-5), running statistics within 1e-6;
head maps within 1e-5 of their largest magnitude; predicted boxes and
scores within 1e-5 of their scale, labels and ``valid`` equal.
"""
import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as fnn
import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu.engine import mvx as jmvx
from mmdet3d_gaussian_tpu.models import img_fusion as jif

from mmdet3d_gaussian_tpu_torch.engine import mvx as tmvx
from mmdet3d_gaussian_tpu_torch.models import img_fusion as tif
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

from .test_mvx_fusion import TINY_MVX, TINY_MVX_HEAD
from .test_torch_train import _np_tree, _t, randomize

torch.set_num_threads(2)

# 36 x 68: the stem gives 18 x 34, the pool 9 x 17 and stage 1 5 x 9, so
# the FPN crops its upsampled 10 x 18 level (odd sizes)
IMG_HW = (36, 68)
MAP_TOL = 1e-5
GRAD_TOL = 1e-4     # of each gradient's largest magnitude


def jax_batch():
    return jmvx.synthetic_mvx_batch(
        batch_size=2, num_points=1024, num_gt=8, img_hw=IMG_HW,
        pc_range=TINY_MVX['point_cloud_range'])


def port_batch(device='cpu'):
    return tmvx.synthetic_mvx_batch(
        batch_size=2, num_points=1024, num_gt=8, img_hw=IMG_HW,
        pc_range=TINY_MVX['point_cloud_range'], device=device)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ------------------------------------------------------------ projection
CAM = np.array([[0., -1., 0., 0.], [0., 0., -1., 0.],
                [1., 0., 0., 0.], [0., 0., 0., 1.]], np.float32)
K = np.array([[100., 0., 32., 0.], [0., 100., 24., 0.],
              [0., 0., 1., 0.], [0., 0., 0., 1.]], np.float32)
H, W = 48, 64


def _at_pixel(u, v, depth):
    """LiDAR point that the pinhole K @ CAM maps to pixel (u, v)."""
    return [depth, -(u - 32.) * depth / 100., -(v - 24.) * depth / 100.]


PROJ_CASES = {
    'front': [_at_pixel(u, v, d) for u, v, d in
              ((32, 24, 10.), (5.5, 40.25, 3.), (60., 3., 25.))],
    'behind': [[-5., 0., 0.], [0., 0., 0.], [-1e-6, 2., 1.],
               [-30., -40., 2.]],
    'off_each_edge': [_at_pixel(u, v, 8.) for u, v in
                      ((-0.5, 20), (W - 0.5, 20), (30, -0.5),
                       (30, H - 0.5), (-3, -3), (W + 2, H + 2))],
    'near_edges': [_at_pixel(u, v, 12.) for u, v in
                   ((0.01, 20), (W - 1.01, 20), (30, 0.01),
                    (30, H - 1.01), (0.02, 0.02), (W - 1.02, H - 1.02))],
}


@pytest.mark.parametrize('case', list(PROJ_CASES))
def test_projection_matches_jax(case):
    pts = np.asarray(PROJ_CASES[case], np.float32)
    l2i = K @ CAM
    uv_j, valid_j = jif.project_points_to_img(jnp.asarray(pts),
                                              jnp.asarray(l2i), (H, W))
    uv_t, valid_t = tif.project_points_to_img(_t(pts), _t(l2i), (H, W))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    want = {'front': True, 'behind': False, 'off_each_edge': False,
            'near_edges': True}[case]
    assert bool(np.all(np.asarray(valid_j) == want))


def test_projection_batched_random():
    """(B, N, 3) points through (B, 4, 4) matrices: JAX's vmap."""
    rng = np.random.RandomState(0)
    pts = rng.uniform([-10, -20, -3], [40, 20, 2], (3, 500, 3)).astype(
        np.float32)
    l2i = np.stack([K @ CAM, 0.5 * K @ CAM, K @ CAM]).astype(np.float32)
    uv_j, valid_j = jax.vmap(lambda p, m: jif.project_points_to_img(
        p, m, (H, W)))(jnp.asarray(pts), jnp.asarray(l2i))
    uv_t, valid_t = tif.project_points_to_img(_t(pts), _t(l2i), (H, W))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    v = np.asarray(valid_j)
    assert 0 < v.mean() < 1
    np.testing.assert_allclose(uv_t.numpy()[v], np.asarray(uv_j)[v], rtol=0,
                               atol=1e-5)
    # off the image, a point a few cm in front of the camera divides a
    # cancelling sum (its rounding ~1e-7 of the terms) by its depth
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------------ bilinear sample
def _uv_case(case, h, w, rng, n=200):
    if case == 'interior':
        return rng.uniform([0, 0], [w - 1, h - 1], (n, 2))
    if case == 'clamped':       # off every edge and corner
        return np.concatenate([
            rng.uniform([-5, -5], [w + 5, h + 5], (n, 2)),
            [[-2., -3.], [w + 4., -1.], [-1., h + 2.], [w + 3., h + 3.]]])
    # on the far edges (x0 = w - 2 with dx = 1), the near ones, and at
    # integer pixels
    return np.asarray([[w - 1, 3.5], [2.25, h - 1], [w - 1, h - 1],
                       [0., 1.5], [1.5, 0.], [0., 0.], [2., 3.]])


def _jax_vjp(fn, g, *args):
    """(fn(*args), its VJP at cotangent g), jitted."""
    @jax.jit
    def run(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(g)
    return run(*[jnp.asarray(a) for a in args])


@pytest.mark.parametrize('case', ['interior', 'clamped', 'edges_dx1'])
def test_bilinear_sample_matches_jax(case):
    rng = np.random.RandomState(1)
    h, w, c = 7, 9, 5
    feat = rng.randn(h, w, c).astype(np.float32)
    uv = _uv_case(case, h, w, rng).astype(np.float32)
    g = rng.randn(uv.shape[0], c).astype(np.float32)
    out_j, (df_j, duv_j) = _jax_vjp(jif.bilinear_sample_img, g, feat, uv)
    ft, ut = _t(feat).requires_grad_(True), _t(uv).requires_grad_(True)
    out_t = tif.bilinear_sample_img(ft, ut)
    df_t, duv_t = torch.autograd.grad(out_t, [ft, ut], _t(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(df_t.numpy(), np.asarray(df_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(duv_t.numpy(), np.asarray(duv_j), rtol=0,
                               atol=1e-5)
    if case == 'edges_dx1':     # x = w - 1 reads column w - 1 alone
        np.testing.assert_allclose(out_t[0].detach().numpy(),
                                   feat[3, w - 1] * 0.5 + feat[4, w - 1]
                                   * 0.5, rtol=1e-6)


def test_bilinear_sample_batched():
    """Batched maps: each sample's points read its own map; the values and
    the gradient into the maps equal JAX's vmapped sample and its VJP."""
    rng = np.random.RandomState(2)
    b, h, w, c = 2, 6, 11, 3
    feat = rng.randn(b, h, w, c).astype(np.float32)
    uv = rng.uniform([-2, -2], [w + 1, h + 1], (b, 80, 2)).astype(np.float32)
    g = rng.randn(b, 80, c).astype(np.float32)
    out_j, (df_j, _) = _jax_vjp(jax.vmap(jif.bilinear_sample_img), g, feat,
                                uv)
    ft = _t(feat).requires_grad_(True)
    out_t = tif.bilinear_sample_img(ft, _t(uv))
    (df_t,) = torch.autograd.grad(out_t, [ft], _t(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(df_t.numpy(), np.asarray(df_j), rtol=0,
                               atol=1e-6)


# ------------------------------------------------ backbone, FPN, pooling
def test_max_pool_tie_gradient_matches_jax():
    """Windows full of equal values: both send the gradient to the first
    maximum in window order."""
    rng = np.random.RandomState(3)
    x = rng.randint(0, 3, (2, 9, 11, 4)).astype(np.float32)

    def pool(v):
        return fnn.max_pool(v, (3, 3), strides=(2, 2),
                            padding=((1, 1), (1, 1)))
    g = rng.randn(*pool(jnp.asarray(x)).shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda v: jnp.sum(pool(v) * g)))(
        jnp.asarray(x))
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = torch.nn.functional.max_pool2d(xt, 3, stride=2, padding=1)
    (got,) = torch.autograd.grad(y, [xt], _t(g).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


BRANCH = dict(stage_channels=(8, 16, 32), blocks_per_stage=2)
BRANCH_NECK = 8
# image sizes: even levels (32 x 64: 8 x 16, 4 x 8, 2 x 4) and odd ones
# (36 x 68: 9 x 17, 5 x 9, 3 x 5; the FPN crops twice)
BRANCH_SIZES = {'even': (32, 64), 'odd': IMG_HW}


class _Branch(nn.Module):
    def __init__(self):
        super().__init__()
        self.img_backbone = tif.ImgBackbone(**BRANCH)
        self.img_neck = tif.ImgFPNNeck(BRANCH['stage_channels'], BRANCH_NECK)

    def forward(self, img):
        return self.img_neck(self.img_backbone(img))


def _tied_image(hw, seed):
    """Random pixels with two constant patches: inside them the stem's
    output is one value a channel, so the max pool's windows there tie."""
    rng = np.random.RandomState(seed)
    img = rng.rand(2, *hw, 3).astype(np.float32)
    img[0, 4:24, 6:40] = [0.9, 0.1, 0.5]
    img[1, 10:30, 20:60] = [0.2, 0.8, 0.7]
    return img


@pytest.fixture(scope='module', params=list(BRANCH_SIZES))
def branch_runs(request):
    """The image branch (backbone + FPN) of JAX and of the port on one
    weight set and a tied image: eval maps, and in training the maps, new
    running statistics and the gradients of a weighted sum of the maps."""
    hw = BRANCH_SIZES[request.param]
    img = _tied_image(hw, 4)
    bb, neck = jif.ImgBackbone(**BRANCH), jif.ImgFPNNeck(BRANCH_NECK)

    def run(v, x, train):
        (feats, s1) = bb.apply(v['img_backbone'], x, train=train,
                               mutable=['batch_stats'])
        return neck.apply(v['img_neck'], feats), s1
    x = jnp.asarray(img)
    v_bb = jax.jit(bb.init)(jax.random.PRNGKey(0), x)
    v_neck = jax.jit(neck.init)(jax.random.PRNGKey(1),
                                jax.jit(bb.apply)(v_bb, x))
    rng = np.random.RandomState(5)
    v_bb, v_neck = randomize(_np_tree(v_bb), rng), randomize(
        _np_tree(v_neck), rng)
    variables = {'img_backbone': v_bb, 'img_neck': v_neck}
    maps_eval = jax.jit(lambda v, x: run(v, x, False)[0])(variables, x)
    ws = [rng.randn(*m.shape).astype(np.float32) for m in maps_eval]

    def loss(params, x):
        v = {'img_backbone': {'params': params['img_backbone'],
                              'batch_stats': v_bb['batch_stats']},
             'img_neck': {'params': params['img_neck']}}
        maps, stats = run(v, x, True)
        return sum(jnp.sum(m * w) for m, w in zip(maps, ws)), (maps, stats)
    params = {k: variables[k]['params'] for k in variables}
    (_, (maps, stats)), (grads, gimg) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    tree = {'params': params,
            'batch_stats': {'img_backbone': v_bb['batch_stats']}}
    port = _Branch()
    port.load_state_dict(jax_variables_to_torch(tree), strict=True)
    port.eval()
    with torch.no_grad():
        got_eval = port(_t(img))
    port.train()
    xt = _t(img).requires_grad_(True)
    got = port(xt)
    named = dict(port.named_parameters())
    total = sum((m * _t(w)).sum() for m, w in zip(got, ws))
    tg = torch.autograd.grad(total, [xt] + list(named.values()))
    state = {k: v.clone() for k, v in port.state_dict().items()}
    stem = torch.relu(port.img_backbone.stem_bn(port.img_backbone.stem(
        _t(img).permute(0, 3, 1, 2))))
    new_stats = jax_variables_to_torch(
        {'params': params, 'batch_stats': {'img_backbone': _np_tree(
            stats['batch_stats'])}})
    return dict(
        eval=([np.asarray(m) for m in maps_eval], got_eval),
        train=([np.asarray(m) for m in maps], got),
        img_grad=(np.asarray(gimg), tg[0]),
        grads=(jax_grads_to_torch(_np_tree(grads)), dict(zip(named, tg[1:]))),
        stats=(new_stats, state), stem=stem.detach(), hw=hw)


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_img_branch_maps(branch_runs, mode):
    want, got = branch_runs[mode]
    assert len(got) == 3
    h, w = branch_runs['hw']
    for i, (g, wv) in enumerate(zip(got, want)):
        assert tuple(g.shape) == wv.shape
        assert wv.shape[0] == 2 and wv.shape[3] == BRANCH_NECK
        err = _rel(g.detach().numpy(), wv)
        assert err <= MAP_TOL, (i, err)
    # strides 4, 8, 16 of the image (rounded up at each stride-2 step)
    assert want[0].shape[1:3] == (-(-h // 4), -(-w // 4))


def test_img_branch_running_stats(branch_runs):
    want, got = branch_runs['stats']
    keys = [k for k in want if 'running_' in k]
    # stem, 3 stages x 2 blocks x 2, and bn_down in stages 1 and 2
    assert len(keys) == 2 * (1 + 12 + 2)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_img_branch_gradients(branch_runs):
    want, got = branch_runs['grads']
    assert set(want) == set(got)
    for k, w in want.items():
        assert _rel(got[k].numpy(), w.numpy()) <= GRAD_TOL, k
    g_want, g_got = branch_runs['img_grad']
    assert _rel(g_got.numpy(), g_want) <= GRAD_TOL


def test_img_branch_stem_pool_ties(branch_runs):
    """The stem's ReLU output has windows of the max pool whose maximum is
    positive and taken more than once (so the gradient tests above cover
    the tie rule)."""
    stem = branch_runs['stem']
    win = torch.nn.functional.unfold(stem.reshape(-1, 1, *stem.shape[2:]),
                                     3, padding=1, stride=2)
    top = win.max(dim=1).values
    ties = ((win == top[:, None]).sum(1) > 1) & (top > 0)
    assert int(ties.sum()) > 50


def test_upsample2_crop_matches_repeat():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 3, 4).astype(np.float32)        # NHWC
    want = np.repeat(np.repeat(x, 2, 1), 2, 2)[:, :5, :7]
    got = tif.upsample2_crop(_t(x).permute(0, 3, 1, 2), 5, 7)
    assert got.stride(1) == 1
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# ---------------------------------------------------------------- fusion
def test_point_fusion_matches_jax():
    """Random FPN maps, points in front of, behind and beside the camera:
    the painted features (zero off the image) and their gradient into the
    maps."""
    rng = np.random.RandomState(7)
    hw, c = (48, 64), 6
    feats = [rng.randn(2, 12, 16, c).astype(np.float32),
             rng.randn(2, 6, 8, c).astype(np.float32)]
    pts = rng.uniform([-10, -20, -3], [40, 20, 2], (2, 300, 3)).astype(
        np.float32)
    l2i = np.stack([K @ CAM] * 2).astype(np.float32)
    mod = jif.PointFusion(out_channels=8, img_levels=(4, 8))
    args = [jnp.asarray(f) for f in feats], jnp.asarray(pts), \
        jnp.asarray(l2i)
    variables = randomize(_np_tree(jax.jit(
        lambda *a: mod.init(jax.random.PRNGKey(0), *a, hw))(*args)), rng)
    g = rng.randn(2, 300, 8).astype(np.float32)

    @jax.jit
    def run(fs):
        out, vjp = jax.vjp(lambda f: mod.apply(variables, f, *args[1:], hw),
                           fs)
        return out, vjp(jnp.asarray(g))[0]
    want, df_want = run(args[0])
    port = tif.PointFusion(c, 8, (4, 8))
    sd = jax_variables_to_torch({'params': {'fusion': variables['params']},
                                 'batch_stats': {}})
    port.load_state_dict({k[len('fusion.'):]: v for k, v in sd.items()},
                         strict=True)
    ft = [_t(f).requires_grad_(True) for f in feats]
    got = port(ft, _t(pts), _t(l2i), hw)
    df_got = torch.autograd.grad(got, ft, _t(g))
    valid = np.asarray(jif.project_points_to_img(
        jnp.asarray(pts[0]), jnp.asarray(l2i[0]), hw)[1])
    assert 0.2 < valid.mean() < 0.8
    assert np.abs(got[0].detach().numpy()[~valid]).max() == 0
    assert np.abs(got[0].detach().numpy()[valid]).max(-1).min() >= 0
    assert (np.abs(got[0].detach().numpy()[valid]).max(-1) > 0).mean() > 0.5
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    for a, b in zip(df_got, df_want):
        assert _rel(a.numpy(), np.asarray(b)) <= 1e-5


# ------------------------------------------------------------- converter
@pytest.fixture(scope='module')
def model_pair():
    """JAX's TINY MVX and the port on the same (redrawn) weights."""
    jd = jmvx.MVXDetector(model_cfg=TINY_MVX, head_cfg=TINY_MVX_HEAD)
    batch = jax_batch()
    variables = randomize(_np_tree(jax.jit(jd.init)(jax.random.PRNGKey(0),
                                                    batch)),
                          np.random.RandomState(0))
    td = tmvx.MVXDetector(TINY_MVX, TINY_MVX_HEAD, device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(variables), strict=True)
    return jd, variables, td, batch


@pytest.fixture(scope='module')
def predict_runs(model_pair):
    """Head maps and detections of JAX and of the port."""
    jd, variables, td, batch = model_pair
    b = port_batch()
    return dict(
        maps=([np.asarray(m) for m in jax.jit(jd.apply_eval)(variables,
                                                             batch)[:4]],
              td.apply_eval(b)[:4]),
        dets=([np.asarray(x) for x in jax.jit(jd.predict)(variables,
                                                          batch)],
              [x.numpy() for x in td.predict(b)]))


def test_converter_maps_every_mvx_leaf(model_pair):
    _, variables, td, _ = model_pair
    sd = jax_variables_to_torch(variables)
    assert set(sd) == set(td.trunk.state_dict())
    grads = jax_grads_to_torch(variables['params'])
    assert set(grads) == {k for k, _ in td.trunk.named_parameters()}
    for prefix in ('img_backbone.stage1_block0.bn_down',
                   'img_neck.fpn_out_1', 'fusion.fuse'):
        assert prefix + '.weight' in grads
    np.testing.assert_array_equal(
        sd['fusion.fuse.weight'].numpy(),
        np.asarray(variables['params']['fusion']['fuse']['kernel']).T)
    np.testing.assert_array_equal(
        sd['img_neck.lateral_0.weight'].numpy(), np.transpose(
            variables['params']['img_neck']['lateral_0']['kernel'],
            (3, 2, 0, 1)))


@pytest.mark.parametrize('where', ['img_backbone', 'img_neck', 'fusion'])
def test_converter_raises_on_unknown_mvx_leaf(model_pair, where):
    _, variables, _, _ = model_pair
    params = dict(variables['params'])
    params[where] = dict(params[where], extra=dict(kernel=np.zeros(3)))
    with pytest.raises(KeyError):
        jax_variables_to_torch({'params': params,
                                'batch_stats': variables['batch_stats']})


def test_registry_builds_mvx_modules():
    from mmdet3d_gaussian_tpu_torch.models.detectors import \
        mvx_faster_rcnn  # noqa: F401
    from mmdet3d_gaussian_tpu_torch.registry import MODELS
    for name in ('ImgBackbone', 'ImgFPNNeck', 'PointFusion',
                 'MVXPillarsNet'):
        assert name in MODELS
    neck = MODELS.build(dict(type='ImgFPNNeck', in_channels=(4, 8),
                             out_channels=6))
    assert neck.fpn_out_1.out_channels == 6
    trunk = MODELS.build(dict(type='MVXPillarsNet', **TINY_MVX))
    assert trunk.fusion.lateral_0.in_features == 8
    # 12 painted channels less xyz, plus the decoration's 9
    assert trunk.voxel_encoder.pfn_layers[0].linear.in_features == 18


# ----------------------------------------------------------------- model
def test_synthetic_mvx_batch_equals_jax():
    want, got = jax_batch(), port_batch()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_mvx_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError):
        tmvx.MVXDetector(TINY_MVX, TINY_MVX_HEAD)
    with pytest.raises(RuntimeError):
        tmvx.synthetic_mvx_batch(1, 16)


@pytest.mark.parametrize('i,name', enumerate(('cls', 'bbox', 'dir',
                                              'packed')))
def test_mvx_head_maps_eval(predict_runs, i, name):
    want, got = (m[i] for m in predict_runs['maps'])
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= MAP_TOL, _rel(got.numpy(), want)


def test_mvx_predict_matches_jax(predict_runs):
    want, got = predict_runs['dets']
    np.testing.assert_array_equal(got[3], want[3])
    assert want[3].sum() >= 5
    v = want[3]
    np.testing.assert_array_equal(got[2][v], want[2][v])
    scale = np.abs(want[0][v]).max()
    assert np.abs(got[0][v] - want[0][v]).max() <= 1e-5 * scale
    assert np.abs(got[1][v] - want[1][v]).max() <= 1e-5


def test_mvx_painted_points(model_pair):
    """The painted cloud: raw channels first, image channels zero exactly
    where the point projects off the image, and 40-70 % of the points on
    it."""
    _, _, td, _ = model_pair
    b = port_batch()
    with torch.no_grad():
        td.trunk.eval()
        painted = td.trunk.paint(b['points'], b['img'], b['lidar2img'])
    valid = tif.project_points_to_img(b['points'][..., :3], b['lidar2img'],
                                      IMG_HW)[1]
    assert painted.shape == (2, 1024, 4 + 8)
    assert torch.equal(painted[..., :4], b['points'])
    assert float(painted[..., 4:][~valid].abs().max()) == 0
    assert 0.4 < float(valid.float().mean()) < 0.7
