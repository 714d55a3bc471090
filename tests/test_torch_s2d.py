"""The space-to-depth (s2d) canvas of the PyTorch port vs the JAX package on
the CPU, in f32.

* K7 and the s2d splat: the port's plain pair splat, ``bev_scatter_s2d``
  and their gradients against the JAX package's ``_splat_pairs`` (its XLA
  path here) and ``bev_splat_pairs_pallas`` in interpret mode, in f32 and
  bf16.  The splat is a placement, so outputs and gradients are equal.
* The folded stage 0: ``fold_s2d_kernel`` equal to JAX's, and ``SECOND``
  with ``input_s2d`` against JAX's in training and eval, with the W-folded
  stage 0 on or off in JAX (the port computes both through the plain
  stage 0).
* The TINY model with ``s2d_canvas='on'`` on both sides: voxel coords,
  pillar rows and canvas, head maps and detections of a predict, and one
  train step's loss terms, gradients and running statistics, at the f32
  tolerances of ``tests/test_torch_predict.py`` and
  ``tests/test_torch_train.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu.engine import detector as jdet
from mmdet3d_gaussian_tpu.models import backbones as jbb
from mmdet3d_gaussian_tpu.ops import scatter as jscatter
from mmdet3d_gaussian_tpu.ops import voxelize as jvox
from mmdet3d_gaussian_tpu.ops.pallas.bev_splat_kernel import \
    bev_splat_pairs_pallas

from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.models import backbones as tbb
from mmdet3d_gaussian_tpu_torch.ops import voxelize as tvox
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

from .test_torch_train import (GRAD_RTOL, TINY_HEAD, TINY_MODEL, _batch,
                               _np_tree, _t, randomize)

torch.set_num_threads(2)

S2D_MODEL = dict(TINY_MODEL, s2d_canvas='on')
DTYPES = {'f32': (torch.float32, jnp.float32),
          'bf16': (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    """torch or JAX array -> numpy f32 (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------ K7, the s2d splat
def _pairs_case(ncell2, v=2048, c=60, npairs=300, nsingle=200, past=40,
                seed=0):
    """Sorted rows: ``npairs`` paired cells with both parities,
    ``nsingle`` with one, ``past`` rows with ids at or past ``ncell2``
    (dropped), the rest sentinel rows."""
    rng = np.random.RandomState(seed)
    cells = np.sort(rng.choice(ncell2, npairs + nsingle, replace=False))
    lin2 = np.full(v, ncell2 + 7, np.int32)
    par = np.zeros(v, np.int32)
    i = 0
    for k, cell in enumerate(cells):
        for p in ((0, 1) if k < npairs else (rng.randint(2),)):
            lin2[i], par[i] = cell, p
            i += 1
    lin2[i:i + past] = ncell2 + np.arange(past) // 2
    par[i:i + past] = np.arange(past) % 2
    order = np.argsort(lin2.astype(np.int64) * 2 + par, kind='stable')
    feats = rng.randn(v, c).astype(np.float32)
    return feats, lin2[order], par[order]


SPLAT_CASES = {'divisible': dict(ncell2=2048), 'ragged': dict(ncell2=2148,
                                                               seed=2)}


@pytest.mark.parametrize('case', SPLAT_CASES)
@pytest.mark.parametrize('dtype', DTYPES)
def test_splat_pairs_matches_jax(case, dtype):
    """Plain K7 (the CPU side of ``bev_splat_pairs``) equal to the TPU
    kernel in interpret mode and to JAX's ``_splat_pairs``; its gradient
    (fill-gather plus half select) equal to JAX's VJP."""
    tdt, jdt = DTYPES[dtype]
    feats, lin2, par = _pairs_case(**SPLAT_CASES[case])
    ncell2 = SPLAT_CASES[case]['ncell2']
    jf = jnp.asarray(feats).astype(jdt)
    want_k7 = bev_splat_pairs_pallas(jf, jnp.asarray(lin2), jnp.asarray(par),
                                     ncell2, jdt, True)
    want = jvox._splat_pairs(jf, jnp.asarray(lin2), jnp.asarray(par), ncell2,
                             True)
    tf = _t(feats).to(tdt).requires_grad_(True)
    got = tvox._SplatPairs.apply(tf, _t(lin2), _t(par), ncell2)
    assert got.dtype == tdt and want.dtype == want_k7.dtype == jdt
    np.testing.assert_array_equal(_np(got), _np(want_k7))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(
        _np(tvox.bev_splat_pairs(tf.detach(), _t(lin2), _t(par), ncell2)),
        _np(want))
    assert np.count_nonzero(_np(got)) == (2 * 300 + 200) * 60

    w = np.random.RandomState(5).randn(ncell2, 120).astype(np.float32)
    jg = jax.grad(lambda f: jnp.sum(
        jvox._splat_pairs(f, jnp.asarray(lin2), jnp.asarray(par), ncell2,
                          True).astype(jnp.float32) * w))(jf)
    (tg,) = torch.autograd.grad((got.float() * _t(w)).sum(), tf)
    assert tg.dtype == tdt
    np.testing.assert_array_equal(_np(tg), _np(jg))
    assert np.count_nonzero(_np(tg)[lin2 >= ncell2]) == 0


def _s2d_rows(seed, b=2, ny2=9, nx2=7, c=12, v=300):
    """(feats, coords_s2d) like build_scatter's output on the s2d key:
    live rows in (b, cy, cx, parity) raster order, then -1 rows."""
    rng = np.random.RandomState(seed)
    n_cells = b * ny2 * nx2 * 4
    keys = np.sort(rng.choice(n_cells, v - 40, replace=False))
    coords = np.full((v, 4), -1, np.int32)
    coords[:v - 40] = np.stack(np.unravel_index(keys, (b, ny2, nx2, 4)), 1)
    return rng.randn(v, c).astype(np.float32), coords, (b, nx2, ny2)


@pytest.mark.parametrize('dtype', DTYPES)
def test_bev_scatter_s2d_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    feats, coords, (b, nx2, ny2) = _s2d_rows(1)
    jf = jnp.asarray(feats).astype(jdt)
    want = jvox.bev_scatter_s2d(jf, jnp.asarray(coords), b, nx2, ny2)
    tf = _t(feats).to(tdt).requires_grad_(True)
    got = tvox.bev_scatter_s2d(tf, _t(coords), b, nx2, ny2)
    assert got.shape == want.shape == (b, ny2, nx2, 48)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), _np(want))
    # the pillar at (b, iy, ix) sits in channel block (iy & 1) * 2 + (ix & 1)
    r = 17
    bb, cy, cx, p = coords[r]
    np.testing.assert_array_equal(_np(got)[bb, cy, cx, p * 12:p * 12 + 12],
                                  _np(tf)[r])

    w = np.random.RandomState(2).randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda f: jnp.sum(jvox.bev_scatter_s2d(
        f, jnp.asarray(coords), b, nx2, ny2).astype(jnp.float32) * w))(jf)
    (tg,) = torch.autograd.grad((got.float() * _t(w)).sum(), tf)
    np.testing.assert_array_equal(_np(tg), _np(jg))


# ---------------------------------------------------------- folded stage 0
def test_fold_s2d_kernel_matches_jax():
    """Port fold of the OIHW weight equal to JAX's fold of the HWIO one,
    and the folded conv on the s2d input equal to the stride-2 conv on the
    plain input."""
    rng = np.random.RandomState(0)
    w_hwio = rng.randn(3, 3, 5, 7).astype(np.float32)
    want = np.asarray(jbb.fold_s2d_kernel(jnp.asarray(w_hwio)))
    got = tbb.fold_s2d_kernel(_t(w_hwio.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))

    x = _t(rng.randn(2, 5, 16, 12).astype(np.float32))          # NCHW
    conv = tbb.S2DDownConv(5, 7, 3, stride=2, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(_t(w_hwio.transpose(3, 2, 0, 1)))
    b, c, h, wd = x.shape
    xs = x.reshape(b, c, h // 2, 2, wd // 2, 2).permute(0, 3, 5, 1, 2, 4)
    xs = xs.reshape(b, 4 * c, h // 2, wd // 2)
    ref = torch.nn.functional.conv2d(x, conv.weight, stride=2, padding=1)
    torch.testing.assert_close(conv(xs), ref, rtol=1e-5, atol=1e-5)


def _jax_second(fold_w2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 8, 10, 4 * 6).astype(np.float32)      # s2d of 16 x 20
    mod = jbb.SECOND(in_channels=6, out_channels=(8, 12), layer_nums=(2, 1),
                     layer_strides=(2, 2), input_s2d=True, fold_w2=fold_w2)
    variables = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    variables = randomize(_np_tree(variables), rng)
    return mod, variables, x


@pytest.mark.parametrize('fold_w2', [False, True], ids=['s2d', 's2d_w2'])
@pytest.mark.parametrize('mode', ['train', 'eval'])
def test_second_s2d_matches_jax(mode, fold_w2):
    """SECOND(input_s2d=True) with the same weights: every stage's map and,
    in training, the new running statistics."""
    mod, variables, x = _jax_second(fold_w2)
    train = mode == 'train'
    if train:
        want, upd = mod.apply(variables, jnp.asarray(x), train=True,
                              mutable=['batch_stats'])
    else:
        want = mod.apply(variables, jnp.asarray(x), train=False)
    sd = jax_variables_to_torch({'params': {'backbone': variables['params']},
                                 'batch_stats': {
                                     'backbone': variables['batch_stats']}})
    port = tbb.SECOND(in_channels=6, out_channels=(8, 12), layer_nums=(2, 1),
                      layer_strides=(2, 2), input_s2d=True, fold_w2=fold_w2)
    port.load_state_dict({k[len('backbone.'):]: v for k, v in sd.items()},
                         strict=True)
    port.train(train)
    got = port(_t(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    if train:
        sd_new = jax_variables_to_torch({
            'params': {'backbone': variables['params']},
            'batch_stats': {'backbone': _np_tree(upd['batch_stats'])}})
        for k, v in port.state_dict().items():
            if 'running_' in k:
                np.testing.assert_allclose(v.numpy(),
                                           sd_new['backbone.' + k].numpy(),
                                           rtol=0, atol=1e-5, err_msg=k)


def test_state_dict_keys_same_with_s2d_on_and_off():
    on = tdet.PointPillarsDetector(S2D_MODEL, TINY_HEAD, device='cpu')
    off = tdet.PointPillarsDetector(dict(TINY_MODEL, s2d_canvas='off'),
                                    TINY_HEAD, device='cpu')
    auto = tdet.PointPillarsDetector(TINY_MODEL, TINY_HEAD, device='cpu')
    assert on.trunk.s2d and auto.trunk.s2d and not off.trunk.s2d
    sd_on, sd_off = on.trunk.state_dict(), off.trunk.state_dict()
    assert list(sd_on) == list(sd_off)
    assert all(sd_on[k].shape == sd_off[k].shape for k in sd_on)
    assert sd_on['backbone.blocks.0.0.weight'].shape == (16, 16, 3, 3)


# ------------------------------------------------- the TINY s2d model, f32
def _jax_s2d_scatter(batch, det):
    """Voxel coords of the JAX dynamic s2d branch
    (``models/detectors/voxelnet.py``), from the JAX package's ops."""
    mc = det.model_cfg
    pts = jnp.asarray(batch['points'])
    b, n, c = pts.shape
    nx, ny = det.trunk._grid()
    flat = pts.reshape(b * n, c)
    coords3, _ = jscatter.compute_voxel_coords(
        flat[:, :3], mc['point_cloud_range'], mc['voxel_size'])
    coords3 = jnp.where(jnp.asarray(batch['points_mask']).reshape(-1, 1),
                        coords3, -1)
    coords4 = jscatter.batch_coords(
        coords3, jnp.repeat(jnp.arange(b, dtype=jnp.int32), n))
    iy, ix = coords4[:, 2], coords4[:, 1]
    cols = jnp.stack([coords4[:, 0], iy // 2, ix // 2,
                      (iy & 1) * 2 + (ix & 1)], axis=1)
    coords4 = jnp.where(jnp.any(coords4 < 0, axis=-1)[:, None], -1, cols)
    return jscatter.build_scatter(coords4, (b, ny // 2, nx // 2, 4),
                                  mc['max_voxels_per_sample'] * b)


@pytest.fixture(scope='module')
def predict_pair():
    det = jdet.PointPillarsDetector(model_cfg=S2D_MODEL, head_cfg=TINY_HEAD)
    batch = jdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                 pc_range=TINY_MODEL['point_cloud_range'])
    variables = jax.jit(det.init)(jax.random.PRNGKey(0), batch)
    variables = randomize(variables, np.random.RandomState(0))
    maps = jax.jit(det.apply_eval)(variables, batch)
    dets = jax.jit(jax.vmap(det.head.get_bboxes, in_axes=(0, 0, 0, None)))(
        maps[0], maps[1], maps[2], det.anchors)
    _, inter = det.trunk.apply(
        variables, batch['points'], batch['points_mask'], train=False,
        capture_intermediates=lambda mdl, _: mdl.name == 'voxel_encoder')
    pillars = inter['intermediates']['voxel_encoder']['__call__'][0]
    scatter = _jax_s2d_scatter(batch, det)
    nx, ny = det.trunk._grid()
    canvas = jvox.bev_scatter_s2d(pillars, scatter.voxel_coords, 2, nx // 2,
                                  ny // 2)
    want = dict(maps=[np.asarray(m) for m in maps[:4]],
                dets=[np.asarray(d) for d in dets],
                pillars=np.asarray(pillars),
                coords=np.asarray(scatter.voxel_coords),
                canvas=np.asarray(canvas))

    port = tdet.PointPillarsDetector(S2D_MODEL, TINY_HEAD, device='cpu')
    port.trunk.load_state_dict(jax_variables_to_torch(variables),
                               strict=True)
    tb = _batch()
    with torch.inference_mode():
        feats, coords, _ = port.trunk.pillars(tb['points'],
                                              tb['points_mask'])
        canvas = tvox.bev_scatter_s2d(feats, coords, 2, port.trunk.nx // 2,
                                      port.trunk.ny // 2)
    got = dict(maps=[m.numpy() for m in port.apply_eval(tb)],
               dets=[d.numpy() for d in port.predict(tb)],
               pillars=feats.numpy(), coords=coords.numpy(),
               canvas=canvas.numpy())
    return want, got


def test_s2d_predict_voxels_and_canvas(predict_pair):
    want, got = predict_pair
    np.testing.assert_array_equal(got['coords'], want['coords'])
    live = (want['coords'] >= 0).all(-1)
    assert live.sum() > 1000 and set(want['coords'][live, 3]) == {0, 1, 2, 3}
    np.testing.assert_allclose(got['pillars'], want['pillars'], rtol=1e-5,
                               atol=1e-5)
    assert got['canvas'].shape == want['canvas'].shape == (2, 32, 32, 64)
    np.testing.assert_allclose(got['canvas'], want['canvas'], rtol=1e-5,
                               atol=1e-5)


def test_s2d_predict_maps_and_detections(predict_pair):
    want, got = predict_pair
    for g, w, name in zip(got['maps'], want['maps'],
                          ('cls', 'bbox', 'dir', 'packed')):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)
    g, w = got['dets'], want['dets']
    assert g[3].sum() >= 10
    np.testing.assert_array_equal(g[3], w[3])
    np.testing.assert_array_equal(g[2][g[3]], w[2][w[3]])
    np.testing.assert_allclose(g[1][g[3]], w[1][w[3]], atol=1e-5)
    np.testing.assert_allclose(g[0][g[3]], w[0][w[3]], atol=1e-4)


@pytest.fixture(scope='module')
def step_pair():
    """One sparse-target train step of the s2d model on both sides."""
    jd = jdet.PointPillarsDetector(model_cfg=S2D_MODEL, head_cfg=TINY_HEAD)
    jbatch = jdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                  pc_range=TINY_MODEL['point_cloud_range'])
    variables = jax.jit(jd.init)(jax.random.PRNGKey(0), jbatch)
    variables = randomize(variables, np.random.RandomState(0))

    def f(params):
        outs, stats = jd.apply_train(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jbatch)
        total, losses = jd.loss(outs, jbatch)
        return total, (losses, stats)

    (_, (losses, stats)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(variables['params'])
    want = dict(losses={k: float(v) for k, v in losses.items()},
                grads=jax_grads_to_torch(_np_tree(grads)),
                state=jax_variables_to_torch(
                    {'params': variables['params'],
                     'batch_stats': _np_tree(stats)}))
    td = tdet.PointPillarsDetector(S2D_MODEL, TINY_HEAD, device='cpu')
    td.trunk.load_state_dict(jax_variables_to_torch(variables), strict=True)
    batch = _batch()
    total_t, losses_t = td.loss(td.apply_train(batch), batch)
    params = dict(td.trunk.named_parameters())
    grads_t = torch.autograd.grad(total_t, list(params.values()))
    got = dict(losses={k: float(v.detach()) for k, v in losses_t.items()},
               grads=dict(zip(params, grads_t)), state=td.trunk.state_dict())
    return want, got


def test_s2d_train_step_losses(step_pair):
    want, got = step_pair
    assert set(got['losses']) == set(want['losses'])
    for k, v in want['losses'].items():
        np.testing.assert_allclose(got['losses'][k], v, rtol=1e-5, err_msg=k)


def test_s2d_train_step_gradients(step_pair):
    want, got = step_pair
    assert set(got['grads']) == set(want['grads'])
    for k, w in want['grads'].items():
        scale = float(w.abs().max())
        assert scale > 0, k
        np.testing.assert_allclose(got['grads'][k].numpy(), w.numpy(),
                                   rtol=0, atol=GRAD_RTOL * scale, err_msg=k)


def test_s2d_train_step_running_stats(step_pair):
    want, got = step_pair
    keys = [k for k in want['state'] if 'running_' in k]
    assert len(keys) == 2 * (1 + 6 + 3)
    for k in keys:
        np.testing.assert_allclose(got['state'][k].numpy(),
                                   want['state'][k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
