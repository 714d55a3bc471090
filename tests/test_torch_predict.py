"""The whole TINY PointPillars predict (dynamic voxelize) of the PyTorch
port vs the JAX package on the CPU, with the JAX weights (BN statistics,
scales and biases randomized first) carried over by
``jax_variables_to_torch``.

The JAX model runs with its defaults, which turn on the space-to-depth
canvas and the W-folded stage 0 for this config.  The port here runs the
plain canvas (``s2d_canvas='off'``, kernel K2), so its pillar rows are
compared against JAX built with ``s2d_canvas='off'`` (plain canvas order)
and everything after the canvas against JAX with its defaults.  The port's
s2d canvas is held to JAX's in ``tests/test_torch_s2d.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu.engine import detector as jdet

from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.models.detectors.voxelnet import \
    PointPillarsNet
from mmdet3d_gaussian_tpu_torch.models.voxel_encoders import (
    DynamicPillarFeatureNet, PillarFeatureNet, SortedPillarFeatureNet)
from mmdet3d_gaussian_tpu_torch.ops import rotated_iou as tiou
from mmdet3d_gaussian_tpu_torch.weights import (jax_grads_to_torch,
                                                jax_variables_to_torch)

torch.set_num_threads(2)

TINY_MODEL = dict(
    voxel_size=(0.4, 0.4, 4.0),
    point_cloud_range=(0., -12.8, -3., 25.6, 12.8, 1.),
    max_points_per_voxel=16,
    max_voxels_per_sample=1024,
    voxelize_mode='dynamic',
    encoder_cfg=dict(in_channels=4, feat_channels=(16,)),
    backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                      layer_nums=(1, 1, 1), layer_strides=(2, 2, 2)),
    neck_cfg=dict(in_channels=(16, 32, 64), out_channels=(16, 16, 16),
                  upsample_strides=(1, 2, 4)),
    head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=48),
)
TINY_HEAD = dict(test_cfg=dict(use_rotate_nms=True, nms_thr=0.01,
                               score_thr=0.05, nms_pre=128, max_num=32))


def randomize(tree, rng):
    """Redraw BN running stats, scales and biases (the cls bias loses its
    focal prior, so scores spread over the score threshold)."""
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


@pytest.fixture(scope='module')
def jax_run():
    """One JAX build for the file: variables, batch, head maps (defaults),
    pillar rows (s2d off) and detections."""
    det = jdet.PointPillarsDetector(model_cfg=TINY_MODEL, head_cfg=TINY_HEAD)
    batch = jdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                 pc_range=TINY_MODEL['point_cloud_range'])
    variables = jax.jit(det.init)(jax.random.PRNGKey(0), batch)
    variables = randomize(variables, np.random.RandomState(0))
    maps = jax.jit(det.apply_eval)(variables, batch)
    dets = jax.jit(jax.vmap(det.head.get_bboxes, in_axes=(0, 0, 0, None)))(
        maps[0], maps[1], maps[2], det.anchors)

    plain = jdet.PointPillarsDetector(
        model_cfg=dict(TINY_MODEL, s2d_canvas='off'), head_cfg=TINY_HEAD)
    _, inter = plain.trunk.apply(
        variables, batch['points'], batch['points_mask'], train=False,
        capture_intermediates=lambda mdl, _: mdl.name == 'voxel_encoder')
    pillars = inter['intermediates']['voxel_encoder']['__call__'][0]
    to_np = lambda xs: [np.asarray(x) for x in xs]
    return dict(variables=variables, batch=batch, maps=to_np(maps[:4]),
                dets=to_np(dets), pillars=np.asarray(pillars),
                anchors=det.anchors)


@pytest.fixture(scope='module')
def port(jax_run):
    det = tdet.PointPillarsDetector(dict(TINY_MODEL, s2d_canvas='off'),
                                    TINY_HEAD, device='cpu')
    det.trunk.load_state_dict(jax_variables_to_torch(jax_run['variables']),
                              strict=True)
    batch = tdet.synthetic_batch(batch_size=2, num_points=1024, num_gt=8,
                                 pc_range=TINY_MODEL['point_cloud_range'],
                                 device='cpu')
    return det, batch


def test_synthetic_batch_equal(jax_run, port):
    _, batch = port
    for k, v in jax_run['batch'].items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_anchors_equal(jax_run, port):
    det, _ = port
    np.testing.assert_array_equal(det.anchors.numpy(), jax_run['anchors'])


def test_pillar_rows(jax_run, port):
    det, batch = port
    with torch.inference_mode():
        feats, _, scatter = det.trunk.pillars(batch['points'],
                                              batch['points_mask'])
    assert int(scatter.num_overflow) == 0
    assert int(scatter.num_voxels) > 1000
    np.testing.assert_allclose(feats.numpy(), jax_run['pillars'],
                               rtol=1e-5, atol=1e-5)


def test_head_maps(jax_run, port):
    det, batch = port
    got = det.apply_eval(batch)
    for g, w, name in zip(got, jax_run['maps'],
                          ('cls', 'bbox', 'dir', 'packed')):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_predict(jax_run, port):
    """Equal labels / valid, scores and boxes within tolerance on valid
    rows; every candidate IoU at least 1e-4 from nms_thr."""
    det, batch = port
    got = [x.numpy() for x in det.predict(batch)]
    want = jax_run['dets']
    with torch.inference_mode():
        maps = det.apply_eval(batch)
        b_sorted, _, v_sorted = det.head.select_candidates(
            maps[0], maps[1], maps[2], det.anchors)
    k = b_sorted.shape[2]
    iou = tiou.iou_bev_pairwise(
        b_sorted[..., [0, 1, 3, 4, 6]].reshape(-1, k, 5).contiguous())
    v = v_sorted.reshape(-1, k).numpy()
    pair = v[:, :, None] & v[:, None, :]
    assert np.abs(iou.numpy()[pair] - 0.01).min() > 1e-4
    assert got[3].sum() >= 10

    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2][got[3]], want[2][want[3]])
    np.testing.assert_allclose(got[1][got[3]], want[1][want[3]], atol=1e-5)
    np.testing.assert_allclose(got[0][got[3]], want[0][want[3]], atol=1e-4)


def _leaf_count(tree):
    return sum(_leaf_count(v) if hasattr(v, 'items') else 1
               for v in tree.values())


def test_converter_maps_each_leaf(jax_run):
    """Spot checks of the mapping: BN stats land in running_mean /
    running_var, scale / bias in weight / bias, and the ConvTranspose kernel
    is flipped; a hard-mode tree's ``pfn_0/linear`` and ``pfn_0/norm``
    (statistics too) land in the same port names and load into the hard
    trunk; every leaf of both trees becomes one tensor."""
    hard = jdet.PointPillarsDetector(
        model_cfg=dict(TINY_MODEL, voxelize_mode='hard'), head_cfg=TINY_HEAD)
    hv = randomize(jax.tree_util.tree_map(np.asarray, jax.jit(hard.init)(
        jax.random.PRNGKey(1), jax_run['batch'])), np.random.RandomState(1))
    hsd = jax_variables_to_torch(hv)
    enc, enc_s = hv['params']['voxel_encoder'], hv['batch_stats'][
        'voxel_encoder']
    assert set(enc) == {'pfn_0'}
    np.testing.assert_array_equal(
        hsd['voxel_encoder.pfn_layers.0.linear.weight'],
        enc['pfn_0']['linear']['kernel'].T)
    for port, jax_name, tree in (('weight', 'scale', enc),
                                 ('bias', 'bias', enc),
                                 ('running_mean', 'mean', enc_s),
                                 ('running_var', 'var', enc_s)):
        np.testing.assert_array_equal(
            hsd[f'voxel_encoder.pfn_layers.0.norm.{port}'],
            tree['pfn_0']['norm'][jax_name])
    net = PointPillarsNet(**dict(TINY_MODEL, voxelize_mode='hard'))
    net.load_state_dict(hsd, strict=True)
    v = jax_run['variables']
    sd = jax_variables_to_torch(v)
    for tree, state in ((hv, hsd), (v, sd)):
        tracked = sum(k.endswith('num_batches_tracked') for k in state)
        assert len(state) - tracked == (_leaf_count(tree['params'])
                                        + _leaf_count(tree['batch_stats']))
    p, s = v['params'], v['batch_stats']
    np.testing.assert_array_equal(
        sd['voxel_encoder.pfn_layers.0.norm.running_var'],
        s['voxel_encoder']['norm_0']['var'])
    np.testing.assert_array_equal(
        sd['voxel_encoder.pfn_layers.0.linear.weight'],
        p['voxel_encoder']['linear_0']['kernel'].T)
    np.testing.assert_array_equal(sd['backbone.blocks.1.4.running_mean'],
                                  s['backbone']['stage1_block0']['bn']['mean'])
    np.testing.assert_array_equal(sd['backbone.blocks.1.4.weight'],
                                  p['backbone']['stage1_block0']['bn']['scale'])
    k = p['neck']['deblock2_conv']['kernel']            # (4, 4, cin, cout)
    np.testing.assert_array_equal(sd['neck.deblocks.2.0.weight'][:, :, 0, 1],
                                  k[3, 2])
    np.testing.assert_array_equal(sd['bbox_head.conv_cls.bias'],
                                  p['bbox_head']['conv_cls']['bias'])


@pytest.mark.parametrize('where', ['params', 'batch_stats', 'grads'])
def test_converter_raises_on_unknown_leaf(jax_run, where):
    """A leaf that maps to no port parameter (here an encoder layer the
    port lacks) raises instead of loading into nothing."""
    v = jax.tree_util.tree_map(np.asarray, jax_run['variables'])
    tree = v['params'] if where == 'grads' else v[where]
    extra = np.zeros((3,), np.float32)
    tree = dict(tree, voxel_encoder=dict(tree['voxel_encoder'],
                                         mvf_0={'kernel': extra}))
    with pytest.raises(KeyError, match='mvf_0'):
        if where == 'grads':
            jax_grads_to_torch(tree)
        else:
            jax_variables_to_torch(dict(v, **{where: tree}))


def test_unported_modes_raise():
    """float16 compute is not supported; an unknown voxelize mode is a
    config error ('mvf' builds since its port: the multi-view encoder)."""
    det = tdet.PointPillarsDetector(
        dict(TINY_MODEL, voxelize_mode='mvf',
             encoder_cfg=dict(feat_channels=16)), TINY_HEAD, device='cpu')
    assert type(det.trunk.voxel_encoder).__name__ == 'PillarMVFFeatureNet'
    with pytest.raises(ValueError):
        tdet.PointPillarsDetector(dict(TINY_MODEL, compute_dtype='float16'),
                                  TINY_HEAD, device='cpu')
    with pytest.raises(ValueError, match='voxelize_mode'):
        PointPillarsNet(**dict(TINY_MODEL, voxelize_mode='dense'))


def test_bf16_detector_builds():
    """The mixed-precision KITTI detector builds with the s2d canvas on
    through 'auto', as the JAX package builds it; f32 parameters."""
    det = tdet.PointPillarsDetector(dict(voxelize_mode='dynamic',
                                         compute_dtype='bfloat16'),
                                    device='cpu')
    assert det.trunk.s2d and det.trunk.compute_dtype == torch.bfloat16
    assert det.trunk.backbone.blocks[0][0].compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in det.trunk.parameters())


# JAX config fields that name a layout or a form of the same function (and
# axis_name=None, one device): the port accepts them and changes nothing.
# SECOND's input_wfold and chunk_h are not among them: JAX's PointPillarsNet
# works both out itself and passes them beside backbone_cfg, so no JAX
# config names them.
JAX_LAYOUT_FIELDS = [dict(hard_encoder='sorted', axis_name=None,
                          deconv_impl='convt'),
                     dict(hard_encoder='packed', deconv_impl='d2s')]


def _with_layout_fields(cfg, fields):
    fields = dict(fields)
    neck = dict(cfg['neck_cfg'], deconv_impl=fields.pop('deconv_impl'))
    return dict(cfg, **fields, neck_cfg=neck)


@pytest.mark.parametrize('extra', [
    dict(s2d_canvas='auto', fold_w2=True, compute_dtype='bfloat16'),
    dict(s2d_canvas='off', fold_w2=False, compute_dtype=None),
    dict(s2d_canvas='on', fold_w2=True),
    dict(s2d_canvas='auto', hard_encoder='packed', axis_name=None,
         neck_cfg=dict(jdet.KITTI_3CLASS_MODEL['neck_cfg'],
                       deconv_impl='d2s')),
    dict(voxelize_mode='hard', s2d_canvas='auto', compute_dtype='bfloat16'),
    dict(voxelize_mode='hard', s2d_canvas='on', hard_encoder='sorted'),
    dict(voxelize_mode='hard', s2d_canvas='off', fold_w2=False)],
    ids=['auto_bf16', 'off', 'on', 'layout_fields', 'hard_auto_bf16',
         'hard_on_sorted', 'hard_off'])
def test_jax_config_builds(extra):
    """A JAX package model config naming the canvas, precision and layout
    fields builds in the port, with the JAX package's canvas choice: the
    dynamic branch takes the s2d canvas unless it is off, the hard branch
    never does."""
    cfg = dict(jdet.KITTI_3CLASS_MODEL, voxelize_mode='dynamic')
    cfg.update(extra)
    det = tdet.PointPillarsDetector(cfg, device='cpu')
    hard = cfg['voxelize_mode'] == 'hard'
    assert det.trunk.s2d == (not hard and extra['s2d_canvas'] != 'off')
    encoder = {'packed': PillarFeatureNet, 'sorted': SortedPillarFeatureNet}[
        cfg.get('hard_encoder', 'packed')] if hard else \
        DynamicPillarFeatureNet
    assert type(det.trunk.voxel_encoder) is encoder


@pytest.mark.parametrize('fields', JAX_LAYOUT_FIELDS, ids=['sorted_convt',
                                                       'packed_d2s'])
def test_layout_fields_predict_the_same(port, fields):
    """The TINY detector built with the JAX layout fields predicts exactly
    what it predicts without them, from the same weights."""
    det, batch = port
    other = tdet.PointPillarsDetector(
        _with_layout_fields(dict(TINY_MODEL, s2d_canvas='off'), fields),
        TINY_HEAD, device='cpu')
    other.trunk.load_state_dict(det.trunk.state_dict(), strict=True)
    for got, want in zip(other.predict(batch), det.predict(batch)):
        assert torch.equal(got, want)


def test_voxelize_mode_defaults_to_hard():
    """The trunk's default is the JAX package's 'hard': the trunk with no
    arguments but its head's classes, and a config without the key, JAX's
    or the port's, build the hard trunk (packed encoder) on the plain
    canvas, not the dynamic one."""
    head = tdet.KITTI_3CLASS_MODEL['head_cfg']
    for net in [PointPillarsNet(head_cfg=head)] + [
            PointPillarsNet(**{k: v for k, v in model.items()
                               if k != 'voxelize_mode'})
            for model in (jdet.KITTI_3CLASS_MODEL, tdet.KITTI_3CLASS_MODEL)]:
        assert net.voxelize_mode == 'hard' and not net.s2d
        assert type(net.voxel_encoder) is PillarFeatureNet
        assert not net.backbone.input_s2d


def test_unported_fields_raise():
    """``axis_name`` builds (the detector's data-parallel group syncs the
    trunk's BatchNorms); the MVF trunk and CenterPoint, whose data-parallel
    step is now ported, take a group of more than one rank into their
    BatchNorms and capacity (``mesh.sync_batchnorms``) instead of raising;
    unknown fields still raise."""
    from mmdet3d_gaussian_tpu_torch.models.backbones import BatchNorm2d
    from mmdet3d_gaussian_tpu_torch.parallel.mesh import (Group,
                                                          sync_batchnorms)
    from tests.test_centerpoint import TINY_CP_MODEL
    from tests.test_torch_mvf import TINY_MVF
    cfg = dict(TINY_MODEL, s2d_canvas='off')
    assert PointPillarsNet(**cfg, axis_name='x').voxelize_mode == 'dynamic'
    two = Group(rank=0, world=2, device=torch.device('cpu'))
    for det in (tdet.PointPillarsDetector(TINY_MVF, TINY_HEAD, device='cpu'),
                tdet.CenterPointDetector(TINY_CP_MODEL, device='cpu')):
        sync_batchnorms(det.trunk, two)
        assert det.trunk.group is two
        assert all(m.group is two for m in det.trunk.modules()
                   if isinstance(m, BatchNorm2d))
    with pytest.raises(ValueError, match='hard_encoder'):
        PointPillarsNet(**cfg, hard_encoder='dense')
    with pytest.raises(ValueError, match='deconv_impl'):
        PointPillarsNet(**dict(cfg, neck_cfg=dict(cfg['neck_cfg'],
                                                  deconv_impl='xla')))


def test_default_device_is_cuda():
    """Entry points run on CUDA unless the caller asks for the CPU; without
    a card they raise instead of falling back."""
    if torch.cuda.is_available():
        det = tdet.PointPillarsDetector(TINY_MODEL, TINY_HEAD)
        assert det.anchors.device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='CUDA'):
        tdet.PointPillarsDetector(TINY_MODEL, TINY_HEAD)
    with pytest.raises(RuntimeError, match='CUDA'):
        tdet.synthetic_batch(1, 16)
