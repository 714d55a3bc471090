"""The whole TINY PointPillars predict (dynamic voxelize) of the PyTorch
port vs the JAX package on the CPU, with the JAX weights (BN statistics,
scales and biases randomized first) carried over by
``jax_variables_to_torch``.

The JAX model runs with its defaults, which turn on the space-to-depth
canvas and the W-folded stage 0 for this config; its voxel rows then follow
the s2d key, so pillar rows are compared against JAX built with
``s2d_canvas='off'`` (plain canvas order, as the port) and everything after
the canvas against JAX with its defaults.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu.engine import detector as jdet

from mmdet3d_gaussian_tpu_torch.engine import detector as tdet
from mmdet3d_gaussian_tpu_torch.ops import rotated_iou as tiou
from mmdet3d_gaussian_tpu_torch.weights import jax_variables_to_torch

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
    det = tdet.PointPillarsDetector(TINY_MODEL, TINY_HEAD, device='cpu')
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


def test_converter_maps_each_leaf(jax_run):
    """Spot checks of the mapping: BN stats land in running_mean /
    running_var, scale / bias in weight / bias, and the ConvTranspose kernel
    is flipped."""
    v = jax_run['variables']
    sd = jax_variables_to_torch(v)
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


def test_unported_modes_raise():
    with pytest.raises(NotImplementedError):
        tdet.PointPillarsDetector(dict(TINY_MODEL, voxelize_mode='hard'),
                                  TINY_HEAD, device='cpu')
    with pytest.raises(NotImplementedError):
        tdet.PointPillarsDetector(dict(TINY_MODEL,
                                       compute_dtype='bfloat16'),
                                  TINY_HEAD, device='cpu')


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
