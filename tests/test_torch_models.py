"""PyTorch port modules vs the JAX package on the CPU, with JAX weights
carried over by ``jax_variables_to_torch``: the stats calculator and the
dynamic pillar feature net, SECOND + SECONDFPN (both JAX deconv lowerings),
the head convs, and ``get_bboxes`` on identical head maps.  BN running
statistics, scales and biases are randomized before the transplant so a
swapped mean / var or scale / bias cannot pass.
"""
import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from mmdet3d_gaussian_tpu.engine.detector import KITTI_3CLASS_HEAD
from mmdet3d_gaussian_tpu.models import backbones as jbb
from mmdet3d_gaussian_tpu.models import voxel_encoders as jve
from mmdet3d_gaussian_tpu.models.dense_heads import anchor3d_head as jhead
from mmdet3d_gaussian_tpu.ops import scatter as jsc
from mmdet3d_gaussian_tpu.ops.pallas import segment_kernel as sk

from mmdet3d_gaussian_tpu_torch.models import backbones as tbb
from mmdet3d_gaussian_tpu_torch.models import voxel_encoders as tve
from mmdet3d_gaussian_tpu_torch.models.dense_heads import \
    anchor3d_head as thead
from mmdet3d_gaussian_tpu_torch.ops import rotated_iou as tiou
from mmdet3d_gaussian_tpu_torch.ops import scatter as tsc
from mmdet3d_gaussian_tpu_torch.weights import jax_variables_to_torch

torch.set_num_threads(2)

PCR = (0., -12.8, -3., 25.6, 12.8, 1.)
VSZ = (0.4, 0.4, 4.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def randomize(variables, seed):
    """Random BN running stats (var > 0), scales and biases: every leaf
    named mean / var / scale / bias is redrawn."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, 'items'):
                out[k] = walk(v)
            elif k == 'var':
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k in ('mean', 'bias'):
                out[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
            elif k == 'scale':
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(variables)


def _load(module, prefixes):
    """Nest each JAX variable tree of ``prefixes`` (module name -> tree)
    under its name, convert, and load strictly into ``module``."""
    wrapped = {'params': {}, 'batch_stats': {}}
    for name, sub in prefixes.items():
        wrapped['params'][name] = sub['params']
        wrapped['batch_stats'][name] = sub.get('batch_stats', {})
    module.load_state_dict(jax_variables_to_torch(wrapped), strict=True)


def _points(seed=0, n=1500, b=2):
    rng = np.random.RandomState(seed)
    ctr = np.stack([rng.uniform(-2, 27, n // 6), rng.uniform(-14, 14, n // 6),
                    rng.uniform(-3.5, 1.5, n // 6)], -1)
    xyz = (ctr[rng.randint(0, n // 6, n)]
           + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    pts = np.concatenate([xyz, rng.rand(n, 1).astype(np.float32)], -1)
    bidx = np.sort(rng.randint(0, b, n)).astype(np.int32)
    return pts, bidx


def _scatters(pts, bidx, b=2, mv=1024):
    jc, _ = jsc.compute_voxel_coords(jnp.asarray(pts[:, :3]), PCR, VSZ)
    js = jsc.build_scatter(jsc.batch_coords(jc, jnp.asarray(bidx)),
                           (b, 64, 64, 1), mv, key_order=(0, 2, 1, 3))
    tc, _ = tsc.compute_voxel_coords(_t(pts[:, :3]), PCR, VSZ)
    ts = tsc.build_scatter(tsc.batch_coords(tc, _t(bidx)), (b, 64, 64, 1),
                           mv, key_order=(0, 2, 1, 3))
    order = np.asarray(js.sort_order)
    return js.sorted_view(), ts.sorted_view(), pts[order]


@pytest.fixture
def segment_impl():
    old = sk.INTERPRET, sk.IMPL
    yield
    sk.INTERPRET, sk.IMPL = old


@pytest.mark.parametrize('impl', ['pallas', 'xla'])
def test_stats_calculator(segment_impl, impl):
    """Every decoration channel on (incl. covariance and count)."""
    sk.INTERPRET, sk.IMPL = impl == 'pallas', impl
    pts, bidx = _points()
    jv, tv, pts_sorted = _scatters(pts, bidx)
    kw = dict(voxel_size=VSZ, point_cloud_range=PCR)
    jmod = jve.PointVoxelStatsCalculator(**kw)
    want = np.asarray(jmod(jnp.asarray(pts_sorted[:, :3]), jv))
    tmod = tve.PointVoxelStatsCalculator(**kw)
    got = tmod(_t(pts_sorted[:, :3]), tv).numpy()
    assert got.shape == (pts.shape[0], tmod.out_channels)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('feat_channels', [(16,), (8, 16)])
def test_dynamic_pfn(segment_impl, feat_channels):
    """Dynamic PFN with transplanted weights; (8, 16) runs the between-layer
    voxel-max mapback."""
    pts, bidx = _points(seed=1)
    jv, tv, pts_sorted = _scatters(pts, bidx)
    kw = dict(in_channels=4, feat_channels=feat_channels, voxel_size=VSZ,
              point_cloud_range=PCR)
    jmod = jve.DynamicPillarFeatureNet(**kw)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(pts_sorted), jv)
    variables = randomize(variables, 2)
    want = np.asarray(jmod.apply(variables, jnp.asarray(pts_sorted), jv))
    tmod = tve.DynamicPillarFeatureNet(**kw).eval()
    holder = nn.Module()
    holder.voxel_encoder = tmod
    _load(holder, {'voxel_encoder': variables})
    got = tmod(_t(pts_sorted), tv).detach().numpy()
    assert (np.abs(want).sum(1) > 0).sum() > 100
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('deconv_impl', ['d2s', 'convt'])
def test_second_fpn(deconv_impl):
    """SECOND + SECONDFPN vs JAX; the torch ConvTranspose2d weight is the
    flipped flax kernel."""
    bb_kw = dict(in_channels=16, out_channels=(16, 32, 64),
                 layer_nums=(1, 2, 1), layer_strides=(2, 2, 2))
    nk_kw = dict(in_channels=(16, 32, 64), out_channels=(16, 16, 16),
                 upsample_strides=(1, 2, 4))
    x = np.random.RandomState(0).randn(2, 32, 40, 16).astype(np.float32)
    jb = jbb.SECOND(**bb_kw)
    jn = jbb.SECONDFPN(deconv_impl=deconv_impl, **nk_kw)
    vb = randomize(jb.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    feats = jb.apply(vb, jnp.asarray(x))
    vn = randomize(jn.init(jax.random.PRNGKey(1), feats), 2)
    want = np.asarray(jn.apply(vn, feats))

    holder = nn.Module()
    holder.backbone = tbb.SECOND(**bb_kw)
    holder.neck = tbb.SECONDFPN(**nk_kw)
    _load(holder, {'backbone': vb, 'neck': vn})
    holder.eval()
    with torch.no_grad():
        got = holder.neck(holder.backbone(_t(x))).numpy()
    assert got.shape == want.shape == (2, 16, 20, 48)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_head_convs():
    """Four outputs (cls, bbox, dir, packed padded to 128 channels) from a
    list of neck branches."""
    rng = np.random.RandomState(0)
    branches = [rng.randn(2, 8, 10, 16).astype(np.float32) for _ in range(3)]
    jmod = jhead.Anchor3DHeadConvs(num_classes=3, num_anchors=6,
                                   feat_channels=48)
    jin = [jnp.asarray(b) for b in branches]
    variables = randomize(jmod.init(jax.random.PRNGKey(0), jin), 3)
    want = jmod.apply(variables, jin)
    tmod = thead.Anchor3DHeadConvs(num_classes=3, num_anchors=6,
                                   feat_channels=48)
    holder = nn.Module()
    holder.bbox_head = tmod
    _load(holder, {'bbox_head': variables})
    with torch.no_grad():
        got = tmod([_t(b) for b in branches])
    assert got[3].shape[-1] == 128
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_get_bboxes_identical_maps():
    """Batched get_bboxes vs the vmapped JAX get_bboxes on the same maps:
    labels and valid equal, boxes within 1e-4 on valid rows.  Every
    candidate IoU is checked to be at least 1e-4 from nms_thr."""
    test_cfg = dict(use_rotate_nms=True, nms_thr=0.01, score_thr=0.05,
                    nms_pre=128, max_num=32)
    hc = dict(KITTI_3CLASS_HEAD, test_cfg=test_cfg)
    jh = jhead.GDAnchor3DHead(**hc)
    th = thead.GDAnchor3DHead(**hc)
    h, w = 32, 32
    anchors = jh.anchors_for((h, w))
    np.testing.assert_array_equal(th.anchors_for((h, w)), anchors)
    rng = np.random.RandomState(0)
    cls = rng.normal(-2.0, 1.5, (2, h, w, 18)).astype(np.float32)
    bbox = rng.normal(0, 0.2, (2, h, w, 42)).astype(np.float32)
    dirp = rng.normal(0, 1, (2, h, w, 12)).astype(np.float32)

    want = jax.jit(jax.vmap(jh.get_bboxes, in_axes=(0, 0, 0, None)))(
        jnp.asarray(cls), jnp.asarray(bbox), jnp.asarray(dirp), anchors)
    want = [np.asarray(x) for x in want]
    args = (_t(cls), _t(bbox), _t(dirp), _t(anchors))
    got = [x.numpy() for x in th.get_bboxes(*args)]

    b_sorted, _, v_sorted = th.select_candidates(*args)
    bev = b_sorted[..., [0, 1, 3, 4, 6]].reshape(-1, 128, 5)
    iou = tiou.iou_bev_pairwise(bev.contiguous()).numpy()
    v = v_sorted.reshape(-1, 128).numpy()
    pair = v[:, :, None] & v[:, None, :]
    assert np.abs(iou[pair] - 0.01).min() > 1e-4
    assert v.sum() > 100 and got[3].sum() > 20

    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2][got[3]], want[2][want[3]])
    np.testing.assert_allclose(got[1][got[3]], want[1][want[3]], rtol=1e-6)
    np.testing.assert_allclose(got[0][got[3]], want[0][want[3]], atol=1e-4)
