"""PyTorch port ops vs the JAX package on the CPU: scatter construction,
and the plain versions of kernels K1 (segment reduce), K2 (BEV splat), K5
(rotated IoU) and K6 (NMS sweep), each held to its Pallas kernel in
interpret mode and to the JAX XLA path.  Inputs are made with numpy from a
seed and handed to both.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mmdet3d_gaussian_tpu.ops import nms as jnms
from mmdet3d_gaussian_tpu.ops import rotated_iou as jiou
from mmdet3d_gaussian_tpu.ops import scatter as jsc
from mmdet3d_gaussian_tpu.ops import voxelize as jvx
from mmdet3d_gaussian_tpu.ops.pallas import segment_kernel as sk
from mmdet3d_gaussian_tpu.ops.pallas.bev_splat_kernel import bev_splat_pallas
from mmdet3d_gaussian_tpu.ops.pallas.nms_kernel import nms_sweep_pallas
from mmdet3d_gaussian_tpu.ops.pallas.rotated_iou_kernel import iou_bev_pallas

from mmdet3d_gaussian_tpu_torch.ops import nms as tnms
from mmdet3d_gaussian_tpu_torch.ops import rotated_iou as tiou
from mmdet3d_gaussian_tpu_torch.ops import scatter as tsc
from mmdet3d_gaussian_tpu_torch.ops import segment as tseg
from mmdet3d_gaussian_tpu_torch.ops import voxelize as tvx
from mmdet3d_gaussian_tpu_torch.ops.scan import cummax_i32, cumsum_i32

torch.set_num_threads(2)

PCR = (0., -39.68, -3., 69.12, 39.68, 1.)
VSZ = (0.16, 0.16, 4.0)
GRID = (432, 496, 1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _points(seed, n, b):
    """Points partly out of range, clustered so voxels hold several."""
    rng = np.random.RandomState(seed)
    ctr = np.stack([rng.uniform(-5, 72, n // 8), rng.uniform(-45, 45, n // 8),
                    rng.uniform(-4, 2, n // 8)], -1)
    xyz = (ctr[rng.randint(0, n // 8, n)]
           + rng.normal(0, 0.2, (n, 3))).astype(np.float32)
    pts = np.concatenate([xyz, rng.rand(n, 1).astype(np.float32)], -1)
    bidx = rng.randint(0, b, n).astype(np.int32)
    return pts, bidx


def _both_scatters(seed=0, n=3000, b=2, mv=2048, key_order=(0, 2, 1, 3)):
    pts, bidx = _points(seed, n, b)
    jc, _ = jsc.compute_voxel_coords(jnp.asarray(pts[:, :3]), PCR, VSZ)
    jc4 = jsc.batch_coords(jc, jnp.asarray(bidx))
    js = jsc.build_scatter(jc4, (b,) + GRID, mv, key_order=key_order)
    tc, _ = tsc.compute_voxel_coords(_t(pts[:, :3]), PCR, VSZ)
    tc4 = tsc.batch_coords(tc, _t(bidx))
    ts = tsc.build_scatter(tc4, (b,) + GRID, mv, key_order=key_order)
    return pts, js, ts, (np.asarray(jc4), tc4.numpy())


def test_scan_matches_numpy():
    x = np.random.RandomState(0).randint(-50, 50, 5000).astype(np.int32)
    np.testing.assert_array_equal(cumsum_i32(_t(x)).numpy(), np.cumsum(x))
    np.testing.assert_array_equal(cummax_i32(_t(x)).numpy(),
                                  np.maximum.accumulate(x))


@pytest.mark.parametrize('mv,key_order', [(2048, (0, 2, 1, 3)),
                                          (2048, None),
                                          (300, (0, 2, 1, 3))])
def test_build_scatter_equal(mv, key_order):
    """Voxel ids, coords, counts, starts and order are equal; mv=300
    overflows (live voxels beyond capacity go to the trash id)."""
    _, js, ts, (jc4, tc4) = _both_scatters(mv=mv, key_order=key_order)
    np.testing.assert_array_equal(tc4, jc4)
    assert int(ts.num_overflow) == int(js.num_overflow)
    assert (int(js.num_overflow) > 0) == (mv == 300)
    assert int(ts.num_voxels) == int(js.num_voxels)
    for f in ('point_voxel_ids', 'voxel_coords', 'voxel_counts',
              'sort_order', 'sorted_starts', 'sorted_ids'):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


def test_compute_voxel_coords_boundaries():
    """Points on and next to voxel boundaries floor the same way."""
    rng = np.random.RandomState(3)
    ij = rng.randint(-2, 500, (2000, 3)).astype(np.float32)
    xyz = (np.asarray(PCR[:3], np.float32)
           + ij * np.asarray(VSZ, np.float32)
           + rng.choice([-1e-5, 0.0, 1e-5], (2000, 3)).astype(np.float32))
    jc, jg = jsc.compute_voxel_coords(jnp.asarray(xyz), PCR, VSZ)
    tc, tg = tsc.compute_voxel_coords(_t(xyz), PCR, VSZ)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.fixture
def pallas_segments():
    old = sk.INTERPRET, sk.IMPL
    sk.INTERPRET, sk.IMPL = True, 'pallas'
    yield
    sk.INTERPRET, sk.IMPL = old


@pytest.mark.parametrize('impl', ['pallas', 'xla'])
@pytest.mark.parametrize('op', ['sum', 'mean', 'max'])
def test_k1_plain_reduce(pallas_segments, impl, op):
    """Scatter.reduce (K1 reduce form) vs segment_kernel in interpret mode
    and vs the XLA segment ops."""
    pts, js, ts, _ = _both_scatters()
    jv, tv = js.sorted_view(), ts.sorted_view()
    feats = np.random.RandomState(1).randn(pts.shape[0], 16).astype(
        np.float32)
    feats_sorted = feats[np.asarray(js.sort_order)]
    sk.IMPL = impl
    want = np.asarray(jv.reduce(jnp.asarray(feats_sorted), op))
    got = tv.reduce(_t(feats_sorted), op).numpy()
    if op == 'max':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('impl', ['pallas', 'xla'])
@pytest.mark.parametrize('op', ['sum', 'mean', 'max'])
def test_k1_plain_reduce_mapback(pallas_segments, impl, op):
    """Scatter.reduce_mapback (K1 mapback form): invalid rows read 0."""
    pts, js, ts, _ = _both_scatters(seed=2)
    jv, tv = js.sorted_view(), ts.sorted_view()
    feats = np.random.RandomState(4).randn(pts.shape[0], 8).astype(
        np.float32)
    feats_sorted = feats[np.asarray(js.sort_order)]
    sk.IMPL = impl
    want = np.asarray(jv.reduce_mapback(jnp.asarray(feats_sorted), op))
    got = tv.reduce_mapback(_t(feats_sorted), op).numpy()
    assert (~tv.valid_point_mask.numpy()).any()
    if op == 'max':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_k1_wrappers_direct():
    """The K1 wrappers on hand-made segments, including empty ones and a
    trash tail, against a per-segment numpy loop."""
    rng = np.random.RandomState(5)
    counts = np.array([3, 0, 1, 4, 0, 2], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    starts = np.maximum.accumulate(np.where(counts > 0, starts, 0))
    n_live = counts.sum()
    data = rng.randn(n_live + 3, 5).astype(np.float32)
    ids = np.concatenate([np.repeat(np.arange(6), counts),
                          np.full(3, 6)]).astype(np.int32)
    for op, fn in (('sum', np.sum), ('max', np.max)):
        want = np.stack([fn(data[s:s + c], 0) if c else np.zeros(5)
                         for s, c in zip(starts, counts)]).astype(np.float32)
        got = tseg.segment_reduce(_t(data), _t(starts), _t(counts), op)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        got_m = tseg.segment_reduce_mapback(_t(data), _t(ids), _t(starts),
                                            _t(counts), op)
        want_m = np.concatenate([want, np.zeros((1, 5), np.float32)])[ids]
        np.testing.assert_allclose(got_m.numpy(), want_m, rtol=1e-6)


def test_k1_wrapper_rejects_bad_inputs():
    data = torch.zeros(4, 3)
    starts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        tseg.segment_reduce(data.double(), starts, starts, 'sum')
    with pytest.raises(ValueError):
        tseg.segment_reduce(data.t(), starts, starts, 'sum')
    with pytest.raises(ValueError):
        tseg.segment_reduce(data, starts, starts, 'min')
    with pytest.raises(ValueError):
        tseg.segment_reduce(data, starts, starts[:1], 'sum')


def _splat_case(ncell=4096, v=1024, c=64, nval=700, seed=0):
    rng = np.random.RandomState(seed)
    lin = np.full(v, ncell, np.int32)
    lin[:nval] = np.sort(rng.choice(ncell, nval, replace=False))
    lin[nval:nval + 5] = ncell + 7          # any id >= ncell is dropped
    lin[nval + 5:] = np.maximum(lin[nval + 5:], ncell + 7)
    feats = rng.randn(v, c).astype(np.float32)
    return feats, lin


@pytest.mark.parametrize('ncell', [4096, 4096 + 300])
def test_k2_plain_matches_jax(ncell):
    """bev_splat plain vs voxelize._splat (exact f32 path) and vs
    bev_splat_pallas in interpret mode with f32 output (both exact)."""
    feats, lin = _splat_case(ncell=ncell)
    got = tvx.bev_splat(_t(feats), _t(lin), ncell).numpy()
    xla = np.asarray(jvx._splat(jnp.asarray(feats), jnp.asarray(lin), ncell,
                                True))
    pallas = np.asarray(bev_splat_pallas(jnp.asarray(feats),
                                         jnp.asarray(lin), ncell,
                                         jnp.float32, True))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    assert (got[:ncell].sum(1) == 0).sum() == ncell - 700


def test_bev_scatter_matches_jax():
    """Canvas from a real canvas-order scatter, as the detector builds it."""
    pts, js, ts, _ = _both_scatters(seed=6)
    feats = np.random.RandomState(7).randn(js.max_voxels, 8).astype(
        np.float32)
    want = np.asarray(jvx.bev_scatter(jnp.asarray(feats), js.voxel_coords, 2,
                                      496, 432, indices_sorted=True))
    got = tvx.bev_scatter(_t(feats), ts.voxel_coords, 2, 496, 432).numpy()
    np.testing.assert_array_equal(got, want)


def _cluster_boxes(seed, p, k, spread=20.0):
    """Decoded-anchor-like BEV boxes: jittered clusters, so many pairs
    overlap and some IoUs exceed the NMS threshold."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-spread, spread, (p, k // 4, 2))
    pick = rng.randint(0, k // 4, (p, k))
    xy = np.take_along_axis(centers, pick[..., None], 1) \
        + rng.normal(0, 0.6, (p, k, 2))
    wh = rng.uniform([0.5, 0.5], [4.5, 2.0], (p, k, 2))
    yaw = rng.uniform(-np.pi, np.pi, (p, k, 1))
    return np.concatenate([xy, wh, yaw], -1).astype(np.float32)


@pytest.mark.parametrize('spread', [3.0, 20.0])
def test_k5_plain_matches_xla(spread):
    """Rotated IoU plain version vs the JAX XLA iou_bev (atan2 order)."""
    boxes = _cluster_boxes(0, 2, 96, spread)
    got = tiou.iou_bev_pairwise(_t(boxes)).numpy()
    assert (got > 0.01).mean() > 0.02          # clusters overlap
    for i in range(2):
        xla = np.asarray(jiou.iou_bev(jnp.asarray(boxes[i]),
                                      jnp.asarray(boxes[i])))
        np.testing.assert_allclose(got[i], xla, rtol=0, atol=1e-5)


def test_k5_plain_matches_pallas():
    """Rotated IoU plain version vs the Pallas kernel in interpret mode
    (pseudo-angle order).  Boxes within a few metres of the origin: the
    shoelace terms are products of absolute coordinates that cancel, and
    the interpreted kernel rounds them differently from the port (its
    self-IoU of a box 20 m out is 0.99995 where float64 gives 1), so far
    from the origin the two differ by up to ~5e-5 from rounding alone."""
    boxes = _cluster_boxes(1, 2, 96, spread=3.0)
    got = tiou.iou_bev_pairwise(_t(boxes)).numpy()
    for i in range(2):
        with pltpu.force_tpu_interpret_mode():
            pal = np.asarray(iou_bev_pallas(jnp.asarray(boxes[i]),
                                            jnp.asarray(boxes[i])))
        np.testing.assert_allclose(got[i], pal, rtol=0, atol=1e-5)


def test_k5_iou_bev_and_corners():
    a = _cluster_boxes(1, 1, 40)[0]
    b = _cluster_boxes(2, 1, 24)[0]
    np.testing.assert_allclose(
        tiou.iou_bev(_t(a), _t(b)).numpy(),
        np.asarray(jiou.iou_bev(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)
    np.testing.assert_allclose(tiou.box_corners(_t(a)).numpy(),
                               np.asarray(jiou.box_corners(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-5)
    # self-IoU is 1 up to f32 cancellation in the shoelace sum (~5e-5 for
    # boxes 20 m from the origin)
    np.testing.assert_allclose(np.diag(tiou.iou_bev(_t(a), _t(a)).numpy()),
                               1.0, atol=1e-4)


def test_k6_plain_matches_pallas():
    """Suppression sweep plain version vs the Pallas kernel in interpret
    mode, problem by problem; keep masks equal."""
    rng = np.random.RandomState(0)
    p, k = 3, 256
    m = rng.rand(p, k, k).astype(np.float32) * 0.8
    m = (m + m.transpose(0, 2, 1)) / 2
    valid = rng.rand(p, k) > 0.1
    got = tnms.suppress_sweep(_t(m), _t(valid), 0.3).numpy()
    for i in range(p):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(nms_sweep_pallas(jnp.asarray(m[i]),
                                               jnp.asarray(valid[i]), 0.3))
        np.testing.assert_array_equal(got[i], want)
    assert not got[~valid].any()                 # invalid rows never kept


def test_nms_bev_matches_jax():
    """Batched nms_bev (K5 + K6 plain) vs the JAX nms_bev per problem, with
    every IoU at least 1e-4 from the threshold."""
    thr = 0.01
    boxes = _cluster_boxes(5, 4, 64)
    valid = np.random.RandomState(4).rand(4, 64) > 0.2
    iou = tiou.iou_bev_pairwise(_t(boxes)).numpy()
    assert np.abs(iou - thr).min() > 1e-4
    got = tnms.nms_bev(_t(boxes), thr, _t(valid)).numpy()
    suppressed = 0
    for i in range(4):
        want = np.asarray(jnms.nms_bev(jnp.asarray(boxes[i]), None, thr,
                                       valid=jnp.asarray(valid[i])))
        np.testing.assert_array_equal(got[i], want)
        suppressed += int(valid[i].sum() - want.sum())
    assert suppressed > 0


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        tiou.iou_bev_pairwise(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        tnms.suppress_sweep(torch.zeros(2, 3, 4),
                            torch.ones(2, 3, dtype=torch.bool), 0.1)
    with pytest.raises(TypeError):
        tvx.bev_splat(torch.zeros(4, 2), torch.zeros(4), 8)
