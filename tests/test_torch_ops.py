"""PyTorch port ops vs the JAX package on the CPU: scatter construction,
and the plain versions of kernels K1 (segment reduce, its winner form and
the reduce backward), K2 (BEV splat and its gradient), K4 (BatchNorm
moments, ``bn_train`` and the BN modules in training), K5 (rotated IoU) and
K6 (NMS sweep), each held to its Pallas kernel in interpret mode and to the
JAX XLA path.  Inputs are made with numpy from a seed and handed to both.
K5's cull predicate (``near_pairs_plain``) is held to the plain version and
to JAX: every pair it calls far has the IoU of an empty intersection.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mmdet3d_gaussian_tpu.models import voxel_encoders as jve

from mmdet3d_gaussian_tpu.ops import nms as jnms
from mmdet3d_gaussian_tpu.ops import rotated_iou as jiou
from mmdet3d_gaussian_tpu.ops import scatter as jsc
from mmdet3d_gaussian_tpu.ops import voxelize as jvx
from mmdet3d_gaussian_tpu.ops.pallas import bn_kernel as bk
from mmdet3d_gaussian_tpu.ops.pallas import segment_kernel as sk
from mmdet3d_gaussian_tpu.ops.pallas.bev_splat_kernel import bev_splat_pallas
from mmdet3d_gaussian_tpu.ops.pallas.nms_kernel import nms_sweep_pallas
from mmdet3d_gaussian_tpu.ops.pallas.rotated_iou_kernel import iou_bev_pallas

from mmdet3d_gaussian_tpu_torch.models import backbones as tbb
from mmdet3d_gaussian_tpu_torch.models import voxel_encoders as tve
from mmdet3d_gaussian_tpu_torch.ops import bn as tbn
from mmdet3d_gaussian_tpu_torch.ops import nms as tnms
from mmdet3d_gaussian_tpu_torch.ops import rotated_iou as tiou
from mmdet3d_gaussian_tpu_torch.ops import scatter as tsc
from mmdet3d_gaussian_tpu_torch.ops import segment as tseg
from mmdet3d_gaussian_tpu_torch.ops import voxelize as tvx
from mmdet3d_gaussian_tpu_torch.ops.scan import cummax_i32, cumsum_i32

from .torch_k5_boxes import adversarial_boxes, far_value
from .torch_k5_boxes import cluster_boxes as _cluster_boxes
from .torch_k6_iou import CASES as K6_CASES
from .torch_k6_iou import THRESHOLDS as K6_THRESHOLDS
from .torch_k6_iou import adversarial as k6_adversarial
from .torch_k6_iou import blocked_word_sweep

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


def _assert_far_pairs_empty(boxes):
    """On every pair that ``near_pairs_plain`` calls far, the plain IoU and
    the JAX XLA ``iou_bev`` equal the IoU of an empty intersection (what
    the kernel writes there): exactly 0 where both sizes are >= 0.  -> the
    near mask."""
    near = tiou.near_pairs_plain(_t(boxes))
    far = ~near
    plain = tiou.iou_bev_pairwise(_t(boxes))
    want = far_value(boxes)
    assert torch.equal(plain[far], want[far])
    for i in range(boxes.shape[0]):
        xla = torch.from_numpy(np.array(jiou.iou_bev(
            jnp.asarray(boxes[i]), jnp.asarray(boxes[i]))))
        assert torch.equal(xla[far[i]], want[i][far[i]])
    sized = (boxes[..., 2] >= 0) & (boxes[..., 3] >= 0)
    both = _t(sized[:, :, None] & sized[:, None, :])
    assert not plain[far & both].any()         # exactly 0
    assert bool(near[(plain != 0) & both].all())   # every overlap is near
    return near


@pytest.mark.parametrize('region', ['origin', 'range_corners'])
def test_k5_cull_is_exact(region):
    """K5's cull never calls a pair with a nonzero IoU far, in the plain
    version or in JAX, on boxes placed at R_a + R_b +- 1e-4 edge to edge
    and corner to corner, zero-size, thin, equal, negative-width and NaN
    boxes; both sides of the threshold occur."""
    boxes = adversarial_boxes(0, region)
    near = _assert_far_pairs_empty(boxes)[0]
    k = boxes.shape[1]
    pair = near[np.arange(0, 48, 2), np.arange(1, 48, 2)]
    assert pair.any() and not pair.all()       # both sides of R_a + R_b
    assert bool(near[k - 1].all() and near[:, k - 1].all())   # NaN box
    neg = k - 2                                # negative width: far pairs
    far_neg = ~near[neg]                       # keep the plain value
    assert far_neg.any()
    assert bool((far_value(boxes)[0, neg][far_neg] < 0).all())


@pytest.mark.parametrize('spread', [3.0, 20.0])
def test_k5_cull_is_exact_on_clusters(spread):
    boxes = _cluster_boxes(0, 2, 96, spread)
    near = _assert_far_pairs_empty(boxes)
    assert 0 < float(near.float().mean()) < 1


def test_k5_cull_radius():
    """The cull radius: half the diagonal with its margins, +inf for a box
    whose shorter side is not 0 but under 2^-10 of its half diagonal, NaN
    for a non-finite field; the near mask is symmetric."""
    b = torch.tensor([[[10.0, -20.0, 4.0, 3.0, 0.5],
                       [10.0, -14.0, 4.0, 0.001, 0.5],
                       [10.0, -8.0, 0.0, 3.0, 0.5],
                       [10.0, -2.0, 4.0, 3.0, float('inf')],
                       [30.0, 0.0, 4.0, 3.0, 0.5]]])
    r = tiou.cull_radius(b)[0]
    assert float(r[0]) == pytest.approx(2.5 * (1 + 2 ** -6) + 2 ** -10
                                        + 30 * 2 ** -17, rel=1e-6)
    assert float(r[1]) == float('inf') and float(r[2]) < float('inf')
    assert torch.isnan(r[3])
    near = tiou.near_pairs_plain(b)[0]
    assert torch.equal(near, near.T) and bool(near.diagonal().all())
    assert not near[0, 4] and near[0, 1] and near[3].all()


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


@pytest.mark.parametrize('thr', K6_THRESHOLDS)
@pytest.mark.parametrize('case', K6_CASES)
def test_k6_adversarial_matches_pallas(case, thr):
    """The plain sweep and the blocked word sweep (the CUDA kernel's
    algorithm, emulated) vs the Pallas kernel in interpret mode on the
    adversarial matrices (threshold ties, NaN/inf/-0.0, all or none above,
    the chain, invalid suppressors) at K = 130 (a partial last word);
    keep masks equal."""
    iou, valid = k6_adversarial(case, 130, thr, seed=1, p=1)
    got = tnms.suppress_sweep(_t(iou), _t(valid), thr).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(nms_sweep_pallas(jnp.asarray(iou[0]),
                                           jnp.asarray(valid[0]), thr))
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(blocked_word_sweep(iou, valid, thr), got)
    if case == 'chain':
        np.testing.assert_array_equal(want, np.arange(130) % 2 == 0)
    if case == 'all_above':
        np.testing.assert_array_equal(want, np.arange(130) == 0)
    if case == 'none_above':
        np.testing.assert_array_equal(want, valid[0])


@pytest.mark.parametrize('thr', K6_THRESHOLDS)
@pytest.mark.parametrize('k', [1, 31, 64, 65, 1500])
def test_k6_adversarial_matches_xla(k, thr):
    """The plain sweep and the blocked word sweep vs JAX's XLA
    ``_suppress_sweep`` on every adversarial matrix, problem by problem;
    keep masks equal.  K = 1 and 31 leave idle lanes, 65 a one-bit last
    word, 1500 24 words a row."""
    for case in K6_CASES:
        iou, valid = k6_adversarial(case, k, thr, seed=k)
        got = tnms.suppress_sweep(_t(iou), _t(valid), thr).numpy()
        for i in range(iou.shape[0]):
            want = np.asarray(jnms._suppress_sweep(
                jnp.asarray(iou[i]), jnp.asarray(valid[i]), thr))
            np.testing.assert_array_equal(got[i], want, err_msg=case)
        np.testing.assert_array_equal(blocked_word_sweep(iou, valid, thr),
                                      got, err_msg=case)


@pytest.mark.parametrize('k', [200, 1500])
def test_k6_blocked_sweep_streams(k):
    """The blocked word sweep staged one or a few row blocks at a time (the
    kernel's path for large K) equals the plain sweep and the sweep staged
    whole, on a random symmetric matrix."""
    rng = np.random.RandomState(k)
    m = rng.rand(3, k, k).astype(np.float32) * 0.5
    m = (m + m.transpose(0, 2, 1)) / 2
    valid = rng.rand(3, k) > 0.1
    want = tnms.suppress_sweep_plain(_t(m), _t(valid), 0.3).numpy()
    assert want.sum() < valid.sum()
    w = -(-k // 64)
    for cap in (None, 64 * w, 64 * w + 64 * (w - 1), 3 * 64 * w):
        np.testing.assert_array_equal(
            blocked_word_sweep(m, valid, 0.3, cap_words=cap), want)


def test_k6_packed_words():
    """The wrapper's workspace holds the kernel's triangle: row block b keeps
    words b .. W-1 of 64 rows."""
    for k, w in ((1, 1), (64, 1), (65, 2), (1024, 16), (24 * 1024, 384)):
        assert tnms.packed_words(k) == sum(64 * (w - b) for b in range(w))


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


# ------------------------------------------------ K1 winner form, backward
def test_k1_argmax_direct():
    """Winner form on hand-made segments: the max and the per-row winner
    mask, true at the lowest row index holding the max, ties included;
    empty segments give 0 and own no row, a NaN gives a NaN max and no
    winner, the trash row is never a winner."""
    counts = np.array([4, 0, 3, 1, 5], np.int32)
    starts = np.array([0, 4, 4, 7, 8], np.int32)
    ids = np.array([0, 0, 0, 0, 2, 2, 2, 3, 4, 4, 4, 4, 4, 5], np.int32)
    data = np.array([[1, 2], [3, 2], [3, 0], [0, 2],          # segment 0
                     [5, -1], [5, -1], [4, -2],               # segment 2
                     [-7, 8],                                 # segment 3
                     [0, 1], [2, np.nan], [2, 1], [1, 1], [0, 0],
                     [9, 9]],                                 # trash row
                    np.float32)
    out, mask = tseg.segment_max_winner(_t(data), _t(ids), _t(starts),
                                        _t(counts))
    want_out = np.array([[3, 2], [0, 0], [5, -1], [-7, 8], [2, np.nan]],
                        np.float32)
    want_mask = np.zeros((14, 2), bool)
    for row, col in ((1, 0), (0, 1), (4, 0), (4, 1), (7, 0), (7, 1),
                     (9, 0)):
        want_mask[row, col] = True
    np.testing.assert_array_equal(out.numpy(), want_out)
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), want_mask)


@pytest.mark.parametrize('seed', [10, 11])
def test_k1_winner_mask_matches_pallas(pallas_segments, seed):
    """The plain winner mask bitwise equal to segment_kernel._winner_mask
    in interpret mode on small integer features (many tied maxima), with a
    NaN, +-inf and +-0.0 ties; the max equal to its per-row total.  The
    Pallas kernel also marks winners in the trash segment (their gradient
    is 0 there); the port marks none."""
    pts, js, ts, _ = _both_scatters(seed=seed)
    rng = np.random.RandomState(seed)
    feats = rng.randint(0, 3, (pts.shape[0], 8)).astype(np.float32)
    feats[rng.rand(*feats.shape) < 0.02] = np.nan
    feats[:, 5] = np.where(feats[:, 5] == 2, np.inf, feats[:, 5])
    feats[:, 6] = np.where(feats[:, 6] == 2, -0.0, 0.0)
    feats[:, 7] = np.where(feats[:, 7] == 2, -np.inf, feats[:, 7])
    feats_sorted = feats[np.asarray(js.sort_order)]
    ids = np.asarray(js.sorted_ids)
    np.testing.assert_array_equal(ts.sorted_ids.numpy(), ids)
    total, want = sk._winner_mask(jnp.asarray(feats_sorted),
                                  jnp.asarray(ids))
    out, mask = tseg.segment_max_winner(_t(feats_sorted), ts.sorted_ids,
                                        ts.sorted_starts, ts.voxel_counts)
    live = ids < js.max_voxels
    assert (~live).any()
    np.testing.assert_array_equal(mask.numpy()[live], np.asarray(want)[live])
    assert not mask.numpy()[~live].any()
    np.testing.assert_array_equal(out.numpy()[ids[live]],
                                  np.asarray(total)[live])
    assert int(mask.sum()) < int((feats_sorted[live]
                                  == out.numpy()[ids[live]]).sum())


@pytest.mark.parametrize('impl', ['pallas', 'xla'])
@pytest.mark.parametrize('op', ['sum', 'mean', 'max'])
@pytest.mark.parametrize('form', ['reduce', 'reduce_mapback'])
def test_k1_backward_matches_jax(pallas_segments, impl, op, form):
    """Gradients of Scatter.reduce / reduce_mapback (max through the winner
    form) vs the VJP of segment_kernel's sorted_reduce(_mapback) in
    interpret mode and of the XLA path, on small integer features so many
    segments hold tied maxima: the gradient goes to the lowest tied row."""
    pts, js, ts, _ = _both_scatters(seed=8)
    jv, tv = js.sorted_view(), ts.sorted_view()
    rng = np.random.RandomState(9)
    feats = rng.randint(0, 3, (pts.shape[0], 6)).astype(np.float32)
    out_rows = js.max_voxels if form == 'reduce' else pts.shape[0]
    g = rng.randn(out_rows, 6).astype(np.float32)
    sk.IMPL = impl
    _, vjp = jax.vjp(lambda x: getattr(jv, form)(x, op), jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    x = _t(feats).requires_grad_(True)
    (got,) = torch.autograd.grad(getattr(tv, form)(x, op), x, _t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if op == 'max':
        # ties: rows equal to their segment max that take no gradient
        seg_max = tv.reduce(_t(feats), 'max')
        ids = tv.point_voxel_ids.long()
        live = ids < js.max_voxels
        tied = (_t(feats)[live] == seg_max[ids[live]]) \
            & (got[live] == 0) & (_t(g).abs().sum() > 0)
        assert int(tied.sum()) > 50


# ------------------------------------------------------- K2 gradient
def test_bev_scatter_grad_matches_jax():
    """The canvas gradient gathered back at each pillar's cell (rows off the
    canvas read 0) vs the VJP of the JAX bev_scatter."""
    pts, js, ts, _ = _both_scatters(seed=10)
    rng = np.random.RandomState(11)
    feats = rng.randn(js.max_voxels, 4).astype(np.float32)
    g = rng.randn(2, 432, 496, 4).astype(np.float32)    # (B, ny, nx, C)
    _, vjp = jax.vjp(lambda f: jvx.bev_scatter(f, js.voxel_coords, 2, 496,
                                                432, indices_sorted=True),
                     jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    x = _t(feats).requires_grad_(True)
    (got,) = torch.autograd.grad(
        tvx.bev_scatter(x, ts.voxel_coords, 2, 496, 432), x, _t(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[int(ts.num_voxels):] == 0).all()


# ------------------------------------------------------------------ K4
@pytest.fixture
def pallas_bn():
    old = bk.INTERPRET, bk.IMPL
    bk.INTERPRET, bk.IMPL = True, 'pallas'
    yield
    bk.INTERPRET, bk.IMPL = old


def _bn_input(seed, shape):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 2 + 0.5).astype(np.float32)


def test_k4_moments_match_pallas(pallas_bn):
    """moments / grad_moments plain versions vs the Pallas kernels
    (interpret) on 2,500 rows, not a multiple of the kernel's 1,024-row
    tile; f32 sums of 2,500 terms in another order."""
    x = _bn_input(0, (2500, 24))
    g = _bn_input(1, (2500, 24))
    mean = _bn_input(2, (24,))
    inv = np.abs(_bn_input(3, (24,))) + 0.1
    for got, want in zip(tbn.moments(_t(x)), bk.moments(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-3)
    got = tbn.grad_moments(_t(g), _t(x), _t(mean), _t(inv))
    want = bk.grad_moments(*map(jnp.asarray, (g, x, mean, inv)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-3)


def _nchw(x_nhwc, layout):
    """An NHWC numpy array as the port's (B, C, H, W) tensor in a memory
    format: channels-last (the conv outputs) or NCHW-contiguous."""
    t = _t(x_nhwc).permute(0, 3, 1, 2)
    return t.contiguous() if layout == 'nchw' else t


@pytest.mark.parametrize('layout', ['rows', 'channels_last', 'nchw'])
def test_k4_bn_train_matches_jax(pallas_bn, layout):
    """bn_train: y, batch mean / biased var, and the gradients of x, scale
    and bias vs the JAX bn_train custom VJP (Pallas moments, interpret)."""
    x = _bn_input(4, (2, 9, 11, 16))
    gy = _bn_input(5, x.shape)
    scale = np.random.RandomState(6).uniform(0.5, 1.5, 16).astype(np.float32)
    bias = np.random.RandomState(7).randn(16).astype(np.float32)

    def jf(x2, s, b):
        y, mean, var = bk.bn_train(x2, s, b, 1e-3, None)
        return jnp.sum(y * jnp.asarray(gy.reshape(-1, 16))), (y, mean, var)

    (_, (y, mean, var)), grads = jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x.reshape(-1, 16)), jnp.asarray(scale), jnp.asarray(bias))
    if layout == 'rows':
        xt, gt = _t(x.reshape(-1, 16)), _t(gy.reshape(-1, 16))
    else:
        xt, gt = _nchw(x, layout), _nchw(gy, layout)
    xt.requires_grad_(True)
    st, bt = _t(scale).requires_grad_(True), _t(bias).requires_grad_(True)
    yt, mt, vt = tbn.bn_train(xt, st, bt, 1e-3)
    dx, ds, db = torch.autograd.grad((yt * gt).sum(), (xt, st, bt))
    rows = lambda t: tbn._channels_last_2d(t.detach()).numpy()  # noqa: E731
    np.testing.assert_allclose(rows(yt), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(var), rtol=1e-5)
    np.testing.assert_allclose(rows(dx), np.asarray(grads[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(grads[1]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(grads[2]), rtol=1e-4,
                               atol=1e-4)
    assert not mt.requires_grad and not vt.requires_grad


def test_k4_layout_strides():
    """_layout's (rows, C, S, batch stride, spatial stride, channel stride)
    address every element of the activation in the formats the kernel
    reads; a layout three strides cannot describe raises."""
    b, c, h, w = 2, 5, 3, 4
    base = torch.arange(b * c * h * w, dtype=torch.float32)
    wide = torch.arange(24 * 2 * c, dtype=torch.float32).view(24, 2 * c)
    cases = [base.view(b, h, w, c).permute(0, 3, 1, 2),       # channels-last
             base.view(b, c, h, w),                            # NCHW
             base.view(b * h * w, c),                          # (M, C)
             wide[:, 3:3 + c],                                 # column slice
             base[:b * c * w].view(b, c, 1, w),                # H = 1
             base[:b * c * h].view(b, 1, h, c).permute(0, 3, 2, 1)]  # W = 1
    for x in cases:
        m, cc, s, sb, ss, sc = tbn._layout(x)
        rows = tbn._channels_last_2d(x)
        assert (m, cc) == tuple(rows.shape)
        r = torch.arange(m)[:, None]
        off = (r // s) * sb + (r % s) * ss + torch.arange(cc) * sc
        size = x.untyped_storage().nbytes() // 4 - x.storage_offset()
        flat = torch.as_strided(x, (size,), (1,), x.storage_offset())
        assert torch.equal(flat[off], rows), x.stride()
    with pytest.raises(ValueError):
        tbn._layout(base.view(b, c, w, h).transpose(2, 3))
    with pytest.raises(TypeError):
        tbn._layout(base.double().view(b * h * w, c))


@pytest.mark.parametrize('rows,plane,per', [
    (214272, 53568, 3348),          # the largest BN on channel planes
    (214272, 214272, 837),          # ... channels innermost
    (13392, 3348, 2048),            # the smallest BN, bf16 planes
    (5550, 1850, 1024),             # odd plane length
    (3 * 7, 7, 1024),               # short planes: grouped, ragged group
    (1000, 1000, 64),               # rows path, one plane
    (17, 17, 1),                    # one row a chunk
    (0, 0, 1024)])                  # no rows
def test_k4_chunking_covers_rows(rows, plane, per):
    """K4's chunking: each row of a channel in exactly one chunk, no chunk
    over ``per`` rows but by a whole plane, the partial count bounded by
    2 * rows / per + 1, and the same chunking for the same numbers."""
    ch = tbn.chunking(rows, plane, per)
    assert ch == tbn.chunking(rows, plane, per)
    assert ch.count <= 2 * rows / per + 1
    seen = np.zeros(rows, np.int64)
    for k in range(ch.count):
        ranges = tbn.chunk_rows(ch, k, plane, rows)
        assert sum(stop - start for start, stop in ranges) <= max(per, plane)
        for start, stop in ranges:
            seen[start:stop] += 1
    assert (seen == 1).all()


def test_k4_chunking_is_a_function_of_the_shape():
    """The kernel's plan for a tensor depends on its shape, type and
    layout, not on its values; the main path's channels-last activations
    take the vectorized rows path in f32 and bf16, NCHW ones the planes
    path (an unaligned start too), each with a bounded number of partial
    sums."""
    shape = (4, 256, 62, 54)
    a = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    b = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    assert tbn.kernel_plan(a) == tbn.kernel_plan(b)
    assert tbn.kernel_plan(a, b).chunks == tbn.kernel_plan(a).chunks
    for dtype in (torch.float32, torch.bfloat16):
        p = tbn.kernel_plan(a.to(dtype))
        assert p.path == 'planes'
        assert p.c * p.chunks.count <= 2 * tbn.PLANE_CHUNKS
        cl = a.to(dtype).contiguous(memory_format=torch.channels_last)
        p = tbn.kernel_plan(cl)
        assert p.path == 'rows-vector'
        assert -(-p.c // tbn.ROW_GROUP) * p.chunks.count <= tbn.ROW_BLOCKS
    flat = torch.zeros(1 + a.numel())
    assert tbn.kernel_plan(flat[1:].view(shape)).path == 'planes'


@pytest.mark.parametrize('case,path', [
    ('nchw', 'planes'),
    ('channels_last', 'rows-vector'),
    ('rows', 'rows-vector'),
    ('slice', 'rows-scalar'),
    ('g_channels_last', 'planes'),
    ('x_channels_last', 'rows-scalar'),
    ('g_offset', 'planes'),
    ('strided_w', 'planes')])
def test_k4_kernel_plan_paths(case, path):
    """The path K4 takes for each layout, and the strides it is given still
    address every element of x and g in row order."""
    b, c, h, w = 2, 8, 3, 5
    nhwc = torch.arange(b * h * w * c, dtype=torch.float32).view(b, h, w, c)
    nchw = nhwc.permute(0, 3, 1, 2).contiguous()
    cl = nhwc.permute(0, 3, 1, 2)
    wide = torch.zeros(b, c, h, 2 * w)
    wide[..., ::2] = nchw
    g = None
    x = {'nchw': nchw, 'channels_last': cl, 'rows': nhwc.reshape(-1, c),
         'slice': torch.cat([nhwc.reshape(-1, c)] * 2, 1)[:, 3:3 + c],
         'g_channels_last': nchw, 'x_channels_last': cl, 'g_offset': nchw,
         'strided_w': wide[..., ::2]}[case]
    if case == 'g_channels_last':
        g = cl
    elif case == 'x_channels_last':
        g = nchw
    elif case == 'g_offset':
        g = torch.zeros(1 + nchw.numel())[1:].view(nchw.shape)
        g.copy_(nchw)
    p = tbn.kernel_plan(x, g)
    assert p.path == path
    rows = tbn._channels_last_2d(x)
    r = torch.arange(p.rows)[:, None]
    for t, (sb, ss, sc) in ((x, p.x), (x if g is None else g, p.g)):
        off = (r // p.plane) * sb + (r % p.plane) * ss + torch.arange(p.c) * sc
        size = t.untyped_storage().nbytes() // 4 - t.storage_offset()
        flat = torch.as_strided(t, (size,), (1,), t.storage_offset())
        assert torch.equal(flat[off], rows)


def _splat_runs_brute(ids, rows, halves, grid):
    """The splat's block runs by their definition: block b starts at the
    least key row k with halves * k + R(k) >= b * total // grid, or at the
    end; total = halves * rows + len(ids)."""
    ids = np.asarray(ids)
    total = halves * rows + ids.size

    def below(k):
        return int((ids < k).sum())
    cost = [halves * k + below(k) for k in range(rows + 1)]
    first = [next((k for k in range(rows + 1)
                   if cost[k] >= total * b // grid), rows)
             for b in range(grid + 1)]
    return first, [below(k) for k in first], cost


@pytest.mark.parametrize('kind,rows,halves,grid', [
    ('uniform', 5000, 1, 7),
    ('packed', 5000, 1, 7),          # every row in the first tiles
    ('falloff', 5000, 1, 7),         # density falling along the canvas
    ('none', 5000, 1, 7),            # no live row
    ('pairs', 2500, 2, 5),           # K7: up to two rows a key row
    ('one_tile', 100, 1, 1)])
def test_splat_runs_cut_by_cost(kind, rows, halves, grid):
    """The runs the splat kernel's blocks take (``splat_runs``, the
    kernel's formula): equal to their definition, covering every key row
    and every live row once in order, and no block's cost (half-rows
    written plus rows read) over its share by more than one key row's."""
    rng = np.random.RandomState(21)
    n = rows // 5
    keys = {'uniform': lambda: rng.choice(rows, n, replace=False),
            'packed': lambda: np.arange(n),
            'falloff': lambda: rng.choice(
                rows, n, replace=False,
                p=(w := 1 / (1 + np.arange(rows)) ** 2) / w.sum()),
            'none': lambda: np.zeros(0, np.int64),
            'pairs': lambda: np.repeat(rng.choice(rows, n, replace=False),
                                       rng.randint(1, 3, n)),
            'one_tile': lambda: np.arange(0, rows, 3)}[kind]()
    ids = np.concatenate([np.sort(keys), [rows, rows, rows + 3]])
    first, below = tvx.splat_runs(torch.from_numpy(ids.astype(np.int32)),
                                  rows, halves, grid)
    want_first, want_below, cost = _splat_runs_brute(ids, rows, halves, grid)
    assert first.tolist() == want_first
    assert below.tolist() == want_below
    assert first[0] == 0 and first[-1] == rows
    assert bool((first.diff() >= 0).all())
    assert below[-1] == int((ids < rows).sum())
    block = np.diff(np.asarray(cost)[first.numpy()])
    # a key row costs its halves plus at most two rows read; the shares
    # count the rows past the canvas too
    assert block.max() <= (halves * rows + ids.size) / grid + 1 + halves + 2


@pytest.mark.parametrize('layout', ['channels_last', 'nchw'])
def test_batchnorm2d_train_matches_fast_batchnorm(pallas_bn, layout):
    """The port's BatchNorm2d in training vs FastBatchNorm (Pallas moments,
    interpret): output, gradients and the running statistics (0.99 old +
    0.01 batch, biased variance); eval reads the new running statistics."""
    x = _bn_input(8, (2, 10, 12, 8))
    gy = _bn_input(9, x.shape)
    rng = np.random.RandomState(10)
    params = {'scale': rng.uniform(0.5, 1.5, 8).astype(np.float32),
              'bias': rng.randn(8).astype(np.float32)}
    stats = {'mean': rng.randn(8).astype(np.float32),
             'var': rng.uniform(0.5, 2, 8).astype(np.float32)}
    fast = bk.FastBatchNorm(use_running_average=False)

    def jf(p, xx):
        y, aux = fast.apply({'params': p, 'batch_stats': stats}, xx,
                            mutable=['batch_stats'])
        return jnp.sum(y * jnp.asarray(gy)), (y, aux['batch_stats'])

    (_, (y, new_stats)), (gp, gx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    bn = tbb.BatchNorm2d(8, eps=1e-3).train()
    with torch.no_grad():
        bn.weight.copy_(_t(params['scale']))
        bn.bias.copy_(_t(params['bias']))
        bn.running_mean.copy_(_t(stats['mean']))
        bn.running_var.copy_(_t(stats['var']))
    xt = _nchw(x, layout).requires_grad_(True)
    yt = bn(xt)
    dx, dw, db = torch.autograd.grad((yt * _nchw(gy, layout)).sum(),
                                     (xt, bn.weight, bn.bias))
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()  # noqa: E731
    np.testing.assert_allclose(nhwc(yt), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(dx), np.asarray(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(gp['scale']),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(gp['bias']), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new_stats['mean']), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new_stats['var']), rtol=1e-6)
    bn.eval()
    want = fast.clone(use_running_average=True).apply(
        {'params': params, 'batch_stats': new_stats}, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(bn(_nchw(x, layout))),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)


def test_masked_batchnorm_train_matches_jax():
    """MaskedBatchNorm in training: statistics over the masked rows only,
    the same running update, gradients of x, scale and bias."""
    rng = np.random.RandomState(12)
    x = (rng.randn(400, 16) * 3 + 1).astype(np.float32)
    mask = rng.rand(400) > 0.3
    gy = rng.randn(400, 16).astype(np.float32)
    params = {'scale': rng.uniform(0.5, 1.5, 16).astype(np.float32),
              'bias': rng.randn(16).astype(np.float32)}
    stats = {'mean': rng.randn(16).astype(np.float32),
             'var': rng.uniform(0.5, 2, 16).astype(np.float32)}
    jbn = jve.MaskedBatchNorm()

    def jf(p, xx):
        y, aux = jbn.apply({'params': p, 'batch_stats': stats}, xx,
                           mask=jnp.asarray(mask), use_running_average=False,
                           mutable=['batch_stats'])
        return jnp.sum(y * jnp.asarray(gy)), (y, aux['batch_stats'])

    (_, (y, new_stats)), (gp, gx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    bn = tve.MaskedBatchNorm(16).train()
    with torch.no_grad():
        bn.weight.copy_(_t(params['scale']))
        bn.bias.copy_(_t(params['bias']))
        bn.running_mean.copy_(_t(stats['mean']))
        bn.running_var.copy_(_t(stats['var']))
    xt = _t(x).requires_grad_(True)
    yt = bn(xt, _t(mask)[:, None])
    dx, dw, db = torch.autograd.grad((yt * _t(gy)).sum(),
                                     (xt, bn.weight, bn.bias))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    for got, key in ((dw, 'scale'), (db, 'bias')):
        np.testing.assert_allclose(got.numpy(), np.asarray(gp[key]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new_stats['mean']), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new_stats['var']), rtol=1e-6)
