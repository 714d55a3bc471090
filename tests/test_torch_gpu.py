"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; every test is marked ``gpu`` and skips where
there is no card.  This file imports neither JAX nor the JAX package, so on
a machine without JAX run it without the repository's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from mmdet3d_gaussian_tpu_torch.engine import detector
from mmdet3d_gaussian_tpu_torch.ops import _cuda, bn, gd_loss
from mmdet3d_gaussian_tpu_torch.ops import nms, rotated_iou, scatter, segment
from mmdet3d_gaussian_tpu_torch.ops import voxelize

from .torch_k5_boxes import adversarial_boxes, cluster_boxes
from .torch_k6_iou import CASES as K6_CASES
from .torch_k6_iou import THRESHOLDS as K6_THRESHOLDS
from .torch_k6_iou import adversarial as k6_adversarial

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _segments(seed, v, c, max_count, trash):
    """Sorted rows of v segments (some empty, some long) + a trash tail."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, max_count + 1, v).astype(np.int32)
    counts[rng.rand(v) < 0.2] = 0
    live = counts[counts > 0]
    counts = np.concatenate([live, np.zeros(v - live.size, np.int32)])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    starts = np.maximum.accumulate(np.where(counts > 0, starts, 0))
    ids = np.concatenate([np.repeat(np.arange(v), counts),
                          np.full(trash, v)]).astype(np.int32)
    data = rng.randn(ids.size, c).astype(np.float32)
    return [torch.from_numpy(a) for a in (data, ids, starts, counts)]


@pytest.mark.parametrize('op', ['sum', 'max'])
@pytest.mark.parametrize('c', [4, 64, 7])
def test_segment_kernels(cuda, op, c):
    data, ids, starts, counts = _segments(0, 3000, c, 40, 77)
    want = segment.segment_reduce_plain(data, starts, counts, op)
    want_m = segment.segment_reduce_mapback_plain(data, ids, starts, counts,
                                                  op)
    args = [t.to(cuda) for t in (data, starts, counts)]
    before = dict(_cuda.LAUNCHES)
    got = segment.segment_reduce(*args, op)
    got_m = segment.segment_reduce_mapback(data.to(cuda), ids.to(cuda),
                                           *args[1:], op)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['segment_reduce'] == before['segment_reduce'] + 1
    tol = 0 if op == 'max' else 1e-4
    assert float((got.cpu() - want).abs().max()) <= tol
    assert float((got_m.cpu() - want_m).abs().max()) <= tol


@pytest.mark.parametrize('c', [64, 6])
def test_bev_splat_kernel(cuda, c):
    rng = np.random.RandomState(1)
    ncell, v, nval = 50000 + 37, 9000, 8000
    lin = np.full(v, ncell + 3, np.int32)
    lin[:nval] = np.sort(rng.choice(ncell, nval, replace=False))
    feats = torch.from_numpy(rng.randn(v, c).astype(np.float32))
    lin = torch.from_numpy(lin)
    want = voxelize.bev_splat_plain(feats, lin, ncell)
    got = voxelize.bev_splat(feats.to(cuda), lin.to(cuda), ncell)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize('c', [64, 6])
def test_bev_splat_kernel_bf16(cuda, c):
    """K2 on bf16 rows writes a bf16 canvas, equal to the plain version."""
    rng = np.random.RandomState(7)
    ncell, v, nval = 30000 + 11, 6000, 5000
    lin = np.full(v, ncell + 1, np.int32)
    lin[:nval] = np.sort(rng.choice(ncell, nval, replace=False))
    feats = torch.from_numpy(rng.randn(v, c).astype(np.float32)).bfloat16()
    lin = torch.from_numpy(lin)
    want = voxelize.bev_splat_plain(feats, lin, ncell)
    got = voxelize.bev_splat(feats.to(cuda), lin.to(cuda), ncell)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), want)


def _pair_rows(seed, ncell2, v, c, npairs, nsingle):
    """Sorted paired-cell ids (some cells with both parities), rows past
    ncell2 at the tail."""
    rng = np.random.RandomState(seed)
    cells = np.sort(rng.choice(ncell2, npairs + nsingle, replace=False))
    ids, par = [], []
    for k, cell in enumerate(cells):
        for p in ((0, 1) if k < npairs else (rng.randint(2),)):
            ids.append(cell)
            par.append(p)
    tail = v - len(ids)
    ids += list(ncell2 + np.arange(tail) // 2)
    par += list(np.arange(tail) % 2)
    return (torch.from_numpy(rng.randn(v, c).astype(np.float32)),
            torch.tensor(ids, dtype=torch.int32),
            torch.tensor(par, dtype=torch.int32))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', [
    dict(ncell2=40000, v=9000, c=64, npairs=3000, nsingle=2500),
    dict(ncell2=40000 + 77, v=9000, c=64, npairs=3000, nsingle=2500),
    dict(ncell2=5000 + 3, v=3000, c=6, npairs=1000, nsingle=900),
    dict(ncell2=1000, v=0, c=64, npairs=0, nsingle=0)],
    ids=['divisible', 'ragged', 'narrow', 'empty'])
def test_bev_splat_pairs_kernel(cuda, dtype, case):
    """K7 against its plain version: equal canvas, one launch."""
    feats, lin2, par = _pair_rows(8, **case)
    feats = feats.to(dtype)
    ncell2 = case['ncell2']
    want = voxelize.bev_splat_pairs_plain(feats, lin2, par, ncell2)
    before = _cuda.LAUNCHES['bev_splat_pairs']
    got = voxelize.bev_splat_pairs(feats.to(cuda), lin2.to(cuda),
                                   par.to(cuda), ncell2)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['bev_splat_pairs'] == before + 1
    assert got.dtype == dtype and got.shape == (ncell2, 2 * case['c'])
    assert torch.equal(got.cpu(), want)
    assert int(torch.count_nonzero(want)) == (2 * case['npairs']
                                              + case['nsingle']) * case['c']


def test_rotated_iou_kernel(cuda):
    rng = np.random.RandomState(2)
    p, k = 3, 300
    ctr = rng.uniform(0, 70, (p, k // 5, 2))
    xy = np.take_along_axis(ctr, rng.randint(0, k // 5, (p, k))[..., None],
                            1) + rng.normal(0, 0.5, (p, k, 2))
    boxes = np.concatenate([xy, rng.uniform(0.5, 4.5, (p, k, 2)),
                            rng.uniform(-np.pi, np.pi, (p, k, 1))], -1)
    boxes = torch.from_numpy(boxes.astype(np.float32))
    want = rotated_iou.iou_bev_pairwise_plain(boxes.to(cuda)).cpu()
    got = rotated_iou.iou_bev_pairwise(boxes.to(cuda)).cpu()
    assert (want > 0.01).any()
    assert float((got - want).abs().max()) <= 1e-5


def _check_k5(boxes, cuda):
    """K5 on ``boxes`` against its plain version: within 1e-5 everywhere
    (NaN where it is NaN), exactly equal on every far pair (exactly 0 where
    both sizes are >= 0); one launch, bitwise repeatable.  -> near mask."""
    boxes = torch.as_tensor(boxes).to(cuda)
    want = rotated_iou.iou_bev_pairwise_plain(boxes)
    near = rotated_iou.near_pairs_plain(boxes)
    before = _cuda.LAUNCHES['rotated_iou']
    got = rotated_iou.iou_bev_pairwise(boxes)
    again = rotated_iou.iou_bev_pairwise(boxes)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['rotated_iou'] == before + (2 if got.numel()
                                                        else 0)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got.isnan(), want.isnan())
    fin = ~want.isnan()
    if fin.any():
        assert float((got[fin] - want[fin]).abs().max()) <= 1e-5
    far = ~near
    assert torch.equal(got[far], want[far])
    sized = (boxes[..., 2] >= 0) & (boxes[..., 3] >= 0)
    assert not got[far & sized[:, :, None] & sized[:, None, :]].any()
    return near.cpu()


@pytest.mark.parametrize('region', ['origin', 'range_corners'])
def test_rotated_iou_cull_adversarial(cuda, region):
    """Pairs at R_a + R_b +- 1e-4 edge to edge and corner to corner,
    zero-size, thin, equal, negative-width and NaN boxes."""
    boxes = torch.from_numpy(adversarial_boxes(0, region))
    near = _check_k5(boxes, cuda)[0]
    assert near[-1].all()                      # the NaN box
    assert not near.all()


@pytest.mark.parametrize('k', [1, 33, 1000, 1500])
def test_rotated_iou_tiles(cuda, k):
    """Tiles of 64 x 128 boxes, part-filled at the edges; K not a multiple
    of 4 takes 4-byte stores."""
    _check_k5(torch.from_numpy(cluster_boxes(k, 2, k, spread=20.0)), cuda)


@pytest.mark.parametrize('shape', [(0, 16), (3, 0)])
def test_rotated_iou_empty(cuda, shape):
    boxes = torch.zeros(shape + (5,), device=cuda)
    before = _cuda.LAUNCHES['rotated_iou']
    out = rotated_iou.iou_bev_pairwise(boxes)
    assert out.shape == (shape[0], shape[1], shape[1])
    assert _cuda.LAUNCHES['rotated_iou'] == before


def test_rotated_iou_all_near(cuda):
    """Centres in a 0.5 m square, sides of at least 0.6 m: every pair in
    full."""
    rng = np.random.RandomState(6)
    p, k = 2, 700
    xy = 35.0 + rng.uniform(-0.25, 0.25, (p, k, 2))
    wh = rng.uniform([0.6, 0.6], [4.5, 2.0], (p, k, 2))
    yaw = rng.uniform(-np.pi, np.pi, (p, k, 1))
    boxes = np.concatenate([xy, wh, yaw], -1).astype(np.float32)
    assert _check_k5(torch.from_numpy(boxes), cuda).all()


def test_rotated_iou_overflowed_sizes(cuda):
    """Boxes whose decoded sizes overflowed, as an eval-mode predict gives
    early in training: inf, inf x 0, 0 and 1e25 sides among ordinary boxes.
    NaN exactly where the plain version is NaN (an inf area minus an inf
    area), equal elsewhere."""
    boxes = cluster_boxes(8, 2, 64, spread=5.0)
    boxes[:, ::5, 2] = np.inf
    boxes[:, 1::7, 3] = 0.0
    boxes[:, 2::9, 2:4] = 1e25
    boxes[:, 3::11, 2:4] = [np.inf, 0.0]
    want = rotated_iou.iou_bev_pairwise_plain(torch.from_numpy(boxes))
    assert want.isnan().any() and (~want.isnan()).any()
    _check_k5(torch.from_numpy(boxes), cuda)


def test_rotated_iou_none_near(cuda):
    """Boxes 10 m apart on a grid: only a box and itself are near."""
    g = np.stack(np.meshgrid(np.arange(40) * 10.0, np.arange(30) * 10.0
                             - 150.0), -1).reshape(1, -1, 2)
    rng = np.random.RandomState(7)
    k = g.shape[1]
    boxes = np.concatenate([g, rng.uniform(0.5, 4.5, (1, k, 2)),
                            rng.uniform(-np.pi, np.pi, (1, k, 1))], -1)
    near = _check_k5(torch.from_numpy(boxes.astype(np.float32)), cuda)
    assert torch.equal(near[0], torch.eye(k, dtype=torch.bool))


@pytest.mark.parametrize('k', [100, 1500, 4100])
def test_nms_sweep_kernel(cuda, k):
    """K = 1500: 24 words a row; K = 4100: 65 words, several a lane, a
    partial last word.  One launch a call."""
    rng = np.random.RandomState(3)
    m = rng.rand(2, k, k).astype(np.float32) * 0.35
    valid = rng.rand(2, k) > 0.1
    iou, valid = torch.from_numpy(m), torch.from_numpy(valid)
    want = nms.suppress_sweep_plain(iou, valid, 0.3)
    before = _cuda.LAUNCHES['nms_sweep']
    got = nms.suppress_sweep(iou.to(cuda), valid.to(cuda), 0.3)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['nms_sweep'] == before + 1
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) < int(valid.sum())


@pytest.mark.parametrize('k', [1, 31, 65, 1500])
@pytest.mark.parametrize('case', K6_CASES)
def test_nms_sweep_kernel_adversarial(cuda, case, k):
    """The adversarial matrices (``tests/torch_k6_iou.py``: ties at f32(thr)
    and one ulp either side, NaN/inf/-0.0, all or none above, the chain,
    invalid suppressors) at the configs' three thresholds; K = 1, 31 and 65
    take the scalar loads (K % 4 != 0), 1500 the 16-byte ones."""
    for thr in K6_THRESHOLDS:
        iou, valid = k6_adversarial(case, k, thr, seed=k)
        iou, valid = torch.from_numpy(iou), torch.from_numpy(valid)
        want = nms.suppress_sweep_plain(iou, valid, thr)
        got = nms.suppress_sweep(iou.to(cuda), valid.to(cuda), thr)
        assert torch.equal(got.cpu(), want), (case, thr)


def test_nms_sweep_kernel_limit(cuda):
    """P = 1 at K = 24,576, the wrapper's limit: the sweep stages the packed
    triangle a few row blocks at a time (the first alone takes 192 KB)."""
    k = 24 * 1024
    gen = torch.Generator(device=cuda).manual_seed(0)
    iou = torch.rand(1, k, k, device=cuda, generator=gen) * 0.3003
    valid = torch.rand(1, k, device=cuda, generator=gen) > 0.1
    want = nms.suppress_sweep_plain(iou, valid, 0.3)
    got = nms.suppress_sweep(iou, valid, 0.3)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < int(valid.sum())
    with pytest.raises(ValueError, match='sweep limit'):
        nms.suppress_sweep(torch.zeros(1, k + 1, k + 1, device=cuda),
                           torch.ones(1, k + 1, dtype=torch.bool,
                                      device=cuda), 0.3)


@pytest.mark.parametrize('shape', [(0, 16), (3, 0)])
def test_nms_sweep_kernel_empty(cuda, shape):
    p, k = shape
    got = nms.suppress_sweep(torch.zeros(p, k, k, device=cuda),
                             torch.ones(p, k, dtype=torch.bool, device=cuda),
                             0.3)
    assert got.shape == (p, k) and got.device.type == 'cuda'


def test_wrapper_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError, match='different devices'):
        voxelize.bev_splat(torch.zeros(4, 4, device=cuda),
                           torch.zeros(4, dtype=torch.int32), 8)


def test_segment_argmax_kernel(cuda):
    """K1 winner form: max and winner mask equal to the plain version, on
    small integer data (many ties), a NaN, empty segments, a trash
    tail."""
    data, ids, starts, counts = _segments(4, 2000, 64, 30, 50)
    data = torch.round(data)
    data[5, 3] = float('nan')
    want, want_m = segment.segment_max_winner_plain(data, ids, starts,
                                                    counts)
    before = _cuda.LAUNCHES['segment_max_winner']
    got, got_m = segment.segment_max_winner(
        *(t.to(cuda) for t in (data, ids, starts, counts)))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['segment_max_winner'] == before + 1
    assert torch.equal(got.cpu().nan_to_num(7.5), want.nan_to_num(7.5))
    assert torch.equal(got_m.cpu(), want_m)
    assert not bool(want_m[-50:].any())       # the trash tail
    assert int(want_m.sum()) < int(counts.sum()) * 64


K1_CASES = ('ties', 'long', 'unaligned', 'empty', 'v0', 'n0')
K1_WIDTHS = (1, 3, 4, 7, 64, 65)


def _k1_case(case, c, seed=3):
    """(data, ids, starts, counts) on the CPU: small integers (ties) with
    NaN, +-inf and +-0.0 sprinkled in; 'long' adds a 5,000-row segment
    (kept free of NaN), 'empty' has only empty segments and a trash tail,
    'v0' no segment, 'n0' no row."""
    rng = np.random.RandomState(seed + c)
    if case in ('empty', 'v0', 'n0'):
        v = 0 if case == 'v0' else 40
        n = 0 if case == 'n0' else 37
        counts = np.zeros(v, np.int32)
        starts = np.zeros(v, np.int32)
        ids = np.full(n, v, np.int32)
    else:
        v = 600
        counts = rng.randint(0, 12, v).astype(np.int32)
        counts[rng.rand(v) < 0.2] = 0
        if case == 'long':
            counts[7] = 5000
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        starts = np.maximum.accumulate(np.where(counts > 0, starts, 0))
        ids = np.concatenate([np.repeat(np.arange(v), counts),
                              np.full(29, v)])
        n = ids.size
    data = np.round(rng.randn(n, c) * 2).astype(np.float32)
    u = rng.rand(n, c)
    data[u < 0.004] = np.nan
    data[(u >= 0.004) & (u < 0.008)] = np.inf
    data[(u >= 0.008) & (u < 0.012)] = -np.inf
    data[(u >= 0.012) & (u < 0.05)] = -0.0
    if case == 'long':
        s = starts[7]
        rows = data[s:s + 5000]
        rows[np.isnan(rows)] = 1.0
    return [torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.int32 if a.dtype != np.float32 else torch.float32)
        for a in (data, ids, starts.astype(np.int32), counts)]


def _k1_on_card(case, c, cuda):
    data, ids, starts, counts = _k1_case(case, c)
    if case == 'unaligned':
        # a view 4 bytes past a 16-byte boundary: the single-float body
        base = torch.empty(data.numel() + 1, device=cuda)
        dev_data = base[1:].view(data.shape)
        dev_data.copy_(data)
        assert not segment.vectorized(dev_data)
    else:
        dev_data = data.to(cuda)
        assert segment.vectorized(dev_data) == (c % 4 == 0)
    return (data, ids, starts, counts), (dev_data, ids.to(cuda),
                                         starts.to(cuda), counts.to(cuda))


def _same(a, b):
    """Equal, NaN where the other is NaN (+0.0 == -0.0)."""
    a = a.cpu()
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.where(a.isnan(), 0.0, a),
                            torch.where(b.isnan(), 0.0, b)))


def _one_launch(name, before, out):
    torch.cuda.synchronize()
    want = 1 if out.numel() else 0
    assert _cuda.LAUNCHES[name] == before + want


@pytest.mark.parametrize('op', ['sum', 'max'])
@pytest.mark.parametrize('c', K1_WIDTHS)
@pytest.mark.parametrize('case', K1_CASES)
def test_segment_reduce_adversarial(cuda, case, c, op):
    """K1 reduce form against its plain version: max exact, sums within
    1e-4, one launch (none for V = 0)."""
    (data, _ids, starts, counts), dev = _k1_on_card(case, c, cuda)
    want = segment.segment_reduce_plain(data, starts, counts, op)
    before = _cuda.LAUNCHES['segment_reduce']
    got = segment.segment_reduce(dev[0], dev[2], dev[3], op)
    _one_launch('segment_reduce', before, got)
    if op == 'max':
        assert _same(got, want)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4,
                                   equal_nan=True)


@pytest.mark.parametrize('op', ['sum', 'max'])
@pytest.mark.parametrize('c', K1_WIDTHS)
@pytest.mark.parametrize('case', K1_CASES)
def test_segment_mapback_adversarial(cuda, case, c, op):
    """K1 mapback form against its plain version (trash rows 0): max
    exact, sums within 1e-4, one launch (none for N = 0)."""
    (data, ids, starts, counts), dev = _k1_on_card(case, c, cuda)
    want = segment.segment_reduce_mapback_plain(data, ids, starts, counts,
                                                op)
    before = _cuda.LAUNCHES['segment_reduce_mapback']
    got = segment.segment_reduce_mapback(*dev, op)
    _one_launch('segment_reduce_mapback', before, got)
    if op == 'max':
        assert _same(got, want)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4,
                                   equal_nan=True)


@pytest.mark.parametrize('c', K1_WIDTHS)
@pytest.mark.parametrize('case', K1_CASES)
def test_segment_max_winner_adversarial(cuda, case, c):
    """K1 winner form against its plain version: the max and the winner
    mask exact, one launch (none when V = N = 0)."""
    (data, ids, starts, counts), dev = _k1_on_card(case, c, cuda)
    want, want_m = segment.segment_max_winner_plain(data, ids, starts,
                                                    counts)
    before = _cuda.LAUNCHES['segment_max_winner']
    got, got_m = segment.segment_max_winner(*dev)
    _one_launch('segment_max_winner', before,
                got if got.numel() else got_m)
    assert _same(got, want)
    assert got_m.dtype == torch.bool and torch.equal(got_m.cpu(), want_m)


def _bn_layouts(cuda, b=3, c=64, h=37, w=50):
    x = torch.randn(b, h, w, c, generator=torch.Generator().manual_seed(5))
    x = (x * 2 + 0.5).to(cuda)
    cl = x.permute(0, 3, 1, 2)
    return {'channels_last': cl, 'nchw': cl.contiguous(),
            'rows': x.reshape(-1, c), 'slice': torch.cat(
                [x.reshape(-1, c), x.reshape(-1, c)], 1)[:, 7:7 + c]}


@pytest.mark.parametrize('layout', ['channels_last', 'nchw', 'rows', 'slice'])
def test_bn_moment_kernels(cuda, layout):
    """K4 forward and backward moments in each layout the kernel reads,
    against the plain version; f32 sums in another order, held to 1e-5 of
    the sum of magnitudes; repeated launches are bitwise equal."""
    x = _bn_layouts(cuda)[layout]
    g = torch.randn_like(x)
    mean, inv = x.new_full((64,), 0.4), x.new_full((64,), 0.7)
    for got, want, mag in (
            (bn.moments(x), bn.moments_plain(x),
             (bn._channels_last_2d(x).abs().sum(0),
              (bn._channels_last_2d(x) ** 2).sum(0))),
            (bn.grad_moments(g, x, mean, inv),
             bn.grad_moments_plain(g, x, mean, inv),
             (bn._channels_last_2d(g).abs().sum(0),
              bn._channels_last_2d(g * (x - 0.4) * 0.7).abs().sum(0)))):
        for a, b_, m in zip(got, want, mag):
            assert bool(((a - b_).abs() <= 1e-5 * m).all())
    again = bn.moments(x)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, bn.moments(x)))


@pytest.mark.parametrize('layout', ['channels_last', 'nchw', 'rows'])
def test_bn_moment_kernels_bf16(cuda, layout):
    """K4 on bf16 activations (f32 sums) against the plain version, held to
    1e-5 of the per-channel sum of magnitudes."""
    x = _bn_layouts(cuda)[layout].bfloat16()
    g = torch.randn(x.shape, device=cuda).bfloat16()
    if layout == 'channels_last':
        g = g.contiguous(memory_format=torch.channels_last)
    mean, inv = x.new_full((64,), 0.4).float(), x.new_full((64,), 0.7).float()
    xr, gr = bn._channels_last_2d(x).float(), bn._channels_last_2d(g).float()
    for got, want, mag in (
            (bn.moments(x), bn.moments_plain(x),
             (xr.abs().sum(0), (xr ** 2).sum(0))),
            (bn.grad_moments(g, x, mean, inv),
             bn.grad_moments_plain(g, x, mean, inv),
             (gr.abs().sum(0), (gr * (xr - 0.4) * 0.7).abs().sum(0)))):
        for a, b_, m in zip(got, want, mag):
            assert a.dtype == torch.float32
            assert bool(((a - b_).abs() <= 1e-5 * m).all())


# K4 test cases: shape, memory format of x and g ('nchw' or 'cl', channels
# last), whether both start one element past a 16-byte boundary, and the
# path the kernel must take
_BN_CASES = {
    'odd': ((3, 24, 37, 51), 'nchw', 'nchw', False, 'planes'),
    'offset': ((2, 16, 29, 31), 'nchw', 'nchw', True, 'planes'),
    'smallest': ((4, 256, 62, 54), 'nchw', 'nchw', False, 'planes'),
    'largest': ((4, 64, 248, 216), 'nchw', 'nchw', False, 'planes'),
    'cl_smallest': ((4, 256, 62, 54), 'cl', 'cl', False, 'rows-vector'),
    'cl_largest': ((4, 64, 248, 216), 'cl', 'cl', False, 'rows-vector'),
    'cl_ragged_group': ((3, 96, 37, 51), 'cl', 'cl', False, 'rows-vector'),
    'cl_offset': ((2, 64, 29, 31), 'cl', 'cl', True, 'rows-scalar'),
    'g_channels_last': ((2, 32, 37, 50), 'nchw', 'cl', False, 'planes'),
    'x_channels_last': ((2, 32, 37, 50), 'cl', 'nchw', False, 'rows-scalar'),
}


def _bn_case(cuda, case, dtype):
    """x and g of one K4 test case on the card (the step's smallest
    BatchNorm is 13,392 x 256, its largest 214,272 x 64; its convolutions
    write channels last), and the path K4 must take."""
    shape, fx, fg, offset, path = _BN_CASES[case]
    b, c, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(11)
    n = b * c * h * w
    out = []
    for fmt, scale, shift in ((fx, 2.0, 0.5), (fg, 1.0, 0.0)):
        flat = (torch.randn(n + 1, device=cuda, generator=gen) * scale
                + shift).to(dtype)[int(offset):][:n]
        out.append(flat.view(b, h, w, c).permute(0, 3, 1, 2) if fmt == 'cl'
                   else flat.view(shape))
    return out[0], out[1], path


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', list(_BN_CASES))
def test_bn_moment_kernels_paths(cuda, case, dtype):
    """K4 on each path: the path the layout takes, both moments
    against the plain version within 1e-5 of the per-channel sum of
    magnitudes, and bitwise equal over repeated launches, in both
    directions and types."""
    x, g, path = _bn_case(cuda, case, dtype)
    c = x.shape[1]
    assert bn.kernel_plan(x, g).path == path
    mean = torch.linspace(-0.5, 0.5, c, device=cuda)
    inv = torch.linspace(0.5, 1.5, c, device=cuda)
    xr, gr = bn._channels_last_2d(x).float(), bn._channels_last_2d(g).float()
    for kern, plain, args, mag in (
            (bn.moments, bn.moments_plain, (x,),
             (xr.abs().sum(0), (xr ** 2).sum(0))),
            (bn.grad_moments, bn.grad_moments_plain, (g, x, mean, inv),
             (gr.abs().sum(0), (gr * (xr - mean) * inv).abs().sum(0)))):
        got = kern(*args)
        for a, b_, m in zip(got, plain(*args), mag):
            assert a.dtype == torch.float32
            assert bool(((a - b_).abs() <= 1e-5 * m).all())
        for _ in range(3):
            assert all(torch.equal(a, b_) for a, b_ in zip(got, kern(*args)))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_bn_moment_kernels_one_launch(cuda, dtype):
    """Each K4 call runs one kernel on the card (the second level is folded
    into it) and counts one launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, g, _ = _bn_case(cuda, 'odd', dtype)
    mean = torch.zeros(x.shape[1], device=cuda)
    inv = torch.ones(x.shape[1], device=cuda)
    for name, fn in (('bn_moments', lambda: bn.moments(x)),
                     ('bn_grad_moments',
                      lambda: bn.grad_moments(g, x, mean, inv))):
        fn()
        torch.cuda.synchronize()
        before = _cuda.LAUNCHES[name]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        assert len(kernels) == 1, kernels
        assert _cuda.LAUNCHES[name] == before + 1


def _falloff_keys(rows, v, rng):
    """``v`` distinct key rows of a KITTI b4 canvas of ``rows`` rows, 432
    to a line (K2: 496 lines of cells; K7: 248 lines of paired cells),
    drawn with weight 1 / r^2, r the distance from the sensor (the middle
    of each sample's first column): a LiDAR sweep's density falling with
    range."""
    per = rows // 4
    iy, ix = np.divmod(np.arange(per), 432)
    r2 = np.maximum((ix + 0.5) ** 2 + (iy + 0.5 - per / 864) ** 2, 1.0)
    w = np.tile(1 / r2, 4)
    return np.sort(rng.choice(rows, v, replace=False, p=w / w.sum()))


def _splat_ids(kind, rows, tile, v, rng):
    """Sorted unique key rows for a splat test: 'runs' of full tiles and of
    empty tiles around random cells; 'packed' every key row from the
    first; 'falloff' density falling as 1 / r^2; else random."""
    if kind == 'runs':
        full = [np.arange(a * tile, min(rows, (a + n) * tile))
                for a, n in ((0, 3), (40, 5), (rows // tile - 2, 3))]
        sparse = rng.choice(np.arange(45 * tile, (rows // tile - 2) * tile),
                            v, replace=False)        # tiles 3-39 empty
        keys = np.concatenate(full + [sparse, [rows - 1]])
    elif kind == 'packed':
        keys = np.arange(v)
    elif kind == 'falloff':
        keys = _falloff_keys(rows, v, rng)
    else:
        keys = rng.choice(rows, v, replace=False)
    return np.unique(keys).astype(np.int32)


def _around_runs(keys, ids_of, v, rows, halves, grid):
    """``keys`` with every key row of a band of the canvas added (its rows
    about half of ``v``), so that block runs start inside the band, with
    rows on both sides of their first key row: at least 10 of them, by the
    blocks' runs (``voxelize.splat_runs``) over ``ids_of(keys)`` padded to
    the ``v`` ids the kernel gets."""
    band = np.arange(rows // 3, rows // 3 + v // (2 * halves))
    keys = np.union1d(keys, band).astype(np.int32)
    ids = ids_of(keys)
    ids = np.concatenate([ids, np.full(v - ids.size, rows, ids.dtype)])
    first, _ = voxelize.splat_runs(torch.from_numpy(ids), rows, halves,
                                   grid)
    starts = first[1:-1].numpy()
    inside = np.isin(starts, keys) & np.isin(starts - 1, keys)
    assert int(inside.sum()) >= 10, int(inside.sum())
    return keys


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('kind', ['main', 'runs', 'boundaries', 'packed',
                                  'falloff'])
def test_bev_splat_kernel_persistent(cuda, kind, dtype):
    """K2 with more tiles than the persistent grid (the KITTI b4 canvas,
    857,088 x 64), runs of full and of empty tiles, rows on both sides of
    every block's run of tiles, all rows in the first tiles, and density
    falling with range: equal to the plain version, one launch, 16-byte
    stores with the row width as a shift."""
    rng = np.random.RandomState(12)
    ncell, c = 857088, 64
    feats = torch.from_numpy(rng.randn(70000, c).astype(np.float32)).to(
        dtype).to(cuda)
    plan = voxelize.splat_plan(
        feats, torch.empty((ncell, c), dtype=dtype, device=cuda))
    assert plan['tiles'] > plan['grid'] and plan['vector_bytes'] == 16
    assert plan['shift'] == (4 if dtype == torch.float32 else 3)
    keys = _splat_ids(kind, ncell, 256, 64000 if kind == 'main' else 20000,
                      rng)
    if kind == 'boundaries':
        keys = _around_runs(keys, lambda k: k, feats.shape[0], ncell, 1,
                            plan['grid'])
    lin = np.full(feats.shape[0], ncell + 5, np.int32)
    lin[:keys.size] = keys
    lin = torch.from_numpy(lin).to(cuda)
    before = _cuda.LAUNCHES['bev_splat']
    got = voxelize.bev_splat(feats, lin, ncell)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['bev_splat'] == before + 1
    assert torch.equal(got, voxelize.bev_splat_plain(feats, lin, ncell))


def _pairs(keys):
    """K7 ids of ``keys``: both parities of every key whose hash is even,
    one (by the hash) otherwise, -> (lin2, par)."""
    h = (keys.astype(np.int64) * 2654435761) % 2 ** 32
    both = h % 4 < 2
    lin2 = np.repeat(keys, np.where(both, 2, 1))
    par = np.concatenate([[0, 1] if b else [(h_ >> 7) % 2]
                          for b, h_ in zip(both, h)]).astype(np.int32)
    return lin2, par


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('kind', ['runs', 'boundaries', 'falloff'])
def test_bev_splat_pairs_kernel_persistent(cuda, kind, dtype):
    """K7 on the KITTI b4 s2d canvas (428,544 x 128): runs of full and of
    empty tiles, both parities of paired rows on both sides of every
    block's run of tiles, and density falling with range; equal to the
    plain version."""
    rng = np.random.RandomState(13)
    ncell2, c = 428544, 64
    feats = torch.from_numpy(rng.randn(80000, c).astype(np.float32)).to(
        dtype).to(cuda)
    plan = voxelize.splat_plan(
        feats, torch.empty((ncell2, 2 * c), dtype=dtype, device=cuda), 2)
    assert plan['tiles'] > plan['grid'] and plan['vector_bytes'] == 16
    keys = _splat_ids(kind, ncell2, 128, 15000, rng)
    if kind == 'boundaries':
        keys = _around_runs(keys, lambda k: _pairs(k)[0], feats.shape[0],
                            ncell2, 2, plan['grid'])
    lin2, par = _pairs(keys)
    tail = feats.shape[0] - lin2.size
    lin2 = np.concatenate([lin2, ncell2 + np.arange(tail) // 2])
    par = np.concatenate([par, np.arange(tail) % 2])
    lin2 = torch.from_numpy(lin2.astype(np.int32)).to(cuda)
    par = torch.from_numpy(par.astype(np.int32)).to(cuda)
    got = voxelize.bev_splat_pairs(feats, lin2, par, ncell2)
    want = voxelize.bev_splat_pairs_plain(feats, lin2, par, ncell2)
    assert torch.equal(got, want)
    assert int(torch.count_nonzero(want.abs().sum(1))) == keys.size


@pytest.mark.parametrize('loss_type,fun,tau', [
    ('gwd3d', 'log1p', 1.0), ('kld3d', 'log1p', 1.0), ('kld3d', 'none', 0.0),
    ('jd3d', 'log1p', 1.0), ('kld3d_symmax', 'log1p', 1.0),
    ('kld3d_symmin', 'log1p', 1.0), ('bd3d', 'log1p', 1.0),
    ('kfiou3d', 'expm1', 0.0), ('kfiou3d', 'nlog', 0.0)])
def test_gd_loss_kernels(cuda, loss_type, fun, tau):
    """K3 forward (weighted sum) and backward (d pred) against the plain
    version on the card, for every loss type, pred read as a channel slice
    of a wider conv output."""
    rng = np.random.RandomState(6)
    hw, a, b = 2000, 6, 2
    anc = np.zeros((hw, a, 7), np.float32)
    anc[..., :2] = rng.uniform(-30, 60, (hw, a, 2))
    anc[..., 2] = -1.78
    anc[..., 3:6] = np.array([1.6, 3.9, 1.56]) * rng.uniform(0.8, 1.2,
                                                             (hw, a, 3))
    anc[..., 6] = rng.choice([0.0, np.pi / 2], (hw, a))
    t = lambda arr: torch.from_numpy(arr).to(cuda)  # noqa: E731
    wide = t(rng.randn(b * hw, 128).astype(np.float32) * 0.2)
    pred = wide[:, 18:60]
    tgt = t((rng.randn(b * hw, a * 7) * 0.2).astype(np.float32))
    # weights: 0 on most anchors, positive on ~20 %, negative on ~5 %
    # (pred replaced by the target there: a loss term but no gradient)
    u = rng.rand(b * hw, a)
    w = t((((u < 0.2).astype(np.float32) - (u > 0.95))
           * rng.uniform(0.5, 2, (b * hw, a)))
          .astype(np.float32))
    anc2 = t(anc.reshape(hw, a * 7))
    cfg = (loss_type, (0.0, 0.0, 0.5), fun, tau, 1.0)
    args = (tgt, w, anc2, hw, cfg)
    got = gd_loss.gd_loss_fwd(pred, *args)
    want = gd_loss.anchor_gd_loss_plain(pred, *args)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    gout = torch.tensor(1.7, device=cuda)
    dgot = gd_loss.gd_loss_bwd(gout, pred, *args)
    dwant = gd_loss.gd_loss_bwd_plain(gout, pred, *args)
    torch.testing.assert_close(dgot, dwant, rtol=1e-4, atol=5e-6)
    assert float(dwant.abs().max()) > 0


def _gd_case(case, cuda, seed=7):
    """(pred, tgt, w, anc2, hw, cfg) of the main path's configuration
    (kld3d, log1p, tau 1): 'zero' every weight 0, 'all' every weight > 0
    (more weighted anchors a block than the backward stages in shared
    memory), 'negative' weights of both signs, 'stride48' pred as a channel
    slice with rows 48 floats apart, 'ragged' M not a multiple of the
    backward's rows a block, 'unaligned' the weights 4 bytes past a
    16-byte boundary."""
    rng = np.random.RandomState(seed)
    hw = {'ragged': 1001, 'all': 2500}.get(case, 640)
    a, b = 6, 2
    m = b * hw
    anc = np.zeros((hw, a, 7), np.float32)
    anc[..., :2] = rng.uniform(-30, 60, (hw, a, 2))
    anc[..., 2] = -1.78
    anc[..., 3:6] = np.array([1.6, 3.9, 1.56]) * rng.uniform(0.8, 1.2,
                                                             (hw, a, 3))
    anc[..., 6] = rng.choice([0.0, np.pi / 2], (hw, a))
    t = lambda arr: torch.from_numpy(arr).to(cuda)  # noqa: E731
    width = 48 if case == 'stride48' else 42
    wide = t(rng.randn(m, width).astype(np.float32) * 0.2)
    pred = wide[:, :42] if case == 'stride48' else wide
    tgt = t((rng.randn(m, a * 7) * 0.2).astype(np.float32))
    mag = rng.uniform(0.5, 2, (m, a)).astype(np.float32)
    u = rng.rand(m, a)
    if case == 'zero':
        w = np.zeros((m, a), np.float32)
    elif case == 'all':
        w = mag
    elif case == 'negative':
        w = np.where(u < 0.1, mag, np.where(u > 0.8, -mag, 0.0))
    else:
        w = np.where(u < 0.05, mag, 0.0)
    w = w.astype(np.float32)
    if case == 'unaligned':
        base = torch.empty(w.size + 1, device=cuda)
        w_dev = base[1:].view(m, a)
        w_dev.copy_(torch.from_numpy(w))
        assert w_dev.data_ptr() % 16 == 4
    else:
        w_dev = t(w)
    cfg = ('kld3d', (0.0, 0.0, 0.5), 'log1p', 1.0, 1.0)
    return pred, tgt, w_dev, t(anc.reshape(hw, a * 7)), hw, cfg


@pytest.mark.parametrize('case', ['zero', 'all', 'negative', 'stride48',
                                  'ragged', 'unaligned'])
def test_gd_loss_kernels_adversarial(cuda, case):
    """K3 forward and backward against the plain version on weights of
    every kind, one launch each; the forward bitwise equal over 10 calls."""
    pred, *args = _gd_case(case, cuda)
    assert pred.stride(0) == (48 if case == 'stride48' else 42)
    before = dict(_cuda.LAUNCHES)
    got = gd_loss.gd_loss_fwd(pred, *args)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['gd_loss_fwd'] == before['gd_loss_fwd'] + 1
    want = gd_loss.anchor_gd_loss_plain(pred, *args)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    if case == 'zero':
        assert float(got) == 0.0
    else:
        assert float(want) != 0.0
    assert all(torch.equal(gd_loss.gd_loss_fwd(pred, *args), got)
               for _ in range(10))
    gout = torch.tensor(1.3, device=cuda)
    before = _cuda.LAUNCHES['gd_loss_bwd']
    dgot = gd_loss.gd_loss_bwd(gout, pred, *args)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['gd_loss_bwd'] == before + 1
    dwant = gd_loss.gd_loss_bwd_plain(gout, pred, *args)
    torch.testing.assert_close(dgot, dwant, rtol=1e-4, atol=5e-6)
    nonzero = int(torch.count_nonzero(dwant.abs().sum(1)))
    assert (nonzero == 0) == (case == 'zero')


def test_train_step_card_vs_cpu(cuda):
    """One TINY train step (sparse targets) on the card against the CPU:
    loss terms, every gradient, running statistics, Adam's moments, and the
    updated weights where |mu| is large enough for card and CPU to agree on
    the gradient's sign (Adam moves a weight by about lr whatever |g|)."""
    model = dict(voxel_size=(0.4, 0.4, 4.0),
                 point_cloud_range=(0., -12.8, -3., 25.6, 12.8, 1.),
                 max_voxels_per_sample=1024, voxelize_mode='dynamic',
                 encoder_cfg=dict(in_channels=4, feat_channels=(16,)),
                 backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                                   layer_nums=(1, 1, 1),
                                   layer_strides=(2, 2, 2)),
                 neck_cfg=dict(in_channels=(16, 32, 64),
                               out_channels=(16, 16, 16),
                               upsample_strides=(1, 2, 4)),
                 head_cfg=dict(num_classes=3, num_anchors=6,
                               feat_channels=48))
    out = {}
    for dev in ('cuda', 'cpu'):
        det = detector.PointPillarsDetector(model, device=dev, seed=2)
        batch = detector.synthetic_batch(2, 1024, 8, seed=0,
                                         pc_range=model['point_cloud_range'],
                                         device=dev)
        total, losses = det.loss(det.apply_train(batch), batch)
        params = dict(det.trunk.named_parameters())
        grads = torch.autograd.grad(total, list(params.values()))
        state = det.init_train(1e-3, total_steps=100)
        state, _ = det.train_step(batch, state)
        out[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                    {k: g.cpu() for k, g in zip(params, grads)},
                    {k: v.detach().cpu()
                     for k, v in det.trunk.state_dict().items()},
                    {k: (state.opt_state.mu[k].cpu(),
                         state.opt_state.nu[k].cpu()) for k in params})
    (lc, gc, sc, mc), (lp, gp, sp, mp) = out['cuda'], out['cpu']
    assert min(lp.values()) > 0, lp
    for k in lp:
        assert abs(lc[k] - lp[k]) <= 1e-4 * abs(lp[k]), k
    for k in gp:
        torch.testing.assert_close(gc[k], gp[k], rtol=0,
                                   atol=1e-4 * float(gp[k].abs().max()))
    for k in sp:
        atol = 2.5e-3 if 'running' not in k else 1e-4
        torch.testing.assert_close(sc[k].float(), sp[k].float(), rtol=1e-4,
                                   atol=atol)
    for k, (mu, nu) in mp.items():
        torch.testing.assert_close(mc[k][0], mu, rtol=0,
                                   atol=1e-4 * float(mu.abs().max()))
        torch.testing.assert_close(mc[k][1], nu, rtol=0,
                                   atol=2e-4 * float(nu.abs().max()))
        # lr = 1e-3: a sign flip or a dropped update is ~1e-3 off
        sel = (mu.abs() >= 1e-2 * mu.abs().max()) & (mu.abs() > 1e-6)
        assert bool(sel.any()), k
        torch.testing.assert_close(sc[k][sel], sp[k][sel], rtol=0, atol=1e-5)


HARD_TINY = dict(voxel_size=(0.4, 0.4, 4.0),
                 point_cloud_range=(0., -12.8, -3., 25.6, 12.8, 1.),
                 max_points_per_voxel=16, max_voxels_per_sample=1024,
                 voxelize_mode='hard',
                 encoder_cfg=dict(in_channels=4, feat_channels=(16,)),
                 backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                                   layer_nums=(1, 1, 1),
                                   layer_strides=(2, 2, 2)),
                 neck_cfg=dict(in_channels=(16, 32, 64),
                               out_channels=(16, 16, 16),
                               upsample_strides=(1, 2, 4)),
                 head_cfg=dict(num_classes=3, num_anchors=6,
                               feat_channels=48))


def _crowded(dev):
    """Pillars over max_points and live pillars over max_voxels."""
    return detector.crowded_batch(2, 2048, 8, seed=6,
                                  pc_range=HARD_TINY['point_cloud_range'],
                                  voxel_size=HARD_TINY['voxel_size'],
                                  device=dev)


@pytest.mark.parametrize('dtype', [None, 'bfloat16'], ids=['f32', 'bf16'])
@pytest.mark.parametrize('encoder', ['packed', 'sorted'])
def test_bev_splat_kernel_hard_rows(cuda, encoder, dtype):
    """K2 on the pillar rows of a TINY hard predict (f32 or bf16 rows, in
    canvas raster order, truncated and dropped pillars) equals its plain
    version, in one launch."""
    det = detector.PointPillarsDetector(
        dict(HARD_TINY, hard_encoder=encoder, compute_dtype=dtype),
        device=cuda, seed=3)
    batch = _crowded(cuda)
    with torch.inference_mode():
        feats, coords, scatter = det.trunk.pillars(batch['points'],
                                                   batch['points_mask'])
    assert int(scatter.num_overflow) > 0
    assert feats.dtype == (torch.bfloat16 if dtype else torch.float32)
    b, nx, ny = 2, det.trunk.nx, det.trunk.ny
    ncell = b * ny * nx
    valid = (coords >= 0).all(-1)
    lin = torch.where(valid, (coords[:, 0] * ny + coords[:, 2]) * nx
                      + coords[:, 1], ncell).to(torch.int32)
    assert bool((lin[1:] >= lin[:-1]).all())
    before = dict(_cuda.LAUNCHES)
    got = voxelize.bev_splat(feats.contiguous(), lin, ncell)
    _one_launch('bev_splat', before['bev_splat'], got)
    want = voxelize.bev_splat_plain(feats.cpu(), lin.cpu(), ncell)
    assert torch.equal(got.cpu(), want)


def test_segment_kernels_rank_masked(cuda):
    """K1 on the sorted hard encoder's inputs: the 3-channel cluster sum of
    the kept rows, the 64-channel max of rank-masked rows (-1e4 past each
    pillar's max_points; ties among copies of one point) and its winner
    mask, each against its plain version."""
    det = detector.PointPillarsDetector(
        dict(HARD_TINY, hard_encoder='sorted'), device=cuda, seed=3)
    batch = _crowded(cuda)
    trunk = det.trunk
    b, n, _ = batch['points'].shape
    flat = batch['points'].reshape(b * n, -1)
    coords3, _ = scatter.compute_voxel_coords(
        flat[:, :3], trunk.point_cloud_range, trunk.voxel_size)
    coords4 = scatter.batch_coords(
        coords3, torch.arange(b, device=cuda).repeat_interleave(n))
    max_voxels = trunk.max_voxels_per_sample * b
    sc = scatter.build_scatter(coords4, (b, trunk.nx, trunk.ny, 1),
                               max_voxels,
                               key_order=voxelize.CANVAS_KEY_ORDER)
    sv = sc.sorted_view()
    kept = voxelize.hard_kept_rows(sv.point_voxel_ids, max_voxels, 16)
    assert int((~kept & (sv.point_voxel_ids < max_voxels)).sum()) > 0
    rows = flat[sc.sort_order]
    xyz = (rows[:, :3] * kept[:, None]).contiguous()
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn((4, 64), device=cuda, generator=gen)
    # rows of copies of one point are equal, rounding ties others
    y = torch.where(kept[:, None], (rows @ w).round(), -1e4).contiguous()
    args = (sv.point_voxel_ids, sc.sorted_starts, sc.voxel_counts)
    assert not segment.vectorized(xyz) and segment.vectorized(y)
    got = segment.segment_reduce(xyz, args[1], args[2], 'sum')
    want = segment.segment_reduce_plain(xyz.cpu(), args[1].cpu(),
                                        args[2].cpu(), 'sum')
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-4)
    got = segment.segment_reduce(y, args[1], args[2], 'max')
    assert torch.equal(got.cpu(), segment.segment_reduce_plain(
        y.cpu(), args[1].cpu(), args[2].cpu(), 'max'))
    out, mask = segment.segment_max_winner(y, *args)
    ref, ref_m = segment.segment_max_winner_plain(*(t.cpu() for t in
                                                    (y,) + args))
    assert torch.equal(out.cpu(), ref) and torch.equal(mask.cpu(), ref_m)


def _centerpoint_candidates(seed, p=24, k=128):
    """P problems of K score-sorted CenterPoint candidates (B x 6 tasks of
    ``max_per_img`` 128): centres clustered over +-50 m as the heatmap's
    top cells are (neighbouring cells of one peak), nuScenes sizes."""
    rng = np.random.RandomState(seed)
    peaks = rng.uniform(-50, 50, (p, k // 8, 2))
    pick = rng.randint(0, k // 8, (p, k))
    xy = np.take_along_axis(peaks, pick[..., None], 1) + rng.normal(
        0, 0.6, (p, k, 2))
    wl = rng.uniform(0.4, 12.0, (p, k, 2))
    yaw = rng.uniform(-np.pi, np.pi, (p, k, 1))
    boxes = np.concatenate([xy, wl, yaw], -1).astype(np.float32)
    valid = rng.rand(p, k) > 0.2
    return torch.from_numpy(boxes), torch.from_numpy(valid)


def test_centerpoint_rotate_nms_k128(cuda):
    """K5 and K6 at the CenterPoint predict's shape, B = 4 x 6 tasks of
    K = 128 (two 64-row tiles, two 64-bit words a row): the IoU within
    1e-5 of its plain version, the keep mask of ``nms_bev`` (one launch of
    each) equal to the plain chain's."""
    boxes, valid = _centerpoint_candidates(7)
    want_iou = rotated_iou.iou_bev_pairwise_plain(boxes.to(cuda)).cpu()
    got_iou = rotated_iou.iou_bev_pairwise(boxes.to(cuda)).cpu()
    assert float((got_iou - want_iou).abs().max()) <= 1e-5
    want = nms.suppress_sweep_plain(want_iou, valid, 0.2)
    before = dict(_cuda.LAUNCHES)
    got = nms.nms_bev(boxes.to(cuda), 0.2, valid.to(cuda))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['rotated_iou'] == before['rotated_iou'] + 1
    assert _cuda.LAUNCHES['nms_sweep'] == before['nms_sweep'] + 1
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < int(valid.sum())


@pytest.mark.parametrize('min_radius', [0.175, 1.0, 4.0, 12.0])
def test_circle_nms_kernel(cuda, min_radius):
    """Circle NMS through K6 (negated squared distances, a negative
    threshold) at K = 128 over 24 problems: the keep mask equal to the
    plain sweep's on the CPU, one launch."""
    boxes, valid = _centerpoint_candidates(8)
    centers = boxes[..., :2].contiguous()
    want = nms.circle_nms(centers, min_radius, valid)
    before = _cuda.LAUNCHES['nms_sweep']
    got = nms.circle_nms(centers.to(cuda), min_radius, valid.to(cuda))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['nms_sweep'] == before + 1
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < int(valid.sum())


def _nus_head_maps(yaw, seed, b=4, hw=128):
    """The nuScenes center head and a batch of its maps at the config's
    full shapes (B = 4, 128 x 128 cells, 6 tasks of 1, 2, 2, 1, 2, 2
    classes, k = 128): a few cells a class over the score threshold,
    codes of nuScenes-sized boxes."""
    mc = detector.NUS_CENTERPOINT_MODEL
    head = detector.CenterHead(**dict(
        detector.NUS_CENTERPOINT_HEAD, yaw_mode=yaw,
        pc_range=mc['point_cloud_range'], voxel_size=mc['voxel_size']))
    g = torch.Generator().manual_seed(seed)
    maps = []
    for task in head.tasks:
        m = {name: torch.randn(b, hw, hw, c, generator=g)
             for name, (c, _) in head.common_heads.items()}
        m['reg'] = torch.rand(b, hw, hw, 2, generator=g)
        m['dim'] = m['dim'] * 0.5 + 0.5
        m['heatmap'] = torch.randn(b, hw, hw, task['num_classes'],
                                   generator=g) - 5.5
        maps.append(m)
    return head, maps


@pytest.mark.parametrize('yaw', [False, True], ids=['rot', 'yaw'])
def test_center_decode_syncs_nothing(cuda, yaw):
    """``CenterHead.get_bboxes`` at the nuScenes config's full shapes runs
    under ``torch.cuda.set_sync_debug_mode('error')`` without raising (no
    host-to-device copy, no read of the card's data), launches K5 and K6
    once each, and equals the CPU decode of the same maps: labels and
    valid equal, scores within 1e-6, boxes within 1e-5 of their scale."""
    head, maps = _nus_head_maps(yaw, 11)
    want = head.get_bboxes(maps)
    dev_maps = [{n: v.to(cuda) for n, v in m.items()} for m in maps]
    torch.cuda.synchronize()
    before = dict(_cuda.LAUNCHES)
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = head.get_bboxes(dev_maps)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = [x.cpu() for x in got]
    assert _cuda.LAUNCHES['rotated_iou'] == before['rotated_iou'] + 1
    assert _cuda.LAUNCHES['nms_sweep'] == before['nms_sweep'] + 1
    assert got[0].shape == want[0].shape == (4, 83, 9)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert 0 < int(want[3].sum()) < want[3].numel()
    assert float((got[1] - want[1]).abs().max()) <= 1e-6
    scale = max(float(want[0].abs().max()), 1.0)
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_bev_splat_more_rows_than_cells(cuda, dtype):
    """K2 on the MVF cylindrical view's shape: 64,000 rows (the model's
    capacity, not the view's) onto 4 x 32 x 411 = 52,608 cells, an odd
    width; 20,000 live rows on sorted unique cells, the rest trash (lin ==
    ncell): equal to its plain version, one launch."""
    rng = np.random.RandomState(3)
    ncell, v, nval = 4 * 32 * 411, 64000, 20000
    lin = np.full(v, ncell, np.int32)
    lin[:nval] = np.sort(rng.choice(ncell, nval, replace=False))
    feats = torch.from_numpy(rng.randn(v, 64).astype(np.float32)).to(dtype)
    lin = torch.from_numpy(lin)
    want = voxelize.bev_splat_plain(feats, lin, ncell)
    before = _cuda.LAUNCHES['bev_splat']
    got = voxelize.bev_splat(feats.to(cuda), lin.to(cuda), ncell)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['bev_splat'] == before + 1
    assert torch.equal(got.cpu(), want)


# tests/test_torch_mvf.py's TINY MVF model (a 64 x 48 BEV canvas, a 39 x 11
# cylindrical one), written out: this file imports no JAX
TINY_MVF_PCR = (0., -9.6, -3., 25.6, 9.6, 1.)
TINY_MVF = dict(
    voxel_size=(0.4, 0.4, 4.0), point_cloud_range=TINY_MVF_PCR,
    max_voxels_per_sample=1024, voxelize_mode='mvf',
    encoder_cfg=dict(in_channels=4, feat_channels=16,
                     views=('cartesian', 'cylindrical'),
                     voxel_size=((0.4, 0.4, 4.0), (0.04, 0.4, 40.0)),
                     point_cloud_range=(TINY_MVF_PCR,
                                        (-0.78, -3.0, 0.0, 0.78, 1.4,
                                         40.0))),
    backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                      layer_nums=(1, 1, 1), layer_strides=(2, 2, 2)),
    neck_cfg=dict(in_channels=(16, 32, 64), out_channels=(16, 16, 16),
                  upsample_strides=(1, 2, 4)),
    head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=48))


def test_tiny_mvf_predict_card_vs_cpu(cuda):
    """The TINY MVF predict on the card against the port on the CPU (the
    same weights): head maps within 1e-4 of their largest value, the keep
    masks and labels equal, boxes within 1e-4 of their scale; K1 reduce 3
    and mapback 4, K2 3 launches a predict."""
    head = dict(test_cfg=dict(use_rotate_nms=True, nms_thr=0.01,
                              score_thr=0.05, nms_pre=128, max_num=32))
    dets = {}
    for dev in ('cpu', cuda):
        det = detector.PointPillarsDetector(TINY_MVF, head, device=dev,
                                            seed=4)
        with torch.no_grad():
            det.trunk.bbox_head.conv_cls.bias.fill_(-2.0)
        dets[str(dev)] = det
    batch = detector.synthetic_batch(2, 1024, 8, seed=1,
                                     pc_range=TINY_MVF_PCR, device='cpu')
    want_maps = dets['cpu'].apply_eval(batch)[:3]
    want = dets['cpu'].predict(batch)
    _cuda.reset_launches()
    gbatch = {k: v.to(cuda) for k, v in batch.items()}
    got = dets['cuda'].predict(gbatch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    assert launches == {'segment_reduce': 3, 'segment_reduce_mapback': 4,
                        'bev_splat': 3, 'rotated_iou': 1, 'nms_sweep': 1}
    for g, w in zip(dets['cuda'].apply_eval(gbatch)[:3], want_maps):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())
    boxes, scores, labels, valid = (t.cpu() for t in got)
    assert torch.equal(valid, want[3]) and torch.equal(labels, want[2])
    assert bool(valid.any())
    scale = max(float(want[0][valid].abs().max()), 1.0)
    assert float((boxes[valid] - want[0][valid]).abs().max()) <= 1e-4 * scale


# the TINY PV-RCNN of tests/test_pvrcnn.py (repeated: that file imports JAX)
TINY_PVRCNN = dict(
    voxel_size=(0.4, 0.4, 0.1667),
    point_cloud_range=(0., -6.4, -2., 12.8, 6.4, 2.),
    max_voxels=512, sparse_shape=(24, 32, 32), base_channels=8,
    encoder_channels=((8,), (16, 16), (16, 16), (16, 16)),
    encoder_out_channels=16,
    backbone=dict(in_channels=16, out_channels=(16, 32),
                  layer_nums=(1, 1), layer_strides=(1, 2)),
    neck=dict(in_channels=(16, 32), out_channels=(16, 16),
              upsample_strides=(1, 2)),
    num_keypoints=32, vsa_out_channels=32,
    voxel_sa_configs=[
        dict(scale_factor=1, in_channels=8, pool_radius=(0.8,),
             samples=(8,), mlps=((8, 8),)),
        dict(scale_factor=2, in_channels=16, pool_radius=(1.6,),
             samples=(8,), mlps=((8, 8),))],
    rawpoint_sa_config=dict(in_channels=1, pool_radius=(0.8,),
                            samples=(8,), mlps=((8, 8),)),
    bev_sa=True, num_proposals=16, grid_size=3, roi_pool_radius=(0.8,),
    roi_samples_per_radius=(8,), roi_mlps=((16, 16),))
TINY_RPN = dict(
    anchor_generator=dict(ranges=[[0.2, -6.2, -1.0, 12.6, 6.2, -1.0]] * 3,
                          sizes=[[0.8, 0.6, 1.7], [1.8, 0.6, 1.7],
                                 [3.9, 1.6, 1.6]],
                          rotations=[0.0, 1.57]),
    test_cfg=dict(use_rotate_nms=True, nms_thr=0.8, score_thr=0.0,
                  nms_pre=64, max_num=16))


@pytest.mark.parametrize('k,thr', [(512, 0.8), (128, 0.1)])
def test_pvrcnn_nms_shapes(cuda, k, thr):
    """K5 and K6 at PV-RCNN's two NMS shapes, B = 4 problems of the RPN's
    512 class-agnostic candidates (thr 0.8) and of the 128 refined RoIs
    (thr 0.1): the IoU within 1e-5 of its plain version, ``nms_bev``'s
    keep (one launch of each) equal to the plain chain's."""
    rng = np.random.RandomState(k)
    p = 4
    ctr = rng.uniform([0, -40], [70.4, 40], (p, k // 4, 2))
    ctr = np.repeat(ctr, 4, 1) + rng.randn(p, k, 2) * 0.3
    size = np.array([3.9, 1.6]) * rng.uniform(0.8, 1.2, (p, k, 2))
    yaw = rng.choice([0.0, 1.57], (p, k)) + rng.randn(p, k) * 0.1
    boxes = torch.from_numpy(np.concatenate(
        [ctr, size, yaw[..., None]], -1).astype(np.float32))
    valid = torch.from_numpy(rng.rand(p, k) > 0.05)
    want_iou = rotated_iou.iou_bev_pairwise_plain(boxes.to(cuda)).cpu()
    got_iou = rotated_iou.iou_bev_pairwise(boxes.to(cuda)).cpu()
    assert float((got_iou - want_iou).abs().max()) <= 1e-5
    want = nms.suppress_sweep_plain(want_iou, valid, thr)
    before = dict(_cuda.LAUNCHES)
    got = nms.nms_bev(boxes.to(cuda), thr, valid.to(cuda))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['rotated_iou'] == before['rotated_iou'] + 1
    assert _cuda.LAUNCHES['nms_sweep'] == before['nms_sweep'] + 1
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < int(valid.sum())


def test_tiny_pvrcnn_integers_card_vs_cpu(cuda):
    """The TINY PV-RCNN on the card and on the CPU (the same weights):
    voxel coords, every sparse level's sites and overflow, the FPS
    keypoints and the ball queries of the raw-point and level-0 SA equal;
    the predict's keep and labels equal, its boxes within 1e-4 of their
    scale; K1 once, K5 and K6 twice a predict."""
    from mmdet3d_gaussian_tpu_torch.engine.pvrcnn import PVRCNNDetector
    from mmdet3d_gaussian_tpu_torch.ops import vsa
    batch = detector.synthetic_batch(2, 1024, 4, seed=3,
                                     pc_range=TINY_PVRCNN[
                                         'point_cloud_range'], device='cpu')
    got = {}
    for dev in ('cpu', cuda):
        det = PVRCNNDetector(TINY_PVRCNN, TINY_RPN, device=dev, seed=2)
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.inference_mode():
            feats, coords = det.voxelize(b)
            levels = det.trunk.first(feats, coords, 2)[0]
            enc = det.trunk.second.keypoints_encoder
            kp_idx, kp = enc.keypoints(b['points'], b['points_mask'])
            raw = vsa.ball_query(0.8, 8, b['points'][..., :3], kp,
                                 b['points_mask'])
            l0 = levels[0]
            mask = l0.valid[None] & (l0.coords[None, :, 0] == torch.arange(
                2, device=l0.coords.device)[:, None])
            centers = enc.voxel_centers(l0.coords[:, 1:4], 1)
            _, q0 = enc.voxel_sa_0.group(0.8, 8, centers, l0.feats, kp, mask)
            _cuda.reset_launches()
            pred = det.predict(b)
            if dev != 'cpu':
                torch.cuda.synchronize()
                launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        got[str(dev)] = [t.cpu() for t in (
            coords, *[x for lv in levels for x in (lv.coords, lv.keys,
                                                   lv.overflow)],
            kp_idx, raw, q0, *pred)]
    assert launches == {'segment_reduce': 1, 'rotated_iou': 2,
                        'nms_sweep': 2}
    cpu, card = got['cpu'], got['cuda']
    for i, (g, w) in enumerate(zip(card[:-4], cpu[:-4])):
        assert torch.equal(g, w), i
    boxes, scores, labels, valid = card[-4:]
    assert torch.equal(valid, cpu[-1]) and torch.equal(labels, cpu[-2])
    scale = max(float(cpu[-4].abs().max()), 1.0)
    assert float((boxes - cpu[-4]).abs().max()) <= 1e-4 * scale
