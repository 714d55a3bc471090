"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; every test is marked ``gpu`` and skips where
there is no card.  This file imports neither JAX nor the JAX package, so on
a machine without JAX run it without the repository's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from mmdet3d_gaussian_tpu_torch.ops import _cuda
from mmdet3d_gaussian_tpu_torch.ops import nms, rotated_iou, segment
from mmdet3d_gaussian_tpu_torch.ops import voxelize

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


@pytest.mark.parametrize('k', [100, 1500])
def test_nms_sweep_kernel(cuda, k):
    """K = 1500 exceeds one block's threads: columns loop."""
    rng = np.random.RandomState(3)
    m = rng.rand(2, k, k).astype(np.float32) * 0.35
    valid = rng.rand(2, k) > 0.1
    iou, valid = torch.from_numpy(m), torch.from_numpy(valid)
    want = nms.suppress_sweep_plain(iou, valid, 0.3)
    got = nms.suppress_sweep(iou.to(cuda), valid.to(cuda), 0.3)
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) < int(valid.sum())


def test_wrapper_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError, match='different devices'):
        voxelize.bev_splat(torch.zeros(4, 4, device=cuda),
                           torch.zeros(4, dtype=torch.int32), 8)
