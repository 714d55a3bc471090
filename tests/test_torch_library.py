"""The predict path's kernels as registered ops (``ops/library.py``):
``torch.library.opcheck`` on CPU inputs of each (schema, fake
implementation, autograd registration, AOT dispatch), a CPU, a CUDA and a
fake implementation registered for each and none for another device, the
wrappers calling the op and equal to the plain versions, no launch counted
on the CPU, and the graph helper naming the ops an FX graph calls."""
import numpy as np
import pytest
import torch
from torch.library import opcheck

from mmdet3d_gaussian_tpu_torch.ops import _cuda, library
from mmdet3d_gaussian_tpu_torch.ops import nms, rotated_iou, segment
from mmdet3d_gaussian_tpu_torch.ops import voxelize


def _segments(n_rows, v, c, seed):
    """Sorted rows of v segments (some empty), their ids, starts, counts;
    rows past the live ones carry the trash id v."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, 4, v).astype(np.int32)
    counts[:1] = 0
    live = int(counts.sum())
    n = max(n_rows, live)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    ids = np.full(n, v, np.int32)
    ids[:live] = np.repeat(np.arange(v, dtype=np.int32), counts)
    data = rng.normal(size=(n, c)).astype(np.float32)
    t = torch.from_numpy
    return t(data), t(ids), t(starts), t(counts)


def _splat_rows(v, c, ncell, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    lin = np.sort(rng.choice(ncell + 8, v, replace=False)).astype(np.int32)
    feats = torch.from_numpy(rng.normal(size=(v, c)).astype(np.float32))
    return feats.to(dtype), torch.from_numpy(lin)


def _pair_rows(v, c, ncell2, seed):
    rng = np.random.RandomState(seed)
    half = np.sort(rng.choice(2 * ncell2 + 6, v, replace=False))
    lin2 = (half // 2).astype(np.int32)
    par = (half % 2).astype(np.int32)
    feats = torch.from_numpy(rng.normal(size=(v, c)).astype(np.float32))
    return feats, torch.from_numpy(lin2), torch.from_numpy(par)


def _boxes(p, k, seed):
    rng = np.random.RandomState(seed)
    b = np.concatenate([rng.uniform(-5, 5, (p, k, 2)),
                        rng.uniform(0.5, 3, (p, k, 2)),
                        rng.uniform(-np.pi, np.pi, (p, k, 1))], -1)
    return torch.from_numpy(b.astype(np.float32))


def _cases():
    data, ids, starts, counts = _segments(40, 12, 8, 0)
    e_data, e_ids, e_starts, e_counts = _segments(0, 0, 4, 1)
    feats, lin = _splat_rows(20, 6, 64, 2)
    f16, lin16 = _splat_rows(20, 6, 64, 3, torch.bfloat16)
    pf, lin2, par = _pair_rows(16, 4, 24, 4)
    boxes = _boxes(3, 9, 5)
    iou = rotated_iou.iou_bev_pairwise_plain(boxes)
    valid = torch.from_numpy(np.random.RandomState(6).rand(3, 9) > 0.2)
    return [
        ('segment_reduce', (data, starts, counts, 'sum')),
        ('segment_reduce', (data, starts, counts, 'max')),
        ('segment_reduce', (e_data, e_starts, e_counts, 'max')),
        ('segment_reduce_mapback', (data, ids, starts, counts, 'sum')),
        ('segment_reduce_mapback', (data, ids, starts, counts, 'max')),
        ('bev_splat', (feats, lin, 64)),
        ('bev_splat', (f16, lin16, 64)),
        ('bev_splat_pairs', (pf, lin2, par, 24)),
        ('rotated_iou', (boxes,)),
        ('rotated_iou', (boxes[:, :0].contiguous(),)),
        ('nms_sweep', (iou, valid, 0.1)),
        ('nms_sweep', (iou, valid, 0.7)),
    ]


CASES = _cases()


@pytest.mark.parametrize('name,args', CASES,
                         ids=[f'{n}-{i}' for i, (n, _) in enumerate(CASES)])
def test_opcheck(name, args):
    opcheck(library.op(name), args)


PLAIN = {
    'segment_reduce': (segment.segment_reduce,
                       segment.segment_reduce_plain),
    'segment_reduce_mapback': (segment.segment_reduce_mapback,
                               segment.segment_reduce_mapback_plain),
    'bev_splat': (voxelize.bev_splat, voxelize.bev_splat_plain),
    'bev_splat_pairs': (voxelize.bev_splat_pairs,
                        voxelize.bev_splat_pairs_plain),
    'rotated_iou': (rotated_iou.iou_bev_pairwise,
                    rotated_iou.iou_bev_pairwise_plain),
    'nms_sweep': (nms.suppress_sweep, nms.suppress_sweep_plain),
}


@pytest.mark.parametrize('name,args', CASES,
                         ids=[f'{n}-{i}' for i, (n, _) in enumerate(CASES)])
def test_wrapper_is_the_op_and_equals_plain(name, args):
    """The public wrapper goes through the op (an FX trace of it holds
    the op's node), equals the plain version on the CPU, and counts no
    launch there."""
    wrapper, plain = PLAIN[name]
    _cuda.reset_launches()
    got = wrapper(*args)
    assert torch.equal(got, plain(*args))
    assert not any(_cuda.LAUNCHES.values())
    tensors = [a for a in args if isinstance(a, torch.Tensor)]

    def call(*ts):
        it = iter(ts)
        return wrapper(*[next(it) if isinstance(a, torch.Tensor) else a
                         for a in args])
    gm = torch.fx.experimental.proxy_tensor.make_fx(call)(*tensors)
    assert library.ops_in_graph(gm.graph) == [f'mmdet3d_torch::{name}']


@pytest.mark.parametrize('name', sorted(library.OPS))
def test_implementations_registered(name):
    """A CPU and a CUDA kernel and a fake implementation; no kernel for
    any other backend, so nothing else reaches the plain version."""
    qualified = f'mmdet3d_torch::{name}'
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(qualified, 'CPU') and has(qualified, 'CUDA')
    assert has(qualified, 'Meta')     # the fake implementation
    for other in ('XPU', 'MPS', 'CompositeImplicitAutograd',
                  'CompositeExplicitAutograd'):
        assert not has(qualified, other), other
    assert name in _cuda.KERNELS


def test_wrappers_still_check_inputs():
    """The op's implementations keep the wrappers' argument checks."""
    data, ids, starts, counts = _segments(10, 4, 4, 7)
    with pytest.raises(ValueError, match='op must be one of'):
        segment.segment_reduce(data, starts, counts, 'mean')
    with pytest.raises(TypeError, match='ids must be torch.int32'):
        segment.segment_reduce_mapback(data, ids.long(), starts, counts,
                                       'sum')
    feats, lin = _splat_rows(8, 4, 16, 8)
    with pytest.raises(ValueError, match='contiguous'):
        voxelize.bev_splat(feats.t().contiguous().t(), lin, 16)
    with pytest.raises(TypeError, match='boxes must be torch.float32'):
        rotated_iou.iou_bev_pairwise(_boxes(1, 4, 9).double())
    # on meta tensors (the fake implementation checks too: no memory)
    with pytest.raises(ValueError, match='exceeds the sweep limit'):
        nms.suppress_sweep(torch.empty(1, 24577, 24577, device='meta'),
                           torch.empty(1, 24577, dtype=torch.bool,
                                       device='meta'), 0.5)
