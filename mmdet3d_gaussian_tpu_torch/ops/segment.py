"""Sorted-segment sum / max (kernel K1, ``csrc/segment_reduce.cu``).

Port of ``mmdet3d_gaussian_tpu/ops/pallas/segment_kernel.py`` as used by
``sorted_reduce`` and ``sorted_reduce_mapback``: rows sorted by segment id,
segment ``v`` is the row range ``[starts[v], starts[v] + counts[v])``,
reductions accumulate in f32.

* :func:`segment_reduce` -> ``(V, C)``, one row per segment, empty
  segments 0.
* :func:`segment_reduce_mapback` -> ``(N, C)``, every row of a live segment
  receives its segment's value; rows whose id is outside ``[0, V)`` (invalid
  points, the trash segment) receive 0.

Each wrapper computes its plain PyTorch version for CPU tensors and launches
the CUDA kernel for CUDA tensors; there is no fallback between the two.
"""
from __future__ import annotations

import torch

from . import _cuda

_OPS = ('sum', 'max')


def _check_op(op: str) -> int:
    if op not in _OPS:
        raise ValueError(f'op must be one of {_OPS}, got {op!r}')
    return int(op == 'max')


def segment_reduce_plain(data, starts, counts, op: str):
    """Plain version of :func:`segment_reduce` (same rules)."""
    _check_op(op)
    v, c = counts.shape[0], data.shape[1]
    dev = data.device
    cnt = counts.long()
    # (segment, row) of every member row, segment-major, rows ascending
    seg = torch.repeat_interleave(torch.arange(v, device=dev), cnt)
    offs = torch.cumsum(cnt, 0) - cnt
    row = starts.long()[seg] + torch.arange(seg.shape[0], device=dev) \
        - offs[seg]
    rows = data.float()[row]
    out = torch.zeros((v, c), dtype=torch.float32, device=dev)
    if op == 'sum':
        out.index_add_(0, seg, rows)
    else:
        out.scatter_reduce_(0, seg[:, None].expand(-1, c), rows, 'amax',
                            include_self=False)
    return torch.where((counts > 0)[:, None], out, 0.0)


def segment_reduce_mapback_plain(data, ids, starts, counts, op: str):
    """Plain version of :func:`segment_reduce_mapback` (same rules)."""
    v = counts.shape[0]
    per_seg = segment_reduce_plain(data, starts, counts, op)
    padded = torch.cat([per_seg, per_seg.new_zeros((1, per_seg.shape[1]))])
    valid = (ids >= 0) & (ids < v)
    return padded[torch.where(valid, ids.long(), v)]


def _check_common(data, starts, counts):
    _cuda.check_tensor(data, 'data', torch.float32, (None, None))
    _cuda.check_tensor(starts, 'starts', torch.int32, (None,))
    _cuda.check_tensor(counts, 'counts', torch.int32, (starts.shape[0],))


def segment_reduce(data: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor, op: str) -> torch.Tensor:
    """Per-segment ``op`` ('sum' | 'max') of sorted rows -> ``(V, C)`` f32.

    data (N, C) f32 contiguous; starts, counts (V,) int32 (first sorted row
    and row count of each segment; empty segments have count 0)."""
    is_max = _check_op(op)
    _check_common(data, starts, counts)
    dev = _cuda.same_device(data, starts, counts)
    if dev.type == 'cpu':
        return segment_reduce_plain(data, starts, counts, op)
    v, c = counts.shape[0], data.shape[1]
    out = torch.empty((v, c), dtype=torch.float32, device=dev)
    if out.numel():
        _cuda.launch('segment_reduce', dev, data.data_ptr(),
                     starts.data_ptr(), counts.data_ptr(), out.data_ptr(),
                     v, c, is_max)
    return out


def segment_reduce_mapback(data: torch.Tensor, ids: torch.Tensor,
                           starts: torch.Tensor, counts: torch.Tensor,
                           op: str) -> torch.Tensor:
    """Per-row full-segment ``op`` -> ``(N, C)`` f32; rows with an id
    outside ``[0, V)`` get 0.

    ids (N,) int32 ascending, consistent with starts/counts (row r with
    id v lies in ``[starts[v], starts[v] + counts[v])``)."""
    is_max = _check_op(op)
    _check_common(data, starts, counts)
    _cuda.check_tensor(ids, 'ids', torch.int32, (data.shape[0],))
    dev = _cuda.same_device(data, ids, starts, counts)
    if dev.type == 'cpu':
        return segment_reduce_mapback_plain(data, ids, starts, counts, op)
    n, c = data.shape
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    if out.numel():
        _cuda.launch('segment_reduce_mapback', dev, data.data_ptr(),
                     ids.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                     out.data_ptr(), n, counts.shape[0], c, is_max)
    return out
