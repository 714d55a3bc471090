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
* :func:`segment_max_winner` (the winner form, ``_winner_mask``) -> the
  per-segment max ``(V, C)`` and the per-row winner mask ``(N, C)`` bool:
  true at the lowest row holding its segment's max, false everywhere for a
  NaN max and on rows outside every segment.  The max's gradient is
  ``where(mask, gathered gradient, 0)``.

Each wrapper computes its plain PyTorch version for CPU tensors and launches
the CUDA kernel for CUDA tensors; there is no fallback between the two.
The reduce and mapback forms are registered ops (``mmdet3d_torch::
segment_reduce``, ``::segment_reduce_mapback``: a CPU implementation, the
plain version; a CUDA one, the kernel; a fake one, shapes only), so an
exported predict calls them; the winner form, on the train path only, is a
plain function.  On
the card the kernel reads 16-byte vectors where :func:`vectorized` says so
(C a multiple of 4 and ``data`` 16-byte aligned), single floats otherwise.
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
    seg, row = _segments_of_rows(starts, counts)
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


def _segments_of_rows(starts, counts):
    """(segment, row) of every member row, segment-major, rows
    ascending."""
    dev = counts.device
    cnt = counts.long()
    seg = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev),
                                  cnt)
    offs = torch.cumsum(cnt, 0) - cnt
    row = starts.long()[seg] + torch.arange(seg.shape[0], device=dev) \
        - offs[seg]
    return seg, row


def segment_max_winner_plain(data, ids, starts, counts):
    """Plain version of :func:`segment_max_winner` (same rules; ``ids`` is
    only checked, rows outside every segment are false)."""
    n, c = data.shape
    v = counts.shape[0]
    dev = data.device
    seg, row = _segments_of_rows(starts, counts)
    rows = data.float()[row]
    out = segment_reduce_plain(data, starts, counts, 'max')
    nan = torch.zeros((v, c), dtype=torch.float32, device=dev)
    nan.index_add_(0, seg, rows.isnan().float())
    out = torch.where(nan > 0, float('nan'), out)
    big = torch.iinfo(torch.int32).max
    row32 = row[:, None].to(torch.int32)
    cand = torch.where(rows == out[seg], row32, big)
    win = torch.full((v, c), big, dtype=torch.int32, device=dev)
    win.scatter_reduce_(0, seg[:, None].expand(-1, c), cand, 'amin')
    mask = torch.zeros((n, c), dtype=torch.bool, device=dev)
    mask[row] = win[seg] == row32
    return out, mask


def vectorized(data: torch.Tensor) -> bool:
    """True where the kernels read ``data`` (N, C) f32 as 16-byte vectors:
    C a multiple of 4 and the data pointer 16-byte aligned."""
    return data.shape[1] % 4 == 0 and data.data_ptr() % 16 == 0


def _check_common(data, starts, counts):
    _cuda.check_tensor(data, 'data', torch.float32, (None, None))
    _cuda.check_tensor(starts, 'starts', torch.int32, (None,))
    _cuda.check_tensor(counts, 'counts', torch.int32, (starts.shape[0],))


def _check_reduce(data, starts, counts, op):
    is_max = _check_op(op)
    _check_common(data, starts, counts)
    return is_max


def _check_mapback(data, ids, starts, counts, op):
    is_max = _check_reduce(data, starts, counts, op)
    _cuda.check_tensor(ids, 'ids', torch.int32, (data.shape[0],))
    return is_max


# K1's reduce and mapback forms as registered ops: the plain version on the
# CPU, the kernel on the card, shapes only under tracing
def _segment_reduce_cpu(data, starts, counts, op):
    _check_reduce(data, starts, counts, op)
    _cuda.same_device(data, starts, counts)
    return segment_reduce_plain(data, starts, counts, op)


def _segment_reduce_cuda(data, starts, counts, op):
    is_max = _check_reduce(data, starts, counts, op)
    dev = _cuda.same_device(data, starts, counts)
    v, c = counts.shape[0], data.shape[1]
    out = torch.empty((v, c), dtype=torch.float32, device=dev)
    if out.numel():
        _cuda.launch('segment_reduce', dev, data.data_ptr(),
                     starts.data_ptr(), counts.data_ptr(), out.data_ptr(),
                     v, c, is_max, int(vectorized(data)))
    return out


def _segment_reduce_fake(data, starts, counts, op):
    _check_reduce(data, starts, counts, op)
    return data.new_empty((counts.shape[0], data.shape[1]))


_SEGMENT_REDUCE = _cuda.register_op(
    'segment_reduce(Tensor data, Tensor starts, Tensor counts, str op) '
    '-> Tensor', _segment_reduce_cpu, _segment_reduce_cuda,
    _segment_reduce_fake)


def _segment_mapback_cpu(data, ids, starts, counts, op):
    _check_mapback(data, ids, starts, counts, op)
    _cuda.same_device(data, ids, starts, counts)
    return segment_reduce_mapback_plain(data, ids, starts, counts, op)


def _segment_mapback_cuda(data, ids, starts, counts, op):
    is_max = _check_mapback(data, ids, starts, counts, op)
    dev = _cuda.same_device(data, ids, starts, counts)
    n, c = data.shape
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    if out.numel():
        _cuda.launch('segment_reduce_mapback', dev, data.data_ptr(),
                     ids.data_ptr(), counts.data_ptr(), out.data_ptr(), n,
                     counts.shape[0], c, is_max, int(vectorized(data)))
    return out


def _segment_mapback_fake(data, ids, starts, counts, op):
    _check_mapback(data, ids, starts, counts, op)
    return data.new_empty(data.shape)


_SEGMENT_MAPBACK = _cuda.register_op(
    'segment_reduce_mapback(Tensor data, Tensor ids, Tensor starts, '
    'Tensor counts, str op) -> Tensor', _segment_mapback_cpu,
    _segment_mapback_cuda, _segment_mapback_fake)


def segment_reduce(data: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor, op: str) -> torch.Tensor:
    """Per-segment ``op`` ('sum' | 'max') of sorted rows -> ``(V, C)`` f32.

    data (N, C) f32 contiguous; starts, counts (V,) int32 (first sorted row
    and row count of each segment; empty segments have count 0).  Calls the
    registered op ``mmdet3d_torch::segment_reduce``."""
    return _SEGMENT_REDUCE(data, starts, counts, op)


def segment_reduce_mapback(data: torch.Tensor, ids: torch.Tensor,
                           starts: torch.Tensor, counts: torch.Tensor,
                           op: str) -> torch.Tensor:
    """Per-row full-segment ``op`` -> ``(N, C)`` f32; rows with an id
    outside ``[0, V)`` get 0.

    ids (N,) int32 ascending, consistent with starts/counts (row r with
    id v lies in ``[starts[v], starts[v] + counts[v])``).  Calls the
    registered op ``mmdet3d_torch::segment_reduce_mapback``."""
    return _SEGMENT_MAPBACK(data, ids, starts, counts, op)


def segment_max_winner(data: torch.Tensor, ids: torch.Tensor,
                       starts: torch.Tensor, counts: torch.Tensor):
    """Per-segment max ``(V, C)`` f32 (empty segments 0, NaN propagates)
    and the winner mask ``(N, C)`` bool: true at the lowest row index
    holding its segment's max, false for a NaN max, false on rows whose id
    lies outside ``[0, V)``.  Arguments as :func:`segment_reduce_mapback`.
    """
    _check_common(data, starts, counts)
    _cuda.check_tensor(ids, 'ids', torch.int32, (data.shape[0],))
    dev = _cuda.same_device(data, ids, starts, counts)
    if dev.type == 'cpu':
        return segment_max_winner_plain(data, ids, starts, counts)
    n, c = data.shape
    v = counts.shape[0]
    out = torch.empty((v, c), dtype=torch.float32, device=dev)
    mask = torch.empty((n, c), dtype=torch.bool, device=dev)
    if out.numel() or mask.numel():
        _cuda.launch('segment_max_winner', dev, data.data_ptr(),
                     ids.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                     out.data_ptr(), mask.data_ptr(), n, v, c,
                     int(vectorized(data)))
    return out, mask
