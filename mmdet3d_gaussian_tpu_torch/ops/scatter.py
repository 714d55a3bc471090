"""Dynamic point -> voxel scatter, sort-based and deterministic.

Port of ``mmdet3d_gaussian_tpu/ops/scatter.py``: voxel coords are
linearized to int32 keys, stably sorted, deduplicated into compact voxel ids
``0 .. L-1`` (in key order), and every reduction runs over rows sorted by
voxel id through kernel K1 (:mod:`.segment`).  Invalid points and voxels
beyond ``max_voxels`` map to the trash id ``max_voxels``.

Gradients (``segment_kernel.py::sorted_reduce`` / ``sorted_reduce_mapback``
VJPs): a sum / mean copies each voxel's gradient back to its rows; a max
routes it to the one row per (voxel, channel) that K1's winner form marks
in its per-row mask, the lowest row index holding the max (the reference's
atomicMin traceback).  Every backward is a gather per row, never a
scatter.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .scan import cummax_i32, cumsum_i32
from .segment import segment_max_winner, segment_reduce
from .segment import segment_reduce_mapback

_INT32_MAX = 2 ** 31 - 1


def compute_voxel_coords(points_xyz: torch.Tensor, point_cloud_range,
                         voxel_size):
    """Point xyz -> integer voxel coords ``(N, 3)`` (ix, iy, iz); -1 rows for
    out-of-range points.  Returns ``(coords, grid)``.

    Same f32 arithmetic as the JAX package: ``floor((xyz - min) / size)``
    (a division, not a reciprocal multiply, so voxel ids agree)."""
    dt, dev = points_xyz.dtype, points_xyz.device
    pcr = torch.tensor(point_cloud_range, dtype=dt, device=dev)
    vs = torch.tensor(voxel_size, dtype=dt, device=dev)
    grid = torch.floor((pcr[3:6] - pcr[0:3]) / vs + 0.5).to(torch.int32)
    coords = torch.floor((points_xyz - pcr[0:3]) / vs).to(torch.int32)
    valid = ((coords >= 0) & (coords < grid)).all(dim=-1)
    return torch.where(valid[:, None], coords, -1), grid


def batch_coords(coords_3d: torch.Tensor, batch_idx: torch.Tensor):
    """Prepend a batch column: (N,3)+(N,) -> (N,4); keeps -1 invalid rows."""
    invalid = (coords_3d < 0).any(dim=-1)
    b = torch.where(invalid, -1, batch_idx.to(torch.int32))
    return torch.cat([b[:, None], coords_3d], dim=-1)


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _row_gather(table: torch.Tensor, ids: torch.Tensor, fill) -> torch.Tensor:
    """``table[ids]`` per row; ids outside ``[0, V)`` read ``fill``."""
    v = table.shape[0]
    padded = torch.cat([table, table.new_full((1,) + table.shape[1:], fill)])
    return padded[torch.where((ids >= 0) & (ids < v), ids.long(), v)]


class _SortedReduce(torch.autograd.Function):
    """Per-segment sum / max of sorted rows with the gradient rules of
    ``sorted_reduce`` (``segment_kernel.py:298-314``)."""

    @staticmethod
    def forward(ctx, rows, ids, starts, counts, op: str):
        ctx.op = op
        if op == 'max':
            out, winner = segment_max_winner(rows, ids, starts, counts)
            ctx.save_for_backward(ids, winner)
        else:
            out = segment_reduce(rows, starts, counts, 'sum')
            ctx.save_for_backward(ids)
        return out

    @staticmethod
    def backward(ctx, g):
        ids = ctx.saved_tensors[0]
        g_pt = _row_gather(g, ids, 0.0)
        if ctx.op == 'max':
            g_pt = torch.where(ctx.saved_tensors[1], g_pt, 0.0)
        return g_pt, None, None, None, None


class _SortedReduceMapback(torch.autograd.Function):
    """Per-row full-segment sum / max of sorted rows (invalid rows 0) with
    the gradient rules of ``sorted_reduce_mapback``
    (``segment_kernel.py:327-343``): the sum's gradient is K1's mapback
    form applied to the masked incoming gradient."""

    @staticmethod
    def forward(ctx, rows, ids, starts, counts, op: str):
        ctx.op = op
        if op == 'max':
            per_seg, winner = segment_max_winner(rows, ids, starts, counts)
            ctx.save_for_backward(ids, starts, counts, winner)
            return _row_gather(per_seg, ids, 0.0)
        ctx.save_for_backward(ids, starts, counts)
        return segment_reduce_mapback(rows, ids, starts, counts, 'sum')

    @staticmethod
    def backward(ctx, g):
        ids, starts, counts = ctx.saved_tensors[:3]
        valid = ((ids >= 0) & (ids < counts.shape[0]))[:, None]
        gm = torch.where(valid, g.float(), 0.0).contiguous()
        gsum = segment_reduce_mapback(gm, ids, starts, counts, 'sum')
        if ctx.op == 'max':
            gsum = torch.where(ctx.saved_tensors[3], gsum, 0.0)
        return gsum, None, None, None, None


class Scatter(NamedTuple):
    """Compacted point -> voxel mapping.

    Attributes:
        point_voxel_ids: (N,) int32 compact voxel id per point in
            ``[0, max_voxels)``; invalid / overflow points get ``max_voxels``.
        voxel_coords: (max_voxels, C) int32 coords of each voxel (-1 rows
            unused).
        voxel_counts: (max_voxels,) int32 points per voxel (0 = unused).
        num_voxels: () int32 live voxels kept.
        max_voxels: python int capacity.
        sort_order: (N,) int64 point indices sorted by (voxel, index).
        num_overflow: () int32 live voxels beyond capacity (sent to trash).
        ids_sorted: True for the view over voxel-sorted point rows.
        sorted_starts: (max_voxels,) int32 first sorted row of each voxel
            (cummax-filled for empty voxels).
        sorted_ids: (N,) int32 compact ids in sorted point order.
        num_live: () int32 this rank's live voxels before capacity.
    """
    point_voxel_ids: torch.Tensor
    voxel_coords: torch.Tensor
    voxel_counts: torch.Tensor
    num_voxels: torch.Tensor
    max_voxels: int
    sort_order: torch.Tensor
    num_overflow: torch.Tensor
    ids_sorted: bool = False
    sorted_starts: Optional[torch.Tensor] = None
    sorted_ids: Optional[torch.Tensor] = None
    num_live: Optional[torch.Tensor] = None

    def sorted_view(self) -> 'Scatter':
        """Scatter over the voxel-sorted point permutation: callers permute
        point data once (``data[scatter.sort_order]``) and reduce / map back
        on the view.  The sort is stable, so within a voxel the sorted rows
        keep ascending point index."""
        n = self.sort_order.shape[0]
        return self._replace(
            point_voxel_ids=self.sorted_ids,
            sort_order=torch.arange(n, device=self.sort_order.device),
            ids_sorted=True)

    def _sorted_rows(self, point_feats):
        return point_feats if self.ids_sorted else \
            point_feats[self.sort_order]

    def reduce(self, point_feats: torch.Tensor, op: str = 'max'):
        """Per-voxel reduction of point features -> (max_voxels, C) f32;
        empty voxels 0.  op: 'sum' | 'mean' | 'max'."""
        if op not in ('sum', 'mean', 'max'):
            raise ValueError(f'unknown reduce op {op!r}')
        kop = 'max' if op == 'max' else 'sum'
        rows = self._sorted_rows(point_feats).float().contiguous()
        if _needs_grad(rows):
            out = _SortedReduce.apply(rows, self.sorted_ids,
                                      self.sorted_starts, self.voxel_counts,
                                      kop)
        else:
            out = segment_reduce(rows, self.sorted_starts, self.voxel_counts,
                                 kop)
        if op == 'mean':
            out = out / self.voxel_counts.clamp(min=1).to(out.dtype)[:, None]
        return out.to(point_feats.dtype)

    def mapback(self, voxel_feats: torch.Tensor):
        """Gather voxel features back onto points -> (N, C); invalid points
        read zeros."""
        padded = torch.cat([voxel_feats, voxel_feats.new_zeros(
            (1,) + voxel_feats.shape[1:])], dim=0)
        return padded[self.point_voxel_ids.long()]

    def reduce_mapback(self, point_feats: torch.Tensor, op: str = 'mean'):
        """Per-point full-segment reduction, one K1 pass (mean = sum with a
        ones column, as the JAX kernel path)."""
        rows = self._sorted_rows(point_feats).float()
        if op not in ('sum', 'mean', 'max'):
            raise ValueError(f'unknown reduce op {op!r}')
        if op == 'mean':
            rows = torch.cat([rows, rows.new_ones((rows.shape[0], 1))], -1)
        args = (rows.contiguous(), self.sorted_ids, self.sorted_starts,
                self.voxel_counts, 'max' if op == 'max' else 'sum')
        if _needs_grad(rows):
            out = _SortedReduceMapback.apply(*args)
        else:
            out = segment_reduce_mapback(*args)
        if op == 'mean':
            out = out[:, :-1] / out[:, -1:].clamp(min=1.0)
        if not self.ids_sorted:
            out = out[torch.argsort(self.sort_order)]
        return out.to(point_feats.dtype)

    @property
    def valid_point_mask(self):
        return self.point_voxel_ids < self.max_voxels


def build_scatter(coords: torch.Tensor, spatial_shape: Sequence[int],
                  max_voxels: int,
                  key_order: Optional[Sequence[int]] = None,
                  group=None) -> Scatter:
    """Build the compact point -> voxel mapping from integer coords.

    Args:
        coords: (N, C) int voxel coords; a row with any value < 0 is invalid.
        spatial_shape: extents per coord column, for key linearization.
        max_voxels: output capacity.
        key_order: optional permutation of the coord columns used only for
            the sort key; it sets the order in which voxels are compacted
            (``CANVAS_KEY_ORDER`` gives canvas raster order).
        group: a ``parallel.mesh.Group`` whose ranks hold contiguous
            samples of one global batch (batch index first in the key):
            ``max_voxels`` is then the global batch's capacity C, as in the
            JAX package's sharded step (one program over the whole batch).
            With ``o`` the live voxels of the ranks before this one
            (``mesh.rank_offset``), this rank keeps its voxels of local id
            below ``C - o`` and sends the rest to the trash id; the table
            keeps its static capacity C, nothing is read back to the host,
            and ``num_overflow`` is the global count of dropped voxels.
            The kept set over the ranks is the set one process keeps on
            the whole batch.  None: this function as without a group.
    """
    coords = coords.to(torch.int32)
    n, c = coords.shape
    dev = coords.device
    if len(spatial_shape) != c:
        raise ValueError(f'spatial_shape {spatial_shape} does not match '
                         f'{c} coord columns')
    total = 1
    for s in spatial_shape:
        total *= int(s)
    if total >= _INT32_MAX:
        raise ValueError(f'linearized key space {total} overflows int32')
    cols = list(key_order) if key_order is not None else list(range(c))
    if sorted(cols) != list(range(c)):
        raise ValueError(f'key_order {cols} is not a permutation')

    valid = (coords >= 0).all(dim=-1)
    mult = 1
    key = torch.zeros((n,), dtype=torch.int32, device=dev)
    for d in reversed(cols):
        key = key + coords[:, d] * mult
        mult *= int(spatial_shape[d])
    key = torch.where(valid, key, _INT32_MAX)

    sorted_key, order = torch.sort(key, stable=True)
    first = torch.ones((n,), dtype=torch.int32, device=dev)
    first[1:] = (sorted_key[1:] != sorted_key[:-1]).to(torch.int32)
    first = torch.where(sorted_key == _INT32_MAX, 0, first)
    seg_sorted = cumsum_i32(first) - 1
    num_live = (seg_sorted[-1] + 1).clamp(min=0) if n else \
        torch.zeros((), dtype=torch.int32, device=dev)
    if group is None:
        keep = max_voxels
        num_voxels = num_live.clamp(0, max_voxels)
        num_overflow = (num_live - max_voxels).clamp(min=0)
    else:
        from ..parallel.mesh import rank_offset
        before, total = rank_offset(num_live, group)
        keep = (max_voxels - before).clamp(min=0)
        num_voxels = torch.minimum(num_live.long(), keep)
        num_overflow = (total - max_voxels).clamp(min=0)
    seg_sorted = torch.where(
        (sorted_key == _INT32_MAX) | (seg_sorted >= keep),
        max_voxels, seg_sorted).to(torch.int32)

    point_voxel_ids = torch.empty_like(seg_sorted)
    point_voxel_ids[order] = seg_sorted

    # per-voxel first sorted row and count: live ids are 0..L-1, unique and
    # ascending, so each live voxel's first row writes its own slot; every
    # other row writes the trash slot max_voxels, sliced off
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    live_row = seg_sorted < max_voxels
    slot = torch.where((first > 0) & live_row, seg_sorted, max_voxels).long()
    starts = torch.zeros((max_voxels + 1,), dtype=torch.int32, device=dev)
    starts.scatter_(0, slot, pos)
    starts = starts[:max_voxels]
    voxel_counts = torch.zeros((max_voxels + 1,), dtype=torch.int32,
                               device=dev)
    voxel_counts.index_add_(0, seg_sorted.long(),
                            torch.ones_like(seg_sorted))
    voxel_counts = voxel_counts[:max_voxels]
    # empty voxels take the previous live start (monotone table)
    starts = cummax_i32(starts)

    live = voxel_counts > 0
    rep = order[starts.long().clamp(max=max(n - 1, 0))]
    voxel_coords = torch.where(live[:, None], coords[rep], -1)

    return Scatter(point_voxel_ids=point_voxel_ids,
                   voxel_coords=voxel_coords,
                   voxel_counts=voxel_counts,
                   num_voxels=num_voxels.to(torch.int32),
                   max_voxels=max_voxels,
                   sort_order=order,
                   num_overflow=num_overflow.to(torch.int32),
                   sorted_starts=starts,
                   sorted_ids=seg_sorted,
                   num_live=num_live.to(torch.int32))
