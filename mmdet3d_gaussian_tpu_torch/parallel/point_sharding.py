"""Point-axis sharding: the pillar reduce across the ranks of a points group.

Port of ``mmdet3d_gaussian_tpu/parallel/point_sharding.py``.  Each rank of
a points group (``parallel/mesh.py``: :func:`~.mesh.init_mesh`) holds a
slice of a sample's points, reduces it into a partial dense canvas of
``ny * nx`` cells (plus the trash cell ``ny * nx`` that out-of-range and
masked points land in), and the partials are merged:

* dense (:func:`sharded_pillar_reduce`): one all-reduce of the whole
  canvas, sum or max;
* sparse (:func:`sharded_pillar_reduce_sparse`,
  :func:`sharded_feature_splat_sparse`): the canvas is cut into one
  y-stripe a rank; each rank compacts the live cells of each stripe into
  ``bucket_capacity`` rows (:func:`_compact_and_pack`), sends them to the
  stripe's owner with one ``all_to_all``, and the owner reduces what it
  receives into its stripe; ``replicate_out`` then gathers the stripes
  into the whole canvas on every rank.

The JAX functions take the global point array and shard it themselves
(``shard_map``); here each rank passes its own slice and the points group
(a :class:`~.mesh.Group`) the merge runs over.  The local reductions are
``index_add_`` and ``index_reduce_`` (the JAX package's ``.at[].add`` and
``.at[].max``, outside Pallas).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..ops.scatter import compute_voxel_coords
from .mesh import (Group, all_gather_replicated, all_reduce_max,
                   all_reduce_replicated, all_to_all)


def _cells(points: torch.Tensor, mask: torch.Tensor,
           pc_range: Sequence[float], voxel_size: Sequence[float], nx: int,
           ny: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (valid (N,) bool, canvas cell ``iy nx + ix`` (N,) int64, the
    trash cell ``ny nx`` where not valid)."""
    coords, _ = compute_voxel_coords(points[:, :3], pc_range, voxel_size)
    coords = torch.where(mask[:, None], coords, -1)
    valid = (coords >= 0).all(-1)
    lin = torch.where(valid, coords[:, 1].long() * nx + coords[:, 0],
                      ny * nx)
    return valid, lin


def canvas_sums(x: torch.Tensor, lin: torch.Tensor, valid: torch.Tensor,
                nx: int, ny: int) -> torch.Tensor:
    """Features (B, N, C) at canvas cells ``lin`` (B, N; anything where not
    ``valid``) -> (B, ny nx, C + 1): the sums of the valid rows' features
    and their count a cell, by one ``index_add_`` (the trash cell ``ny
    nx`` dropped)."""
    b, n, _ = x.shape
    ones = valid.to(x.dtype)[..., None]
    data = torch.cat([x * ones, ones], dim=-1)
    cells = ny * nx + 1
    ids = torch.where(valid, lin.long(), ny * nx) + torch.arange(
        b, device=lin.device)[:, None] * cells
    table = data.new_zeros((b * cells, data.shape[-1])).index_add(
        0, ids.reshape(-1), data.reshape(b * n, -1))
    return table.reshape(b, cells, -1)[:, :-1]


def _local_dense_reduce(points, mask, pc_range, voxel_size, nx: int,
                        ny: int, op: str) -> torch.Tensor:
    """One rank's partial dense canvas of its points (N, C): -> (ny nx,
    C + 1) sums with a count lane ('sum', 'mean'), or (ny nx, C) maxes
    starting at -inf ('max')."""
    valid, lin = _cells(points, mask, pc_range, voxel_size, nx, ny)
    if op == 'max':
        table = points.new_full((ny * nx + 1, points.shape[1]), -torch.inf)
        rows = torch.where(valid[:, None], points, -torch.inf)
        table.index_reduce_(0, lin, rows, 'amax')
        return table[:-1]
    return canvas_sums(points[None], lin[None], valid[None], nx, ny)[0]


def _finish(table: torch.Tensor, op: str) -> torch.Tensor:
    """A merged table -> the op's values: a non-finite max becomes 0 (an
    empty cell), a mean divides by ``max(count, 1)``, a sum drops the
    count lane."""
    if op == 'max':
        return torch.where(torch.isfinite(table), table, 0.0)
    if op == 'mean':
        return table[:, :-1] / table[:, -1:].clamp(min=1.0)
    return table[:, :-1]


def sharded_pillar_reduce(points, mask, pc_range, voxel_size, nx: int,
                          ny: int, group: Group, op: str = 'mean'
                          ) -> torch.Tensor:
    """The dense merge of this rank's points (N_local, C) and mask
    (N_local,) with the slices of ``group``'s other ranks: -> (ny, nx, C)
    on every rank.  'sum' and 'mean' all-reduce the sums and counts (the
    sum differentiable in the points: every rank consumes the merged
    canvas alike), 'max' all-reduces with ``ReduceOp.MAX``."""
    table = _local_dense_reduce(points, mask, pc_range, voxel_size, nx, ny,
                                op)
    if op == 'max':
        merged = all_reduce_max(table, group)
    else:
        merged = all_reduce_replicated(table, group)
    return _finish(merged, op).reshape(ny, nx, -1)


def default_capacity(stripe_cells: int,
                     bucket_capacity: Optional[int]) -> int:
    """JAX's bucket capacity: ``bucket_capacity`` or else ``max(128,
    stripe_cells // 4)``, at most ``stripe_cells``."""
    cap = bucket_capacity or max(128, stripe_cells // 4)
    return min(cap, stripe_cells)


def _compact_and_pack(stripes: torch.Tensor, live: torch.Tensor, cap: int,
                      stripe_cells: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each stripe's live cells compacted into ``cap`` rows: stripes (...,
    S, F), live (..., S) -> (rows (..., cap, F), cell ids (..., cap)
    int32).

    JAX's selection exactly: ``top_k(-rank, cap)`` with ``rank = idx`` for
    a live cell and ``stripe_cells + idx`` for a dead one, so the lowest
    live ids come first in ascending order, a dead pick goes to the trash
    slot ``stripe_cells``, and live cells beyond ``cap`` are dropped,
    highest id first, with no signal (a static bound, as
    ``max_voxels``).  The ids travel in their own int tensor, so the rows
    keep their dtype."""
    idx = torch.arange(stripe_cells, device=stripes.device)
    rank = torch.where(live, idx, stripe_cells + idx)
    sel = torch.topk(-rank, cap, dim=-1, sorted=True).indices
    rows = torch.gather(stripes, -2, sel[..., None].expand(
        *sel.shape, stripes.shape[-1]))
    cell = torch.where(torch.gather(live, -1, sel), sel, stripe_cells)
    return rows, cell.to(torch.int32)


def sharded_pillar_reduce_sparse(points, mask, pc_range, voxel_size,
                                 nx: int, ny: int, group: Group,
                                 op: str = 'mean',
                                 bucket_capacity: Optional[int] = None,
                                 replicate_out: bool = True
                                 ) -> torch.Tensor:
    """The sparse merge of this rank's points with ``group``'s: -> (ny, nx,
    C) on every rank (``replicate_out``) or this rank's y-stripe (ny / R,
    nx, C) of it.  Each rank's partial canvas is cut into R stripes of
    ``stripe_cells = ny / R x nx`` cells; the live cells of each (nonzero
    sums, or a finite max) are compacted into ``bucket_capacity`` rows
    (default ``max(128, stripe_cells // 4)``, at most ``stripe_cells``;
    :func:`_compact_and_pack` drops the rest) and sent to the stripe's
    owner with one ``all_to_all``: R x capacity x (C + 1) values and as
    many int32 cell ids a rank ('sum', 'mean'; C values for 'max')."""
    r = group.world
    if ny % r:
        raise ValueError(f'{ny} canvas rows do not split over {r} ranks')
    rows_per = ny // r
    stripe_cells = rows_per * nx
    cap = default_capacity(stripe_cells, bucket_capacity)
    table = _local_dense_reduce(points, mask, pc_range, voxel_size, nx, ny,
                                op)
    f = table.shape[-1]
    if op == 'max':
        live = (table != -torch.inf).any(-1)
    else:
        live = (table != 0.0).any(-1)
    rows, cell = _compact_and_pack(table.reshape(r, stripe_cells, f),
                                   live.reshape(r, stripe_cells), cap,
                                   stripe_cells)
    rrows = all_to_all(rows, group).reshape(-1, f)
    rcell = all_to_all(cell, group).reshape(-1).long()
    if op == 'max':
        own = table.new_full((stripe_cells + 1, f), -torch.inf)
        own.index_reduce_(0, rcell, rrows, 'amax')
    else:
        own = table.new_zeros((stripe_cells + 1, f)).index_add(0, rcell,
                                                               rrows)
    out = _finish(own[:stripe_cells], op).reshape(rows_per, nx, -1)
    if replicate_out:
        out = all_gather_replicated(out, group, dim=0)
    return out


def reference_pillar_reduce(points, mask, pc_range, voxel_size, nx: int,
                            ny: int, op: str = 'mean') -> torch.Tensor:
    """The one-process function with the same semantics: all points (N,
    C) -> (ny, nx, C)."""
    table = _local_dense_reduce(points, mask, pc_range, voxel_size, nx, ny,
                                op)
    return _finish(table, op).reshape(ny, nx, -1)


def sharded_feature_splat_sparse(feats: torch.Tensor, lin: torch.Tensor,
                                 valid: torch.Tensor, nx: int, ny: int,
                                 group: Group,
                                 bucket_capacity: Optional[int] = None,
                                 replicate_out: bool = True
                                 ) -> torch.Tensor:
    """The differentiable sparse merge of per-point features, the pillar
    merge of :class:`~.sharded_model.DensePillarEncoder` under
    ``merge='sparse'``.

    feats (b, n, C) this rank's point slice of its data rank's b samples;
    lin (b, n) the points' canvas cells ``iy nx + ix`` (anything where not
    ``valid``); valid (b, n) bool.  -> (b, ny, nx, C + 1) sums with a count
    lane, on every rank of the points ``group`` (``replicate_out``), or
    this rank's y-stripe (b, ny / R, nx, C + 1).  Every step has a
    gradient: the scatter-add (a gather back), the compaction (a scatter
    back), the ``all_to_all`` (its own transpose) and the gather of the
    stripes (every rank of the group consumes the canvas alike:
    ``mesh.all_gather_replicated``).  Capacity as in
    :func:`sharded_pillar_reduce_sparse`."""
    r = group.world
    if ny % r:
        raise ValueError(f'{ny} canvas rows do not split over {r} ranks')
    rows_per = ny // r
    stripe_cells = rows_per * nx
    cap = default_capacity(stripe_cells, bucket_capacity)
    b = feats.shape[0]
    stripes = canvas_sums(feats, lin, valid, nx, ny)       # (b, ny nx, F)
    fdim = stripes.shape[-1]
    stripes = stripes.reshape(b, r, stripe_cells, fdim)
    live = stripes[..., -1] > 0
    rows, cell = _compact_and_pack(stripes, live, cap, stripe_cells)
    # (b, R, cap, ...) -> R blocks of (b, cap, ...) for the stripe owners
    rrows = all_to_all(rows.transpose(0, 1), group).transpose(0, 1)
    rcell = all_to_all(cell.transpose(0, 1), group).transpose(0, 1)
    own_cells = stripe_cells + 1
    ids = rcell.reshape(b, -1).long() + torch.arange(
        b, device=rcell.device)[:, None] * own_cells
    own = stripes.new_zeros((b * own_cells, fdim)).index_add(
        0, ids.reshape(-1), rrows.reshape(-1, fdim))
    out = own.reshape(b, own_cells, fdim)[:, :stripe_cells].reshape(
        b, rows_per, nx, fdim)
    if replicate_out:
        out = all_gather_replicated(out, group, dim=1)
    return out
