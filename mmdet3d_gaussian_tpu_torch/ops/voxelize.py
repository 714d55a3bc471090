"""Hard voxelization and the dense BEV canvas scatters: the plain canvas
(kernel K2) and the space-to-depth canvas (kernel K7), both in
``csrc/bev_splat.cu``.

Port of ``mmdet3d_gaussian_tpu/ops/voxelize.py::hard_voxelize``,
``::bev_scatter`` and ``::bev_scatter_s2d``.  :func:`hard_voxelize` packs
each voxel's first ``max_points`` points (ascending point index) into a
``(max_voxels, max_points, C)`` table by one row gather from the
voxel-sorted points.  Pillar rows compacted in the canvas's raster order
(``build_scatter`` with ``key_order=CANVAS_KEY_ORDER`` for the plain canvas,
with the s2d key for the s2d canvas) have non-decreasing cell ids, so each
splat is an exact row placement into a zeroed canvas.  Rows and canvas are
f32, or bf16 in the mixed-precision model; the canvas has the rows' type.
Both splats are registered ops (``mmdet3d_torch::bev_splat``,
``::bev_splat_pairs``: the plain version on the CPU, the kernel on the
card, shapes only under tracing), so an exported predict calls them.

The gradients (``_splat_bwd`` and ``_splat_pairs_bwd`` of the JAX package)
are fill-gathers of the canvas gradient at each row's cell, rows with an id
past the canvas reading 0: plain indexing, as JAX computes them outside
Pallas.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from . import _cuda
from .scan import cummax_i32
from .scatter import Scatter, build_scatter

CANVAS_KEY_ORDER = (0, 2, 1, 3)   # (b, iy, ix, iz): build_scatter key order
                                  # that compacts voxels in canvas raster
                                  # order -> sorted BEV cell ids


class HardVoxels(NamedTuple):
    voxels: torch.Tensor      # (max_voxels, max_points, C) padded points
    coords: torch.Tensor      # (max_voxels, K) int32, -1 rows unused
    num_points: torch.Tensor  # (max_voxels,) int32, clipped to max_points
    scatter: Scatter          # the underlying point -> voxel mapping


def hard_voxelize(points: torch.Tensor, coords: torch.Tensor,
                  spatial_shape: Sequence[int], max_points: int,
                  max_voxels: int,
                  key_order: Optional[Sequence[int]] = None,
                  mask_slots: bool = True, group=None) -> HardVoxels:
    """Pack points into ``(max_voxels, max_points, C)`` slots.

    points (N, C) float; coords (N, K) int voxel coords (-1 rows invalid;
    K = 4 is batched, batch first); ``spatial_shape`` and ``key_order`` as
    :func:`build_scatter`.  Each voxel keeps its first ``max_points`` points
    by ascending point index, ``num_points = min(count, max_points)``; live
    voxels past ``max_voxels`` are dropped.

    The table is a gather from the voxel-sorted points: ``voxels[v, p] =
    pts_sorted[base[v] + min(p, last[v])]``, ``base`` the voxel's first
    sorted row, and an empty voxel's base the last row of the live voxels
    before it (``cummax(starts + counts) - 1``), so the flattened gather
    indices are non-decreasing.  ``mask_slots=False`` leaves the slots at
    and past ``num_points`` holding a neighbouring row instead of zeros,
    for a consumer that masks by ``num_points`` itself.  ``group``: the
    ranks of one global batch, ``max_voxels`` its capacity
    (:func:`~.scatter.build_scatter`); the voxels this rank drops are
    empty slots."""
    scatter = build_scatter(coords, spatial_shape, max_voxels,
                            key_order=key_order, group=group)
    n, c = points.shape
    counts = scatter.voxel_counts
    num_points = counts.clamp(max=max_points)
    starts = scatter.sorted_starts
    pts_sorted = points[scatter.sort_order]
    slot = torch.arange(max_points, dtype=torch.int32,
                        device=points.device)[None, :]
    last = (num_points[:, None] - 1).clamp(min=0)
    ends_mono = (cummax_i32(starts + counts) - 1).clamp(min=0)
    base = torch.where(num_points > 0, starts, ends_mono)
    src = (base[:, None] + torch.minimum(slot, last)).clamp(
        max=max(n - 1, 0))
    voxels = pts_sorted[src.reshape(-1).long()].reshape(
        max_voxels, max_points, c)
    if mask_slots:
        voxels = torch.where((slot < num_points[:, None])[..., None],
                             voxels, 0.0)
    return HardVoxels(voxels=voxels, coords=scatter.voxel_coords,
                      num_points=num_points, scatter=scatter)


def hard_kept_rows(sorted_ids: torch.Tensor, max_voxels: int,
                   max_points: int) -> torch.Tensor:
    """(N,) bool over voxel-sorted point rows (``sorted_ids`` ascending, the
    trash id ``max_voxels`` last): true where the row is live and among the
    first ``max_points`` rows of its voxel, the points hard voxelize
    keeps.  Under a group the voxels past the global capacity already
    carry the trash id in ``sorted_ids``, so the rows kept over the ranks
    are the ones kept on the whole batch."""
    pos = torch.arange(sorted_ids.shape[0], dtype=torch.int32,
                       device=sorted_ids.device)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    rank = pos - cummax_i32(torch.where(first, pos, 0))
    return (sorted_ids < max_voxels) & (rank < max_points)


def _check_rows(feats: torch.Tensor, ids: torch.Tensor, nrows: int):
    _cuda.check_tensor(feats, 'feats', _cuda.FLOAT_TYPES, (None, None))
    _cuda.check_tensor(ids, 'ids', torch.int32, (feats.shape[0],))
    if nrows < 0 or nrows >= 2 ** 31 - 1:
        raise ValueError(f'canvas rows {nrows} out of range')


def bev_splat_plain(feats: torch.Tensor, lin: torch.Tensor, ncell: int):
    """Plain version of :func:`bev_splat`: the JAX package's exact path
    (segment-sum into ``ncell + 1`` rows, trash row sliced off)."""
    c = feats.shape[1]
    idx = lin.long().clamp(max=ncell)
    canvas = torch.zeros((ncell + 1, c), dtype=feats.dtype,
                         device=feats.device)
    canvas.index_add_(0, idx, feats)
    return canvas[:ncell]


def _bev_splat_cpu(feats, lin, ncell):
    _check_rows(feats, lin, ncell)
    _cuda.same_device(feats, lin)
    return bev_splat_plain(feats, lin, ncell)


def _bev_splat_cuda(feats, lin, ncell):
    _check_rows(feats, lin, ncell)
    dev = _cuda.same_device(feats, lin)
    out = torch.empty((ncell, feats.shape[1]), dtype=feats.dtype, device=dev)
    if out.numel():
        _cuda.launch('bev_splat', dev, feats.data_ptr(), lin.data_ptr(),
                     out.data_ptr(), feats.shape[0], feats.shape[1], ncell,
                     feats.element_size())
    return out


def _bev_splat_fake(feats, lin, ncell):
    _check_rows(feats, lin, ncell)
    return feats.new_empty((ncell, feats.shape[1]))


_BEV_SPLAT = _cuda.register_op(
    'bev_splat(Tensor feats, Tensor lin, SymInt ncell) -> Tensor',
    _bev_splat_cpu, _bev_splat_cuda, _bev_splat_fake)


def bev_splat(feats: torch.Tensor, lin: torch.Tensor, ncell: int):
    """Splat sorted unique voxel rows onto a dense ``(ncell, C)`` canvas.

    feats (V, C) f32 or bf16 contiguous; lin (V,) int32 cell ids,
    ascending, unique below ``ncell``, non-negative; rows with
    ``lin >= ncell`` are dropped.  Cells without a row are 0; the canvas
    has feats' type.  Calls the registered op ``mmdet3d_torch::
    bev_splat``."""
    return _BEV_SPLAT(feats, lin, ncell)


def pair_rows(lin2: torch.Tensor, par: torch.Tensor, ncell2: int):
    """Row ids of the pair canvas seen as ``(2 * ncell2, C)`` half-rows:
    ``2 * lin2 + par``, and ``2 * ncell2`` (past the end) where ``lin2 >=
    ncell2``."""
    return torch.where(lin2 < ncell2, 2 * lin2.long() + par.long(),
                       2 * ncell2)


def bev_splat_pairs_plain(feats: torch.Tensor, lin2: torch.Tensor,
                          par: torch.Tensor, ncell2: int):
    """Plain version of :func:`bev_splat_pairs`: :func:`bev_splat_plain` on
    the half-row view."""
    ids = pair_rows(lin2, par, ncell2)
    return bev_splat_plain(feats, ids, 2 * ncell2).view(
        ncell2, 2 * feats.shape[1])


def _check_pairs(feats, lin2, par, ncell2):
    _check_rows(feats, lin2, 2 * ncell2)
    _cuda.check_tensor(par, 'par', torch.int32, (feats.shape[0],))


def _bev_splat_pairs_cpu(feats, lin2, par, ncell2):
    _check_pairs(feats, lin2, par, ncell2)
    _cuda.same_device(feats, lin2, par)
    return bev_splat_pairs_plain(feats, lin2, par, ncell2)


def _bev_splat_pairs_cuda(feats, lin2, par, ncell2):
    _check_pairs(feats, lin2, par, ncell2)
    dev = _cuda.same_device(feats, lin2, par)
    out = torch.empty((ncell2, 2 * feats.shape[1]), dtype=feats.dtype,
                      device=dev)
    if out.numel():
        _cuda.launch('bev_splat_pairs', dev, feats.data_ptr(),
                     lin2.data_ptr(), par.data_ptr(), out.data_ptr(),
                     feats.shape[0], feats.shape[1], ncell2,
                     feats.element_size())
    return out


def _bev_splat_pairs_fake(feats, lin2, par, ncell2):
    _check_pairs(feats, lin2, par, ncell2)
    return feats.new_empty((ncell2, 2 * feats.shape[1]))


_BEV_SPLAT_PAIRS = _cuda.register_op(
    'bev_splat_pairs(Tensor feats, Tensor lin2, Tensor par, SymInt ncell2) '
    '-> Tensor', _bev_splat_pairs_cpu, _bev_splat_pairs_cuda,
    _bev_splat_pairs_fake)


def bev_splat_pairs(feats: torch.Tensor, lin2: torch.Tensor,
                    par: torch.Tensor, ncell2: int):
    """Splat sorted rows into a ``(ncell2, 2C)`` paired canvas: row i lands
    in columns ``[par[i] * C, par[i] * C + C)`` of row ``lin2[i]``.

    feats (V, C) f32 or bf16 contiguous; lin2 (V,) int32 paired-cell ids,
    non-decreasing, non-negative, at most two rows per id below ``ncell2``
    and then of different parities; par (V,) int32 in {0, 1}; rows with
    ``lin2 >= ncell2`` are dropped.  Unfilled halves are 0; the canvas has
    feats' type.  Calls the registered op ``mmdet3d_torch::
    bev_splat_pairs``."""
    return _BEV_SPLAT_PAIRS(feats, lin2, par, ncell2)


def splat_plan(feats: torch.Tensor, out: torch.Tensor, halves: int = 1):
    """What the CUDA splat runs for ``feats`` (V, C) into the canvas
    ``out`` (``halves`` 1: K2 on ``(ncell, C)``, 2: K7 on ``(ncell2,
    2C)``), without launching it: dict of the persistent grid, the tiles of
    256 half-rows, the bytes of one load or store, and the slot width in
    those units as a shift (-1: a division)."""
    dev = _cuda.same_device(feats, out)
    if dev.type != 'cuda':
        raise ValueError('splat_plan describes the CUDA kernel')
    res = (ctypes.c_longlong * 4)()
    _cuda.query('bev_splat_plan', dev, feats.data_ptr(), out.data_ptr(),
                feats.shape[1], out.shape[0], feats.element_size(), halves,
                res)
    return dict(zip(('grid', 'tiles', 'vector_bytes', 'shift'), res))


def splat_runs(ids: torch.Tensor, rows: int, halves: int, grid: int):
    """The runs the splat kernel's ``grid`` blocks take over a canvas of
    ``rows`` key rows (``halves`` 1: K2's ``lin``, 2: K7's ``lin2``):
    -> (first key row, first row) of each block and of the end, each
    ``(grid + 1,)`` int64.  The key rows before k cost ``halves * k +
    R(k)`` (half-rows written, plus rows read: R(k) live rows with an id
    below k), and block b starts at the least k whose cost reaches ``b *
    total // grid`` (or at the end), total ``halves * rows + len(ids)``
    (every row counted, live or not), as in the kernel."""
    ids = ids.long()
    keys = torch.arange(rows + 1, device=ids.device)
    below = torch.searchsorted(ids, keys)
    cost = halves * keys + below
    total = halves * rows + ids.shape[0]
    goals = total * torch.arange(grid + 1, device=ids.device) // grid
    first = torch.searchsorted(cost, goals).clamp(max=rows)
    return first, below[first]


def _fill_gather(g: torch.Tensor, ids: torch.Tensor):
    """Rows ``g[ids]``, 0 where ``ids`` is past the end of ``g``."""
    n = g.shape[0]
    rows = g[ids.long().clamp(max=max(n - 1, 0))]
    return torch.where((ids < n)[:, None], rows, 0.0)


class _Splat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, lin, ncell: int):
        ctx.save_for_backward(lin)
        return bev_splat(feats, lin, ncell)

    @staticmethod
    def backward(ctx, g):
        (lin,) = ctx.saved_tensors
        return _fill_gather(g, lin), None, None


class _SplatPairs(torch.autograd.Function):
    """Forward K7; backward the fill-gather of the 2C-wide row at ``lin2``
    and the select of its ``par`` half (``_splat_pairs_bwd``)."""

    @staticmethod
    def forward(ctx, feats, lin2, par, ncell2: int):
        ctx.save_for_backward(lin2, par)
        return bev_splat_pairs(feats, lin2, par, ncell2)

    @staticmethod
    def backward(ctx, g):
        lin2, par = ctx.saved_tensors
        c = g.shape[1] // 2
        gi = _fill_gather(g, lin2)
        return (torch.where((par == 0)[:, None], gi[:, :c], gi[:, c:]), None,
                None, None)


def bev_scatter(voxel_feats: torch.Tensor, coords: torch.Tensor,
                batch_size: int, nx: int, ny: int):
    """Scatter per-voxel features onto a dense NHWC canvas
    ``(B, ny, nx, C)``.

    coords (V, 3+) int (batch, ix, iy, ...), -1 rows dropped; rows must be
    compacted in canvas raster order (``CANVAS_KEY_ORDER``) with one voxel
    per cell, so the cell ids are ascending and unique.  The canvas is
    written contiguous, so ``canvas.permute(0, 3, 1, 2)`` is a channels-last
    NCHW view with no copy."""
    b, ix, iy = coords[:, 0], coords[:, 1], coords[:, 2]
    valid = ((b >= 0) & (b < batch_size) & (ix >= 0) & (ix < nx)
             & (iy >= 0) & (iy < ny))
    ncell = batch_size * ny * nx
    lin = torch.where(valid, (b * ny + iy) * nx + ix, ncell).to(torch.int32)
    canvas = _Splat.apply(voxel_feats.contiguous(), lin, ncell)
    return canvas.view(batch_size, ny, nx, voxel_feats.shape[-1])


def bev_scatter_s2d(voxel_feats: torch.Tensor, coords_s2d: torch.Tensor,
                    batch_size: int, nx2: int, ny2: int):
    """Space-to-depth splat: pillars -> ``(B, ny2, nx2, 4C)`` canvas.

    Each 2 x 2 block of pillars lands in one canvas cell, the four
    parities ``(iy & 1) * 2 + (ix & 1)`` stacked on channels in blocks of C.
    coords_s2d (V, 4) int rows ``(b, cy, cx, parity)`` (-1 rows dropped),
    compacted in cell raster order with the parity minor (``build_scatter``
    on the s2d key).  Parities 0, 1 and 2, 3 form the two 2C-wide halves of
    a cell, so rows go to paired row ``cell * 2 + parity // 2``, lane half
    ``parity & 1`` of a ``(2 * ncell, 2C)`` canvas, and its reshape to
    ``(B, ny2, nx2, 4C)`` is a view."""
    vb, vcy, vcx = coords_s2d[:, 0], coords_s2d[:, 1], coords_s2d[:, 2]
    vpar = coords_s2d[:, 3]
    valid = ((vb >= 0) & (vb < batch_size) & (vcx >= 0) & (vcx < nx2)
             & (vcy >= 0) & (vcy < ny2))
    ncell = batch_size * ny2 * nx2
    lin2 = torch.where(valid, ((vb * ny2 + vcy) * nx2 + vcx) * 2 + vpar // 2,
                       ncell * 2).to(torch.int32)
    par = (vpar & 1).to(torch.int32)
    canvas = _SplatPairs.apply(voxel_feats.contiguous(), lin2, par,
                               ncell * 2)
    return canvas.view(batch_size, ny2, nx2, 4 * voxel_feats.shape[-1])
