"""Dense BEV canvas scatter (kernel K2, ``csrc/bev_splat.cu``).

Port of ``mmdet3d_gaussian_tpu/ops/voxelize.py::bev_scatter`` on the plain
canvas: pillar rows compacted in canvas raster order (``build_scatter`` with
``key_order=CANVAS_KEY_ORDER``) have ascending, unique cell ids, so the splat
is an exact row copy into a zeroed canvas.
"""
from __future__ import annotations

import torch

from . import _cuda

CANVAS_KEY_ORDER = (0, 2, 1, 3)   # (b, iy, ix, iz): build_scatter key order
                                  # that compacts voxels in canvas raster
                                  # order -> sorted BEV cell ids


def bev_splat_plain(feats: torch.Tensor, lin: torch.Tensor, ncell: int):
    """Plain version of :func:`bev_splat`: the JAX package's exact f32 path
    (segment-sum into ``ncell + 1`` rows, trash row sliced off)."""
    c = feats.shape[1]
    idx = lin.long().clamp(max=ncell)
    canvas = torch.zeros((ncell + 1, c), dtype=torch.float32,
                         device=feats.device)
    canvas.index_add_(0, idx, feats.float())
    return canvas[:ncell]


def bev_splat(feats: torch.Tensor, lin: torch.Tensor, ncell: int):
    """Splat sorted unique voxel rows onto a dense ``(ncell, C)`` canvas.

    feats (V, C) f32 contiguous; lin (V,) int32 cell ids, ascending, unique
    below ``ncell``, non-negative; rows with ``lin >= ncell`` are dropped.
    Cells without a row are 0."""
    _cuda.check_tensor(feats, 'feats', torch.float32, (None, None))
    _cuda.check_tensor(lin, 'lin', torch.int32, (feats.shape[0],))
    if ncell < 0 or ncell >= 2 ** 31 - 1:
        raise ValueError(f'ncell {ncell} out of range')
    dev = _cuda.same_device(feats, lin)
    if dev.type == 'cpu':
        return bev_splat_plain(feats, lin, ncell)
    out = torch.empty((ncell, feats.shape[1]), dtype=torch.float32,
                      device=dev)
    if out.numel():
        _cuda.launch('bev_splat', dev, feats.data_ptr(), lin.data_ptr(),
                     out.data_ptr(), feats.shape[0], feats.shape[1], ncell)
    return out


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
    canvas = bev_splat(voxel_feats.float().contiguous(), lin, ncell)
    return canvas.view(batch_size, ny, nx, voxel_feats.shape[-1])
