"""Multi-view-fusion pillar encoder (MVF).

Port of ``mmdet3d_gaussian_tpu/models/mvf_encoder.py``: the coordinate
views (:data:`VIEW_TRANSFORMS`), :class:`BasicBlock2D`,
:func:`bilinear_sample_zeros`, :class:`SingleViewNet` and
:class:`PillarMVFFeatureNet`.  The points are voxelized once a view
(cartesian, cylindrical, optionally spherical), each view runs its tower
(point net -> pillar max (K1) -> splat onto the view's canvas (K2) ->
three residual blocks with transposed-conv fusion -> bilinear sample back
onto the points), shared point nets fuse the views, and the fused features
reduce on view 0's pillars (K1).

The points stay in their original order: each view's :class:`Scatter`
gathers its own voxel-sorted rows, so two views with different sort orders
never hand rows to each other.  The bilinear sample gathers every point
from its own sample's canvas in one batched gather (JAX loops over the
samples with a mask).  Maps are NCHW views of channels-last memory inside a
tower, NHWC at its edges, as in :mod:`.backbones`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.scatter import Scatter, batch_coords, build_scatter
from ..ops.scatter import compute_voxel_coords
from ..ops.voxelize import bev_scatter
from ..registry import MODELS
from .backbones import (BatchNorm2d, Conv2d, ConvTranspose2d, nchw_to_nhwc,
                        nhwc_to_nchw)
from .voxel_encoders import DynamicPFNLayer, PointVoxelStatsCalculator

# voxel sort key (b, iy, ix, iz): each view's pillars in canvas raster order
VIEW_KEY_ORDER = (0, 2, 1, 3)


# -- coordinate views --------------------------------------------------------
def _with_rest(first3, points):
    return torch.cat([torch.stack(first3, -1), points[..., 3:]], -1)


def to_cartesian(points: torch.Tensor) -> torch.Tensor:
    return points


def to_cylindrical(points: torch.Tensor) -> torch.Tensor:
    """(x, y, z, ...) -> (phi, z, rho, ...), rho the root of the summed
    squares as ``jnp.linalg.norm`` computes it."""
    x, y = points[..., 0], points[..., 1]
    rho = torch.sqrt(x * x + y * y)
    return _with_rest([torch.atan2(y, x), points[..., 2], rho], points)


def to_spherical(points: torch.Tensor) -> torch.Tensor:
    """(x, y, z, ...) -> (yaw, pitch, rho, ...), pitch
    ``arcsin(z / max(rho, 1e-6))``."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rho = torch.sqrt(x * x + y * y + z * z)
    pitch = torch.asin(z / torch.clamp_min(rho, 1e-6))
    return _with_rest([torch.atan2(y, x), pitch, rho], points)


VIEW_TRANSFORMS = dict(cartesian=to_cartesian, cylindrical=to_cylindrical,
                       spherical=to_spherical)


def view_grid(point_cloud_range, voxel_size):
    """(nx, ny, nz) of a view's grid, rounded up as the JAX module does."""
    return tuple(max(1, math.ceil((point_cloud_range[d + 3]
                                   - point_cloud_range[d]) / voxel_size[d]))
                 for d in range(3))


class BasicBlock2D(nn.Module):
    """ResNet basic block, NHWC in and out: 3 x 3 conv (stride) -> BN ->
    ReLU -> 3 x 3 conv -> BN, plus the input (through a 1 x 1 conv and BN
    when the stride or the width changes), then ReLU.  BatchNorm eps 1e-3,
    running statistics ``0.99 old + 0.01 batch`` (K4 in training)."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, channels, 3, stride=stride,
                            padding=1, bias=False)
        self.bn1 = BatchNorm2d(channels, eps=1e-3)
        self.conv2 = Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(channels, eps=1e-3)
        self.down = stride != 1 or in_channels != channels
        if self.down:
            self.down_conv = Conv2d(in_channels, channels, 1, stride=stride,
                                    bias=False)
            self.down_bn = BatchNorm2d(channels, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(x)
        y = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return nchw_to_nhwc(torch.relu(x + y))


def bilinear_sample_zeros(canvas: torch.Tensor, uv: torch.Tensor,
                          batch_idx: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an NHWC canvas (B, H, W, C) at continuous pixel
    coords uv (N, 2) = (x_pix, y_pix) (``grid_sample`` with
    ``align_corners=False`` pixel centres), zero outside the canvas.  Point
    n reads sample ``batch_idx[n]``; a point with ``valid`` False reads 0.
    The four taps are summed in the JAX order."""
    b, h, w, c = canvas.shape
    flat = canvas.reshape(b * h * w, c)
    u, v = uv[:, 0], uv[:, 1]
    u0 = torch.floor(u).to(torch.int32)
    v0 = torch.floor(v).to(torch.int32)
    du, dv = u - u0, v - v0
    base = batch_idx.long() * (h * w)

    def tap(vi, ui, wgt):
        ok = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & valid
        cell = vi.clamp(0, h - 1).long() * w + ui.clamp(0, w - 1).long()
        return flat[base + cell] * (wgt * ok)[:, None]

    return (tap(v0, u0, (1 - du) * (1 - dv))
            + tap(v0, u0 + 1, du * (1 - dv))
            + tap(v0 + 1, u0, (1 - du) * dv)
            + tap(v0 + 1, u0 + 1, du * dv))


class SingleViewNet(nn.Module):
    """One view's tower: point net (``pointnet``: bias-free linear,
    BatchNorm over the view's valid points, ReLU) -> pillar max (K1) ->
    splat onto the view's (B, ny, nx, C) canvas (K2) -> ``res1`` (stride
    1), ``res2`` (stride 2) and ``res3`` (stride 2 on ``res2``) ->
    ``deconv2`` and ``deconv3`` (kernel = stride transposed convs as a
    matmul and depth-to-space) cropped to ``res1``'s size -> concat ->
    ``fuse_conv`` (3 x 3, with bias) -> bilinear sample at each point."""

    def __init__(self, in_channels: int, feat_channels: int,
                 voxel_size: Sequence[float],
                 point_cloud_range: Sequence[float], reduce_op: str = 'max'):
        super().__init__()
        fc = feat_channels
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.nx, self.ny, nz = view_grid(point_cloud_range, voxel_size)
        if nz != 1:
            raise ValueError(f'a view needs one voxel along its third axis '
                             f'(one pillar a canvas cell), got {nz}')
        self.reduce_op = reduce_op
        self.pointnet = DynamicPFNLayer(in_channels, fc)
        self.res1 = BasicBlock2D(fc, fc)
        self.res2 = BasicBlock2D(fc, fc, stride=2)
        self.res3 = BasicBlock2D(fc, fc, stride=2)
        self.deconv2 = ConvTranspose2d(fc, fc, 2, stride=2, bias=False)
        self.deconv3 = ConvTranspose2d(fc, fc, 4, stride=4, bias=False)
        self.fuse_conv = Conv2d(3 * fc, fc, 3, padding=1, bias=True)

    def forward(self, pts_xyz: torch.Tensor, pts_feats: torch.Tensor,
                scatter: Scatter, batch_idx: torch.Tensor,
                batch_size: int) -> torch.Tensor:
        """pts_xyz (N, 3) view coords, pts_feats (N, C_in), batch_idx (N,)
        -> (N, feat_channels); points outside the view's voxels read 0."""
        valid = scatter.valid_point_mask
        y = self.pointnet(pts_feats, valid)
        pillar = scatter.reduce(y, self.reduce_op)
        canvas = bev_scatter(pillar, scatter.voxel_coords, batch_size,
                             self.nx, self.ny)
        out1 = self.res1(canvas)
        out2 = self.res2(canvas)
        out3 = self.res3(out2)
        h, w = out1.shape[1:3]
        out2 = nchw_to_nhwc(self.deconv2(nhwc_to_nchw(out2)))[:, :h, :w]
        out3 = nchw_to_nhwc(self.deconv3(nhwc_to_nchw(out3)))[:, :h, :w]
        fused = torch.cat([out1, out2, out3], -1)
        fused = nchw_to_nhwc(self.fuse_conv(nhwc_to_nchw(fused)))
        pcr = self.point_cloud_range
        u = (pts_xyz[:, 0] - pcr[0]) / (pcr[3] - pcr[0]) * self.nx - 0.5
        v = (pts_xyz[:, 1] - pcr[1]) / (pcr[4] - pcr[1]) * self.ny - 0.5
        return bilinear_sample_zeros(fused, torch.stack([u, v], -1),
                                     batch_idx, valid)


@MODELS.register_module()
class PillarMVFFeatureNet(nn.Module):
    """Multi-view pillar encoder.  ``forward(points, points_mask)`` ->
    (pillar features (max_voxels, feat_channels), view 0's voxel coords
    (max_voxels, 4) as (b, ix, iy, iz), view 0's Scatter).

    A point outside any view's range is invalid in every view.  Each view
    compacts its voxels in its canvas raster order.  The point features are
    every view's :class:`PointVoxelStatsCalculator` decoration (25
    channels each, in view order) and then the points' extra channels;
    ``pointnet1`` reads them, each view's tower and ``pointnet2`` read its
    output, ``pointnet3`` fuses those, and the result reduces (max) on view
    0's pillars.  Parameters follow the JAX module's names: ``pointnet{1,2,
    3}`` (``linear``, ``norm``) and ``views.{view}`` (:class:`SingleViewNet`).
    ``max_voxels`` is each view's capacity for the batch; the trunk passes
    ``max_voxels_per_sample * B`` unless the config names one.  Under a
    ``group`` (the trunk's, in training) the batch is the global one: each
    view keeps the voxels one process keeps on the whole batch, every
    view truncating with its own rank offset (both sort batch first), as
    the JAX package's sharded step."""

    def __init__(self, in_channels: int = 4, feat_channels: int = 64,
                 views: Sequence[str] = ('cartesian', 'cylindrical'),
                 voxel_size: Sequence[Sequence[float]] = (
                     (0.32, 0.32, 6.0), (0.006545, 0.2, 80.0)),
                 point_cloud_range: Sequence[Sequence[float]] = (
                     (-74.88, -74.88, -2, 74.88, 74.88, 4),
                     (-3.1416, -2.0, 0.0, 3.1416, 4.0, 80.0)),
                 with_covariance: bool = True, reduce_op: str = 'max',
                 max_voxels: int = 30000):
        super().__init__()
        if len({len(views), len(voxel_size), len(point_cloud_range)}) != 1:
            raise ValueError('views, voxel_size and point_cloud_range must '
                             'have one entry a view')
        unknown = [v for v in views if v not in VIEW_TRANSFORMS]
        if unknown:
            raise ValueError(f'unknown views {unknown}; known: '
                             f'{sorted(VIEW_TRANSFORMS)}')
        self.view_names = tuple(views)
        self.voxel_size = tuple(tuple(v) for v in voxel_size)
        self.point_cloud_range = tuple(tuple(p) for p in point_cloud_range)
        self.reduce_op = reduce_op
        self.max_voxels = max_voxels
        self.stats = nn.ModuleList(
            PointVoxelStatsCalculator(voxel_size=vs, point_cloud_range=pcr,
                                      with_covariance=with_covariance)
            for vs, pcr in zip(self.voxel_size, self.point_cloud_range))
        fc = feat_channels
        cin = sum(s.out_channels for s in self.stats) + in_channels - 3
        self.pointnet1 = DynamicPFNLayer(cin, fc)
        self.views = nn.ModuleDict(
            (name, SingleViewNet(fc, fc, vs, pcr, reduce_op))
            for name, vs, pcr in zip(self.view_names, self.voxel_size,
                                     self.point_cloud_range))
        self.pointnet2 = DynamicPFNLayer(fc, fc)
        self.pointnet3 = DynamicPFNLayer(fc * (len(views) + 1), fc)

    def canvas_size(self):
        """(nx, ny) of view 0's canvas, the trunk's BEV canvas."""
        return view_grid(self.point_cloud_range[0], self.voxel_size[0])[:2]

    def scatters(self, points: torch.Tensor, points_mask: torch.Tensor,
                 max_voxels: Optional[int] = None, group=None):
        """-> (each view's (N, C) points, each view's Scatter, the (N,)
        cross-view valid mask, the (N,) batch index) of the flattened
        (B * N) points; ``group`` as ``build_scatter``'s."""
        b, n, cdim = points.shape
        flat = points.reshape(b * n, cdim)
        bidx = torch.arange(b, dtype=torch.int32,
                            device=points.device).repeat_interleave(n)
        pmask = points_mask.reshape(-1)
        view_pts, view_coords = [], []
        for name, vs, pcr in zip(self.view_names, self.voxel_size,
                                 self.point_cloud_range):
            vp = VIEW_TRANSFORMS[name](flat)
            coords3, _ = compute_voxel_coords(vp[:, :3], pcr, vs)
            view_pts.append(vp)
            view_coords.append(torch.where(pmask[:, None], coords3, -1))
        # a point invalid in any view is invalid in all
        invalid = ~pmask
        for c3 in view_coords:
            invalid = invalid | (c3 < 0).all(-1)
        cap = max_voxels or self.max_voxels
        scatters = [build_scatter(batch_coords(
            torch.where(invalid[:, None], -1, c3), bidx),
            (b,) + view_grid(pcr, vs), cap, key_order=VIEW_KEY_ORDER,
            group=group)
            for c3, vs, pcr in zip(view_coords, self.voxel_size,
                                   self.point_cloud_range)]
        return view_pts, scatters, ~invalid, bidx

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor,
                max_voxels: Optional[int] = None, group=None):
        b = points.shape[0]
        view_pts, scatters, valid, bidx = self.scatters(points, points_mask,
                                                        max_voxels, group)
        feats = [stats(vp[:, :3], sc)
                 for stats, vp, sc in zip(self.stats, view_pts, scatters)]
        feats.append(points.reshape(-1, points.shape[-1])[:, 3:])
        x1 = self.pointnet1(torch.cat(feats, -1), valid)
        mvf = [net(vp[:, :3], x1, sc, bidx, b)
               for net, vp, sc in zip(self.views.values(), view_pts,
                                      scatters)]
        mvf.append(self.pointnet2(x1, valid))
        fused = self.pointnet3(torch.cat(mvf, -1), valid)
        pillar = scatters[0].reduce(fused, self.reduce_op)
        return pillar, scatters[0].voxel_coords, scatters[0]
