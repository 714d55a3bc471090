"""Dynamic pillar feature net (eval), point rows sorted by voxel.

Port of ``mmdet3d_gaussian_tpu/models/voxel_encoders.py``:
:class:`MaskedBatchNorm` (running statistics), the kernel-path branch of
:class:`PointVoxelStatsCalculator` and :class:`DynamicPillarFeatureNet`.
Every per-voxel reduction goes through kernel K1 via :class:`Scatter`.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.scatter import Scatter
from ..registry import MODELS


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the last dim with running statistics (eval only).

    Parameter names follow ``nn.BatchNorm1d`` (weight, bias, running_mean,
    running_var); eps 1e-3 as the reference norm_cfg."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError('MaskedBatchNorm is ported for eval '
                                      'only')
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean) * inv
                + self.bias).to(x.dtype)


class PointVoxelStatsCalculator(nn.Module):
    """Per-point decoration from voxel statistics.  Channel order: raw xyz,
    then optionally cluster mean (3), offset to mean (3), 3x3 covariance
    (9), voxel centre (3), offset to centre (3), point count (1)."""

    def __init__(self, voxel_size: Sequence[float],
                 point_cloud_range: Sequence[float],
                 with_cluster_center: bool = True,
                 with_cluster_center_offset: bool = True,
                 with_covariance: bool = True,
                 with_voxel_center: bool = True,
                 with_voxel_point_count: bool = True,
                 with_voxel_center_offset: bool = True):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.with_cluster_center = with_cluster_center
        self.with_cluster_center_offset = with_cluster_center_offset
        self.with_covariance = with_covariance
        self.with_voxel_center = with_voxel_center
        self.with_voxel_point_count = with_voxel_point_count
        self.with_voxel_center_offset = with_voxel_center_offset

    @property
    def out_channels(self) -> int:
        return (3 + 3 * self.with_cluster_center
                + 3 * self.with_cluster_center_offset
                + 9 * self.with_covariance + 3 * self.with_voxel_center
                + 3 * self.with_voxel_center_offset
                + self.with_voxel_point_count)

    def forward(self, points_xyz: torch.Tensor, scatter: Scatter):
        dt, dev = points_xyz.dtype, points_xyz.device
        valid = scatter.valid_point_mask[:, None]
        mean = scatter.reduce_mapback(points_xyz, 'mean')      # (N, 3)
        ctr = None
        if self.with_voxel_center or self.with_voxel_center_offset:
            # a point's voxel centre is a pointwise function of its own
            # coords (same floor convention as compute_voxel_coords)
            vsz = torch.tensor(self.voxel_size, dtype=dt, device=dev)
            org = torch.tensor(self.point_cloud_range[:3], dtype=dt,
                               device=dev)
            cell = torch.floor((points_xyz - org) / vsz)
            ctr = torch.where(valid, (cell + 0.5) * vsz + org, 0.0)
        off = points_xyz - mean
        feats = [points_xyz]
        if self.with_cluster_center:
            feats.append(mean)
        if self.with_cluster_center_offset:
            feats.append(off)
        if self.with_covariance:
            outer = (off[:, None, :] * off[:, :, None]).reshape(-1, 9)
            feats.append(scatter.reduce_mapback(outer, 'mean'))
        if self.with_voxel_center:
            feats.append(ctr)
        if self.with_voxel_center_offset:
            feats.append(points_xyz - ctr)
        if self.with_voxel_point_count:
            feats.append(scatter.mapback(
                scatter.voxel_counts[:, None].to(dt)))
        return torch.cat(feats, dim=-1)


class DynamicPFNLayer(nn.Module):
    """Linear (no bias) -> MaskedBatchNorm -> ReLU on point rows."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels, bias=False)
        self.norm = MaskedBatchNorm(out_channels)

    def forward(self, x):
        return torch.relu(self.norm(self.linear(x)))


@MODELS.register_module()
class DynamicPillarFeatureNet(nn.Module):
    """Point-level pillar encoder: stats decoration, per-point PFN layers
    (voxel max mapped back between layers), final per-voxel reduction.

    Input ``points`` (N, C_in) with xyz first, sorted by voxel (the rows of
    ``scatter``'s sorted view); returns (max_voxels, feat_channels[-1])."""

    def __init__(self, in_channels: int = 4,
                 feat_channels: Sequence[int] = (64,),
                 with_cluster_center: bool = False,
                 with_cluster_center_offset: bool = True,
                 with_covariance: bool = False,
                 with_voxel_center: bool = False,
                 with_voxel_point_count: bool = False,
                 with_voxel_center_offset: bool = True,
                 reduce_op: str = 'max',
                 voxel_size: Sequence[float] = (0.16, 0.16, 4.0),
                 point_cloud_range: Sequence[float] = (
                     0., -39.68, -3., 69.12, 39.68, 1.)):
        super().__init__()
        self.stats = PointVoxelStatsCalculator(
            voxel_size=voxel_size, point_cloud_range=point_cloud_range,
            with_cluster_center=with_cluster_center,
            with_cluster_center_offset=with_cluster_center_offset,
            with_covariance=with_covariance,
            with_voxel_center=with_voxel_center,
            with_voxel_point_count=with_voxel_point_count,
            with_voxel_center_offset=with_voxel_center_offset)
        self.reduce_op = reduce_op
        cin = self.stats.out_channels + in_channels - 3
        layers = []
        for i, ch in enumerate(feat_channels):
            layers.append(DynamicPFNLayer(cin, ch))
            cin = 2 * ch     # point features + mapped-back voxel max
        self.pfn_layers = nn.ModuleList(layers)

    def forward(self, points: torch.Tensor, scatter: Scatter):
        x = torch.cat([self.stats(points[:, :3], scatter), points[:, 3:]],
                      dim=-1)
        valid = scatter.valid_point_mask[:, None]
        x = x * valid.to(x.dtype)
        last = len(self.pfn_layers) - 1
        for i, layer in enumerate(self.pfn_layers):
            y = layer(x)
            x = (torch.cat([y, scatter.reduce_mapback(y, 'max')], dim=-1)
                 if i < last else y)
        return scatter.reduce(x, self.reduce_op)
