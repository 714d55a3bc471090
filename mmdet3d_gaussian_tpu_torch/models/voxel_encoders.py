"""Pillar feature nets: hard (padded) pillars and dynamic point rows.

Port of ``mmdet3d_gaussian_tpu/models/voxel_encoders.py``:
:class:`MaskedBatchNorm`, :class:`PFNLayer` and :class:`PillarFeatureNet`
(the hard encoder on a packed ``(V, P, C)`` table), the same function on
rank-masked voxel-sorted point rows (:class:`SortedPillarFeatureNet`), the
kernel-path branch of :class:`PointVoxelStatsCalculator` and
:class:`DynamicPillarFeatureNet`.  Every per-voxel reduction of the sorted
and dynamic encoders goes through kernel K1 via :class:`Scatter`; the packed
encoder reduces over the slot axis of its table.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.scatter import Scatter
from ..parallel.mesh import all_reduce_with_grad
from ..registry import MODELS
from .backbones import MOMENTUM, compute_dtype as _compute_dtype


def masked_sums(flat: torch.Tensor, mask=None):
    """(count, per-channel sum, sum of squares) of the f32 rows ``flat``
    (M, C) where ``mask`` (M elements, or None: every row) is set; the
    count a 0-d tensor."""
    if mask is None:
        return (flat.new_tensor(float(flat.shape[0])), flat.sum(0),
                (flat * flat).sum(0))
    m = mask.reshape(-1, 1).to(flat.dtype)
    return m.sum(), (flat * m).sum(0), (flat * flat * m).sum(0)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the last dim; in training the statistics come from
    the rows where ``mask`` is set (``cnt = max(sum mask, 1)``, biased
    variance ``max(E[x^2] - mean^2, 0)``) and the running statistics move
    as ``0.99 old + 0.01 batch``.  Plain PyTorch, as the JAX module
    computes it outside Pallas.

    ``group`` (a ``parallel.mesh.Group``, set by the detector of a
    data-parallel step; None by default): the count and sums are summed
    over the ranks before the count is clamped (SyncBN, the statistics of
    the whole batch), by an all-reduce that carries their gradient, as JAX
    differentiates through the mean and variance here.

    Parameter names follow ``nn.BatchNorm1d`` (weight, bias, running_mean,
    running_var); eps 1e-3 as the reference norm_cfg."""

    def __init__(self, num_features: int, eps: float = 1e-3):
        super().__init__()
        self.group = None
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            cnt, s1, s2 = masked_sums(xf.reshape(-1, xf.shape[-1]), mask)
            if self.group is not None:
                c = s1.shape[0]
                flat = all_reduce_with_grad(
                    torch.cat([cnt.reshape(1), s1, s2]), self.group)
                cnt, s1, s2 = flat[0], flat[1:1 + c], flat[1 + c:]
            cnt = cnt.clamp(min=1.0)
            mean = s1 / cnt
            var = torch.clamp_min(s2 / cnt - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(MOMENTUM).add_(mean,
                                                      alpha=1 - MOMENTUM)
                self.running_var.mul_(MOMENTUM).add_(var, alpha=1 - MOMENTUM)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * inv + self.bias).to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` without bias computing in ``compute_dtype`` (None: the
    weight's type) on the cast input and weight, as a flax ``Dense`` with
    ``dtype`` set."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        return F.linear(x.to(dt), self.weight.to(dt))


class PFNLayer(nn.Module):
    """Linear (no bias) -> MaskedBatchNorm (statistics over the slot mask)
    -> ReLU -> max over the slot axis of ``(V, P, C)`` pillars.

    A non-last layer emits ``out_channels // 2`` units and concatenates the
    pillar max tiled over the slots.  ``masked_max=False`` (the reference)
    takes the max over the padded slots too, where ``relu(BN(0))`` is a
    per-channel constant; ``True`` leaves them out.  The max is ``amax``,
    whose gradient splits evenly among ties, as ``jnp.max``'s."""

    def __init__(self, in_channels: int, out_channels: int,
                 last_layer: bool = False, masked_max: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.last_layer = last_layer
        self.masked_max = masked_max
        self.units = out_channels if last_layer else out_channels // 2
        self.linear = Linear(in_channels, self.units, compute_dtype=dtype)
        self.norm = MaskedBatchNorm(self.units)

    @property
    def out_channels(self) -> int:
        return self.units if self.last_layer else 2 * self.units

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (V, P, C_in), mask (V, P) bool -> (V, units) for the last
        layer, else (V, P, 2 units)."""
        y = torch.relu(self.norm(self.linear(x), mask))
        if self.masked_max:
            y_max = torch.where(mask[..., None], y, -1e4)
        else:
            y_max = y
        pooled = torch.amax(y_max, dim=-2)
        if self.last_layer:
            return pooled
        return torch.cat([y, pooled[:, None, :].expand_as(y)], dim=-1)


class _HardEncoder(nn.Module):
    """What the packed and sorted hard encoders share: their settings and
    their PFN layers (``pfn_layers.{i}.linear`` / ``.norm``, the same names
    in both, so weights move between them)."""

    def __init__(self, layer_cls, in_channels: int = 4,
                 feat_channels: Sequence[int] = (64,),
                 with_distance: bool = False,
                 with_cluster_center: bool = True,
                 with_voxel_center: bool = True,
                 voxel_size: Sequence[float] = (0.16, 0.16, 4.0),
                 point_cloud_range: Sequence[float] = (
                     0., -39.68, -3., 69.12, 39.68, 1.),
                 masked_max: bool = False, dtype=None):
        super().__init__()
        self.with_distance = with_distance
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        dt = _compute_dtype(dtype)
        cin = (in_channels + 3 * with_cluster_center
               + 3 * with_voxel_center + int(with_distance))
        layers = []
        for i, ch in enumerate(feat_channels):
            layer = layer_cls(cin, ch, last_layer=i == len(feat_channels) - 1,
                              masked_max=masked_max, dtype=dt)
            layers.append(layer)
            cin = layer.out_channels
        self.pfn_layers = nn.ModuleList(layers)


def _distance(xyz: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((xyz * xyz).sum(-1, keepdim=True))


@MODELS.register_module()
class PillarFeatureNet(_HardEncoder):
    """Hard-pillar encoder on packed pillars (``hard_voxelize``'s table).

    Decoration: the offset of each point from the mean xyz of its pillar's
    valid slots, its offset from the pillar centre in x, y and z (from the
    integer coords, ``(ix + 0.5) * vx + x_min``), and optionally
    ``||xyz||``; the decorated table is multiplied by the slot mask, so
    slots past ``num_points`` are 0 whatever the table holds there.  With
    ``dtype`` bf16 the linear layers compute in bf16 and the pillar rows
    come out bf16 (BatchNorm in f32)."""

    def __init__(self, **kw):
        super().__init__(PFNLayer, **kw)

    def forward(self, voxels: torch.Tensor, coords: torch.Tensor,
                num_points: torch.Tensor) -> torch.Tensor:
        """voxels (V, P, C); coords (V, 3) int (ix, iy, iz) or (V, 4)
        (b, ix, iy, iz); num_points (V,) -> (V, C_out)."""
        _, p, _ = voxels.shape
        dt = voxels.dtype
        mask = (torch.arange(p, device=voxels.device)[None, :]
                < num_points[:, None])
        fmask = mask[..., None].to(dt)
        xyz = voxels[..., :3]
        feats = [voxels]
        if self.with_cluster_center:
            cnt = num_points.clamp(min=1).to(dt)[:, None]
            mean = (xyz * fmask).sum(1) / cnt
            feats.append(xyz - mean[:, None, :])
        if self.with_voxel_center:
            off = 1 if coords.shape[-1] == 4 else 0
            centre = torch.stack(
                [(coords[:, off + d].to(dt) + 0.5) * self.voxel_size[d]
                 + self.point_cloud_range[d] for d in range(3)], dim=-1)
            feats.append(xyz - centre[:, None, :])
        if self.with_distance:
            feats.append(_distance(xyz))
        x = torch.cat(feats, dim=-1) * fmask
        for layer in self.pfn_layers:
            x = layer(x, mask)
        return x


class _SortedPFNLayer(PFNLayer):
    """:class:`PFNLayer` on voxel-sorted point rows (the same parameters):
    the rows of a voxel's padded slots, all equal at each layer, are
    carried as one virtual row per voxel."""

    def forward(self, x, pad_x, kept, scatter: Scatter, has_pad):
        """x (N, C) sorted point rows; pad_x (V, C) each voxel's padded-slot
        row; kept (N,) bool (live and among its voxel's first
        ``max_points``); has_pad (V,) bool (the voxel has a padded slot).
        -> (x_next, pad_next, pooled); x_next and pad_next None for the
        last layer."""
        n = x.shape[0]
        z = self.norm(self.linear(torch.cat([x, pad_x])),
                      torch.cat([kept, kept.new_zeros(pad_x.shape[0])]))
        z = torch.relu(z)
        y, pad_y = z[:n], z[n:]
        # K1 on the f32 cast of the rows (exact for a max); a voxel's
        # lowest row holding the max takes the gradient
        seg_max = scatter.reduce(torch.where(kept[:, None], y, -1e4), 'max')
        if self.masked_max:
            pooled = seg_max
        else:
            # padded slots join the max where the voxel has one; a tie
            # with them splits the gradient evenly, as jnp.maximum's
            pooled = torch.where(has_pad[:, None],
                                 torch.maximum(seg_max, pad_y), seg_max)
        if self.last_layer:
            return None, None, pooled
        return (torch.cat([y, scatter.mapback(pooled)], dim=-1),
                torch.cat([pad_y, pooled], dim=-1), pooled)


@MODELS.register_module()
class SortedPillarFeatureNet(_HardEncoder):
    """The function of :class:`PillarFeatureNet` on the voxel-sorted point
    rows, without the ``(V, P, C)`` table: the hard encoder is the dynamic
    one restricted to each voxel's first ``max_points`` points, so K1's
    segment reductions over a rank mask compute it.  The pillar centre
    comes from each point's own cell (the same floor as its voxel
    coords)."""

    def __init__(self, **kw):
        super().__init__(_SortedPFNLayer, **kw)

    def forward(self, points_sorted: torch.Tensor, scatter: Scatter,
                kept: torch.Tensor, kept_cnt: torch.Tensor,
                max_points: int) -> torch.Tensor:
        """points_sorted (N, C) voxel-sorted rows; scatter: the sorted view;
        kept (N,) bool; kept_cnt (V,) = min(count, max_points) ->
        (V, C_out)."""
        dt = points_sorted.dtype
        xyz = points_sorted[:, :3]
        kf = kept[:, None].to(dt)
        feats = [points_sorted]
        if self.with_cluster_center:
            vox_mean = (scatter.reduce(xyz * kf, 'sum')
                        / kept_cnt.clamp(min=1).to(dt)[:, None])
            feats.append(xyz - scatter.mapback(vox_mean))
        if self.with_voxel_center:
            vsz = torch.tensor(self.voxel_size, dtype=dt, device=xyz.device)
            org = torch.tensor(self.point_cloud_range[:3], dtype=dt,
                               device=xyz.device)
            cell = torch.floor((xyz - org) / vsz)
            feats.append(xyz - ((cell + 0.5) * vsz + org))
        if self.with_distance:
            feats.append(_distance(xyz))
        x = torch.cat(feats, dim=-1) * kf
        has_pad = kept_cnt < max_points
        pad_x = x.new_zeros((kept_cnt.shape[0], x.shape[-1]))
        pooled = None
        for layer in self.pfn_layers:
            x, pad_x, pooled = layer(x, pad_x, kept, scatter, has_pad)
        return pooled


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

    def forward(self, x, mask=None):
        return torch.relu(self.norm(self.linear(x), mask))


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
            y = layer(x, valid)
            x = (torch.cat([y, scatter.reduce_mapback(y, 'max')], dim=-1)
                 if i < last else y)
        return scatter.reduce(x, self.reduce_op)
