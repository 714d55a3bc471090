"""Point-sharded trainable PointPillars.

Port of ``mmdet3d_gaussian_tpu/parallel/sharded_model.py``.  The points of
each sample are split over the ranks of a points group
(``mesh.init_mesh``, ``mesh.shard_points``):

* the per-point MLP runs on each rank's slice; its ``MaskedBatchNorm``
  takes its statistics over every rank of the job (each holds other
  points of the global batch);
* the pillars are a dense-canvas mean: each rank scatter-adds its partial
  sums and counts into the ``ny x nx`` canvas (``index_add_``, as JAX's
  ``.at[].add``), and the partials are merged over the points group,
  ``'dense'`` by one all-reduce of the canvas or ``'sparse'`` by the
  stripe exchange of ``point_sharding.sharded_feature_splat_sparse``;
* the trunk (SECOND, SECONDFPN, the anchor head's convolutions) runs on
  the merged canvas of the data rank's samples, alike on every rank of the
  points group (JAX constrains the canvas to ``P('data', None, None,
  None)``); its BatchNorms take their statistics over the data group.

Without groups (one process, JAX's ``point_axis=None``) it is the same
function of the whole batch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.backbones import SECOND, SECONDFPN, BatchNorm2d
from ..models.dense_heads.anchor3d_head import Anchor3DHeadConvs
from ..models.voxel_encoders import DynamicPFNLayer, MaskedBatchNorm
from ..ops.scatter import compute_voxel_coords
from .mesh import Group, PointMesh, all_reduce_replicated
from .point_sharding import canvas_sums, sharded_feature_splat_sparse


class DensePillarEncoder(nn.Module):
    """Pointwise MLP + dense-canvas mean.  Unlike the dynamic encoder the
    pillar table is the canvas itself: no sort and no compaction, so the
    encoder runs no kernel of its own.

    The input of layer 0 is ``[points, xy - pillar centre]`` (C + 2
    channels; the centre ``(i + 0.5) size + min`` of the point's cell);
    each layer is a bias-free ``Linear``, ``MaskedBatchNorm`` on the valid
    points, then ReLU (``pfn_layers.{i}.linear`` / ``.norm``, the names the
    weight converter gives JAX's ``linear_{i}`` / ``norm_{i}``).

    ``merge``: ``'dense'`` or ``'sparse'`` (over ``points_group``, set by
    :meth:`ShardedPointPillarsNet.set_mesh`; None: no merge, one
    process); ``bucket_capacity``: the sparse merge's rows a (rank,
    stripe)."""

    def __init__(self, in_channels: int = 4,
                 feat_channels: Sequence[int] = (64,),
                 voxel_size: Sequence[float] = (0.16, 0.16, 4.0),
                 point_cloud_range: Sequence[float] = (
                     0., -39.68, -3., 69.12, 39.68, 1.),
                 merge: str = 'dense',
                 bucket_capacity: Optional[int] = None):
        super().__init__()
        if merge not in ('dense', 'sparse'):
            raise ValueError(f'merge must be dense or sparse, got {merge!r}')
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.merge = merge
        self.bucket_capacity = bucket_capacity
        self.points_group: Optional[Group] = None
        layers, cin = [], in_channels + 2
        for ch in feat_channels:
            layers.append(DynamicPFNLayer(cin, ch))
            cin = ch
        self.pfn_layers = nn.ModuleList(layers)

    def point_features(self, points: torch.Tensor,
                       points_mask: torch.Tensor, nx: int, ny: int):
        """points (B, N, C), points_mask (B, N) -> (features (B, N,
        C_out), canvas cells ``iy nx + ix`` (B, N) int64, valid (B, N)
        bool)."""
        b, n, cdim = points.shape
        flat = points.reshape(b * n, cdim)
        coords, _ = compute_voxel_coords(flat[:, :3], self.point_cloud_range,
                                         self.voxel_size)
        coords = torch.where(points_mask.reshape(-1, 1), coords, -1)
        valid = (coords >= 0).all(-1)
        vs = torch.tensor(self.voxel_size[:2], dtype=points.dtype,
                          device=points.device)
        lo = torch.tensor(self.point_cloud_range[:2], dtype=points.dtype,
                          device=points.device)
        center = (coords[:, :2].to(points.dtype) + 0.5) * vs + lo
        x = torch.cat([flat, flat[:, :2] - center], dim=-1)
        for layer in self.pfn_layers:
            x = layer(x, valid)
        lin = torch.where(valid, coords[:, 1].long() * nx + coords[:, 0],
                          nx * ny)
        return x.reshape(b, n, -1), lin.reshape(b, n), valid.reshape(b, n)

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor,
                nx: int, ny: int) -> torch.Tensor:
        """points (B, N, C), points_mask (B, N) -> canvas (B, ny, nx,
        C_out) f32, the merged mean of every rank's points of the
        samples."""
        x, lin, valid = self.point_features(points, points_mask, nx, ny)
        group = self.points_group
        if self.merge == 'sparse' and group is not None:
            table = sharded_feature_splat_sparse(
                x, lin, valid, nx, ny, group,
                bucket_capacity=self.bucket_capacity)  # (B, ny, nx, C + 1)
        else:
            table = canvas_sums(x, lin, valid, nx, ny)
            if group is not None:
                table = all_reduce_replicated(table, group)
        canvas = table[..., :-1] / table[..., -1:].clamp(min=1.0)
        return canvas.reshape(x.shape[0], ny, nx, -1)


class ShardedPointPillarsNet(nn.Module):
    """The trainable trunk: :class:`DensePillarEncoder` -> SECOND ->
    SECONDFPN (concatenated, as JAX's) -> the anchor head's convolutions;
    ``forward(points, points_mask)`` -> NHWC (cls_score, bbox_pred,
    dir_pred, packed), f32 (JAX's sharded trunk has no compute dtype)."""

    def __init__(self, voxel_size: Sequence[float] = (0.16, 0.16, 4.0),
                 point_cloud_range: Sequence[float] = (
                     0., -39.68, -3., 69.12, 39.68, 1.),
                 encoder_cfg: Optional[Dict[str, Any]] = None,
                 backbone_cfg: Optional[Dict[str, Any]] = None,
                 neck_cfg: Optional[Dict[str, Any]] = None,
                 head_cfg: Optional[Dict[str, Any]] = None,
                 merge: str = 'dense',
                 bucket_capacity: Optional[int] = None):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.nx, self.ny = self.grid()
        enc_cfg = dict(encoder_cfg or {})
        self.voxel_encoder = DensePillarEncoder(
            voxel_size=self.voxel_size,
            point_cloud_range=self.point_cloud_range, merge=merge,
            bucket_capacity=bucket_capacity, **enc_cfg)
        self.backbone = SECOND(**(backbone_cfg or {}))
        self.neck = SECONDFPN(**(neck_cfg or {}))
        self.bbox_head = Anchor3DHeadConvs(**(head_cfg or {}))

    def grid(self) -> Tuple[int, int]:
        """(nx, ny) of the BEV canvas."""
        pcr, vs = self.point_cloud_range, self.voxel_size
        return (int(round((pcr[3] - pcr[0]) / vs[0])),
                int(round((pcr[4] - pcr[1]) / vs[1])))

    def set_mesh(self, mesh: Optional[PointMesh]) -> None:
        """Train and predict on ``mesh`` (None: one process): the
        encoder's merge over the points group, its ``MaskedBatchNorm``
        statistics over the world, the trunk's ``BatchNorm2d`` statistics
        over the data group."""
        self.voxel_encoder.points_group = mesh and mesh.points
        for m in self.modules():
            if isinstance(m, MaskedBatchNorm):
                m.group = mesh and mesh.world
            elif isinstance(m, BatchNorm2d):
                m.group = mesh and mesh.data

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor):
        canvas = self.voxel_encoder(points, points_mask, self.nx, self.ny)
        return self.bbox_head(self.neck(self.backbone(canvas)))
