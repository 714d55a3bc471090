"""PointPillars trunk (dynamic voxelize): points -> pillar features -> BEV
canvas -> SECOND -> SECONDFPN -> head maps.

Port of ``mmdet3d_gaussian_tpu/models/detectors/voxelnet.py::
PointPillarsNet``, dynamic branch with the plain canvas (voxels compacted in
canvas raster order, ``CANVAS_KEY_ORDER``).  The batch is flattened to one
point axis with a batch-id coord column, so voxelization of the whole batch
is one sort and one K1 pass per reduction.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.scatter import batch_coords, build_scatter, compute_voxel_coords
from ...ops.voxelize import CANVAS_KEY_ORDER, bev_scatter
from ...registry import MODELS
from ..backbones import SECOND, SECONDFPN
from ..dense_heads.anchor3d_head import Anchor3DHeadConvs
from ..voxel_encoders import DynamicPillarFeatureNet


@MODELS.register_module()
class PointPillarsNet(nn.Module):
    """Learned trunk; ``forward(points, points_mask)`` returns NHWC
    (cls_score, bbox_pred, dir_pred, packed)."""

    def __init__(self, voxel_size: Sequence[float] = (0.16, 0.16, 4.0),
                 point_cloud_range: Sequence[float] = (
                     0., -39.68, -3., 69.12, 39.68, 1.),
                 max_points_per_voxel: int = 32,
                 max_voxels_per_sample: int = 16000,
                 voxelize_mode: str = 'dynamic',
                 head_type: str = 'anchor',
                 encoder_cfg: Optional[Dict[str, Any]] = None,
                 backbone_cfg: Optional[Dict[str, Any]] = None,
                 neck_cfg: Optional[Dict[str, Any]] = None,
                 head_cfg: Optional[Dict[str, Any]] = None,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if voxelize_mode != 'dynamic':
            raise NotImplementedError(
                f'voxelize_mode={voxelize_mode!r} is not ported yet; only '
                f"'dynamic' is")
        if head_type != 'anchor':
            raise NotImplementedError(f'head_type={head_type!r} is not '
                                      f'ported yet')
        if compute_dtype is not None:
            raise NotImplementedError('only f32 is ported so far')
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_voxels_per_sample = max_voxels_per_sample
        self.nx, self.ny = self.grid()
        nz = max(1, int(round((self.point_cloud_range[5]
                               - self.point_cloud_range[2])
                              / self.voxel_size[2])))
        if nz != 1:
            raise ValueError('PointPillars needs one voxel in z (pillars); '
                             f'got {nz}')
        enc_cfg = dict(encoder_cfg or {})
        enc_cfg.setdefault('voxel_size', self.voxel_size)
        enc_cfg.setdefault('point_cloud_range', self.point_cloud_range)
        self.voxel_encoder = DynamicPillarFeatureNet(**enc_cfg)
        self.backbone = SECOND(**(backbone_cfg or {}))
        neck_kw = dict(neck_cfg or {})
        neck_kw.setdefault('concat_out', False)
        self.neck = SECONDFPN(**neck_kw)
        self.bbox_head = Anchor3DHeadConvs(**(head_cfg or {}))

    def grid(self) -> Tuple[int, int]:
        pcr, vs = self.point_cloud_range, self.voxel_size
        nx = int(round((pcr[3] - pcr[0]) / vs[0]))
        ny = int(round((pcr[4] - pcr[1]) / vs[1]))
        return nx, ny

    def pillars(self, points: torch.Tensor, points_mask: torch.Tensor):
        """points (B, N, C), points_mask (B, N) -> (pillar features
        (max_voxels, C_out), voxel coords (max_voxels, 4) as (b, ix, iy,
        iz), the Scatter)."""
        b, n, cdim = points.shape
        max_voxels = self.max_voxels_per_sample * b
        flat = points.reshape(b * n, cdim)
        batch_idx = torch.arange(b, dtype=torch.int32,
                                 device=points.device).repeat_interleave(n)
        coords3, _ = compute_voxel_coords(flat[:, :3], self.point_cloud_range,
                                          self.voxel_size)
        coords3 = torch.where(points_mask.reshape(-1, 1), coords3, -1)
        coords4 = batch_coords(coords3, batch_idx)
        scatter = build_scatter(coords4, (b, self.nx, self.ny, 1),
                                max_voxels, key_order=CANVAS_KEY_ORDER)
        # permute points into voxel-sorted order once; every reduction in
        # the encoder then runs over contiguous segments
        flat_sorted = flat[scatter.sort_order]
        feats = self.voxel_encoder(flat_sorted, scatter.sorted_view())
        return feats, scatter.voxel_coords, scatter

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor):
        pillar_feats, coords_v, _ = self.pillars(points, points_mask)
        canvas = bev_scatter(pillar_feats, coords_v, points.shape[0],
                             self.nx, self.ny)
        feats = self.neck(self.backbone(canvas))
        return self.bbox_head(feats)
