"""Image-fused pillar trunk of MVX (the reference's ``MVXFasterRCNNRev``
slot).

Port of ``mmdet3d_gaussian_tpu/models/detectors/mvx_faster_rcnn.py``: the
image branch (:class:`~..img_fusion.ImgBackbone` ->
:class:`~..img_fusion.ImgFPNNeck`, maps cast to f32) paints image features
onto every point (:class:`~..img_fusion.PointFusion`), and the painted
cloud runs the dynamic pillar pipeline of
:class:`~.voxelnet.PointPillarsNet` on the plain canvas (K1 in the encoder,
K2 for the splat), SECOND, SECONDFPN and the anchor head's convs.  As in the
JAX module there is no hard mode and no space-to-depth canvas, and the
neck's levels are concatenated before the head.

With ``compute_dtype='bfloat16'`` the image branch, SECOND and SECONDFPN
compute in bf16 (the image branch's BatchNorms leave f32, see
:mod:`..img_fusion`), the encoder and the fusion in f32, the pillar rows
are cast to bf16 for the splat, and the head computes in bf16 on the bf16
neck map (JAX's head has no dtype but casts its weight to its input's).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ...registry import MODELS
from ..img_fusion import ImgBackbone, ImgFPNNeck, PointFusion
from .voxelnet import PointPillarsNet


@MODELS.register_module()
class MVXPillarsNet(PointPillarsNet):
    """``forward(points, points_mask, img, lidar2img)`` -> NHWC
    (cls_score, bbox_pred, dir_pred, packed).  ``img`` (B, H, W, 3) f32
    normalized; ``lidar2img`` (B, 4, 4) maps LiDAR xyz1 to the pixel
    homogeneous coords of that (H, W) image."""

    def __init__(self, voxel_size: Sequence[float] = (0.16, 0.16, 4.0),
                 point_cloud_range: Sequence[float] = (
                     0., -39.68, -3., 69.12, 39.68, 1.),
                 max_voxels_per_sample: int = 16000,
                 img_backbone_cfg: Optional[Dict[str, Any]] = None,
                 img_neck_cfg: Optional[Dict[str, Any]] = None,
                 fusion_cfg: Optional[Dict[str, Any]] = None,
                 encoder_cfg: Optional[Dict[str, Any]] = None,
                 backbone_cfg: Optional[Dict[str, Any]] = None,
                 neck_cfg: Optional[Dict[str, Any]] = None,
                 head_cfg: Optional[Dict[str, Any]] = None,
                 axis_name: Optional[str] = None,
                 compute_dtype: Optional[str] = None):
        # JAX's SECONDFPN concatenates its levels unless told otherwise,
        # and the MVX trunk does not tell it
        neck_cfg = dict(neck_cfg or {})
        neck_cfg.setdefault('concat_out', True)
        super().__init__(voxel_size=voxel_size,
                         point_cloud_range=point_cloud_range,
                         max_voxels_per_sample=max_voxels_per_sample,
                         voxelize_mode='dynamic', s2d_canvas='off',
                         encoder_cfg=encoder_cfg, backbone_cfg=backbone_cfg,
                         neck_cfg=neck_cfg, head_cfg=head_cfg,
                         compute_dtype=compute_dtype, axis_name=axis_name)
        bb_cfg = dict(img_backbone_cfg or {})
        neck_kw = dict(img_neck_cfg or {})
        neck_kw.setdefault('in_channels', tuple(
            bb_cfg.get('stage_channels', (32, 64, 128, 256))))
        fusion_kw = dict(fusion_cfg or {})
        fusion_kw.setdefault('in_channels', neck_kw.get('out_channels', 64))
        self.img_backbone = ImgBackbone(dtype=self.compute_dtype, **bb_cfg)
        self.img_neck = ImgFPNNeck(dtype=self.compute_dtype, **neck_kw)
        self.fusion = PointFusion(**fusion_kw)

    def image_features(self, img: torch.Tensor):
        """img (B, H, W, 3) -> the FPN maps, f32 NHWC."""
        return [f.float() for f in self.img_neck(self.img_backbone(img))]

    def paint(self, points: torch.Tensor, img: torch.Tensor,
              lidar2img: torch.Tensor) -> torch.Tensor:
        """points (B, N, C) -> (B, N, C + fusion channels): the points with
        the image features painted on (zero off the image)."""
        feats = self.image_features(img)
        img_hw = (img.shape[1], img.shape[2])
        painted = self.fusion(feats, points[..., :3], lidar2img, img_hw)
        return torch.cat([points, painted], dim=-1)

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor,
                img: torch.Tensor, lidar2img: torch.Tensor):
        return super().forward(self.paint(points, img, lidar2img),
                               points_mask)
