"""Multi-modal (image + LiDAR) detector engine, the MVXFasterRCNN slot.

Port of ``mmdet3d_gaussian_tpu/engine/mvx.py``: :data:`KITTI_MVX_MODEL`,
:class:`MVXDetector` and :func:`synthetic_mvx_batch`.  The detector is
:class:`~.detector.PointPillarsDetector` (the KITTI 3-class GD anchor head:
targets, loss, predict; ``init_train`` and ``train_step`` around
``parallel/train_state.py``) on the image-fused trunk
:class:`~..models.detectors.mvx_faster_rcnn.MVXPillarsNet`.  Its batch has
two more keys, handed to the trunk on the detector's device:

    img        (B, H, W, 3) f32, normalized
    lidar2img  (B, 4, 4) f32, LiDAR -> pixel homogeneous projection

Load JAX weights with ``det.trunk.load_state_dict(jax_variables_to_torch(
variables))``.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.dense_heads.anchor3d_head import GDAnchor3DHead
from ..models.detectors.mvx_faster_rcnn import MVXPillarsNet
from .detector import (KITTI_3CLASS_HEAD, PointPillarsDetector, init_weights,
                       synthetic_batch)


KITTI_MVX_MODEL = dict(
    voxel_size=(0.16, 0.16, 4.0),
    point_cloud_range=(0., -39.68, -3., 69.12, 39.68, 1.),
    max_voxels_per_sample=16000,
    img_backbone_cfg=dict(stage_channels=(32, 64, 128, 256),
                          blocks_per_stage=2),
    img_neck_cfg=dict(out_channels=64),
    fusion_cfg=dict(out_channels=64, img_levels=(4, 8, 16, 32)),
    # painted channels: 4 raw + 64 image
    encoder_cfg=dict(in_channels=68, feat_channels=(64,)),
    backbone_cfg=dict(in_channels=64, out_channels=(64, 128, 256),
                      layer_nums=(3, 5, 5), layer_strides=(2, 2, 2)),
    neck_cfg=dict(in_channels=(64, 128, 256), out_channels=(128, 128, 128),
                  upsample_strides=(1, 2, 4)),
    head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=384),
)


class MVXDetector(PointPillarsDetector):
    """Image-fused PointPillars with the GD anchor head.  ``model_cfg``
    updates :data:`KITTI_MVX_MODEL` (``compute_dtype='bfloat16'`` for the
    mixed precision), ``head_cfg`` :data:`~.detector.KITTI_3CLASS_HEAD`.
    ``apply_train`` and ``apply_eval`` return NHWC (cls_score, bbox_pred,
    dir_pred, packed).  It trains data parallel over a ``group`` as
    :class:`~.detector.PointPillarsDetector` does: the image branch's
    BatchNorms are synced with the trunk's, and the point fusion works
    per point (no batch-wide reduction)."""

    def __init__(self, model_cfg: Optional[Dict[str, Any]] = None,
                 head_cfg: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, group=None):
        self.device = resolve_device(device)
        mc = copy.deepcopy(KITTI_MVX_MODEL)
        mc.update(model_cfg or {})
        hc = copy.deepcopy(KITTI_3CLASS_HEAD)
        hc.update(head_cfg or {})
        self.model_cfg = mc
        self.trunk = MVXPillarsNet(**mc)
        init_weights(self.trunk, seed)
        self.trunk.to(self.device).eval()
        self.head = GDAnchor3DHead(**hc)
        nx, ny = self.trunk.grid()
        stride = mc['backbone_cfg']['layer_strides'][0]
        self.featmap_size = (ny // stride, nx // stride)
        self.anchors = torch.from_numpy(
            self.head.anchors_for(self.featmap_size)).to(self.device)
        if group is not None:
            self.set_group(group)

    def _inputs(self, batch: Dict[str, torch.Tensor]):
        return [batch[k].to(self.device)
                for k in ('points', 'points_mask', 'img', 'lidar2img')]

    def apply_train(self, batch: Dict[str, torch.Tensor]):
        """-> the trunk's head outputs in training mode (BatchNorms on batch
        statistics, their running statistics updated in place)."""
        self.trunk.train()
        return self.trunk(*self._inputs(batch))

    @torch.inference_mode()
    def apply_eval(self, batch: Dict[str, torch.Tensor]):
        """-> the trunk's head outputs in eval mode."""
        self.trunk.eval()
        return self.trunk(*self._inputs(batch))


def synthetic_mvx_batch(batch_size: int = 2, num_points: int = 8192,
                        num_gt: int = 16, img_hw=(192, 640), seed: int = 0,
                        pc_range=(0., -39.68, -3., 69.12, 39.68, 1.),
                        device: Optional[Union[str, torch.device]] = None):
    """KITTI-like batch with an image and a front camera's matrix: the
    arrays of the JAX package's ``synthetic_mvx_batch`` for equal arguments
    (``synthetic_batch``'s draws, then the image from
    ``RandomState(seed + 1)``; a pinhole looking down +x with fx = fy =
    0.6 w at the image's centre)."""
    dev = resolve_device(device)
    batch = synthetic_batch(batch_size, num_points, num_gt, seed, pc_range,
                            device=dev)
    rng = np.random.RandomState(seed + 1)
    h, w = img_hw
    img = rng.rand(batch_size, h, w, 3).astype(np.float32)
    # u = fx * (-y / x) + cx, v = fy * (-z / x) + cy: lidar2img = K @ R with
    # the camera axes (right = -y, down = -z, forward = x)
    fx = fy = 0.6 * w
    cx, cy = w / 2, h / 2
    cam = np.array([[0., -1., 0., 0.],
                    [0., 0., -1., 0.],
                    [1., 0., 0., 0.],
                    [0., 0., 0., 1.]], np.float32)
    k = np.array([[fx, 0., cx, 0.],
                  [0., fy, cy, 0.],
                  [0., 0., 1., 0.],
                  [0., 0., 0., 1.]], np.float32)
    l2i = (k @ cam)[None].repeat(batch_size, 0)
    batch['img'] = torch.from_numpy(img).to(dev)
    batch['lidar2img'] = torch.from_numpy(np.ascontiguousarray(l2i)).to(dev)
    return batch
