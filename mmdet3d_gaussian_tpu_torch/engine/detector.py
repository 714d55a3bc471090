"""PointPillars detector engine: train step and predict.

Port of ``mmdet3d_gaussian_tpu/engine/detector.py``: the KITTI 3-class
configuration, :class:`PointPillarsDetector` (construction, ``apply_train``,
``loss``, ``apply_eval``, ``predict``, and the ``train_step`` entry around
``parallel/train_state.py``) and :func:`synthetic_batch`.  The detector
owns its weights (an ``nn.Module`` trunk on one device); load JAX weights
with ``det.trunk.load_state_dict(jax_variables_to_torch(variables))``.

Batch dict: points (B, N, C) f32, points_mask (B, N) bool, gt_bboxes
(B, G, 7) f32, gt_labels (B, G) int, gt_valid (B, G) bool (the gt entries
are read by the loss only).
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.dense_heads.anchor3d_head import PRIOR_PROB, GDAnchor3DHead
from ..models.detectors.voxelnet import PointPillarsNet
from ..models.voxel_encoders import MaskedBatchNorm
from ..parallel.train_state import (TrainState, init_state,
                                    make_optimizer, make_train_step)


KITTI_3CLASS_MODEL = dict(
    voxel_size=(0.16, 0.16, 4.0),
    point_cloud_range=(0., -39.68, -3., 69.12, 39.68, 1.),
    max_points_per_voxel=32,
    max_voxels_per_sample=16000,
    voxelize_mode='hard',
    encoder_cfg=dict(in_channels=4, feat_channels=(64,)),
    backbone_cfg=dict(in_channels=64, out_channels=(64, 128, 256),
                      layer_nums=(3, 5, 5), layer_strides=(2, 2, 2)),
    neck_cfg=dict(in_channels=(64, 128, 256), out_channels=(128, 128, 128),
                  upsample_strides=(1, 2, 4)),
    head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=384),
)

KITTI_3CLASS_HEAD = dict(
    num_classes=3,
    anchor_generator=dict(
        ranges=[
            [0.08, -39.60, -0.6, 68.88, 39.44, -0.6],
            [0.08, -39.60, -0.6, 68.88, 39.44, -0.6],
            [0.08, -39.60, -1.78, 68.88, 39.44, -1.78],
        ],
        sizes=[[0.8, 0.6, 1.73], [1.76, 0.6, 1.73], [3.9, 1.6, 1.56]],
        rotations=[0.0, 1.57],
    ),
    assigners=[
        dict(pos_iou_thr=0.5, neg_iou_thr=0.35, min_pos_iou=0.35),
        dict(pos_iou_thr=0.5, neg_iou_thr=0.35, min_pos_iou=0.35),
        dict(pos_iou_thr=0.6, neg_iou_thr=0.45, min_pos_iou=0.45),
    ],
    loss_cls=dict(type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
                  loss_weight=1.0),
    loss_bbox=dict(type='SmoothL1Loss', beta=1.0 / 9.0, loss_weight=2.0),
    loss_decoded_bbox=dict(type='GDLoss', loss_type='kld3d',
                           center_offset=(0, 0, 0.5), fun='log1p', tau=1.0,
                           alpha=1.0, loss_weight=5.0),
    loss_dir=dict(type='CrossEntropyLoss', use_sigmoid=False,
                  loss_weight=0.2),
    code_weight=[0., 0., 0., 0., 0., 0., 0.],
    decode_weight=1.0,
    test_cfg=dict(use_rotate_nms=True, nms_thr=0.01, score_thr=0.05,
                  nms_pre=1024, max_num=100),
)


def init_weights(trunk: nn.Module, seed: int) -> None:
    """Seeded initialization, the same on every device: lecun-normal conv
    and linear weights (flax's default), BN identity with zero running
    mean and unit variance, zero biases except the cls bias at the focal
    prior.  Drawn on the CPU from one ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in trunk.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                # ConvTranspose2d weights are (in, out, k, k)
                fan_in = (w.shape[0] * w[0, 0].numel()
                          if isinstance(m, nn.ConvTranspose2d)
                          else w[0].numel())
                w.copy_(torch.randn(w.shape, generator=gen)
                        / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, MaskedBatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        trunk.bbox_head.conv_cls.bias.fill_(
            -math.log((1 - PRIOR_PROB) / PRIOR_PROB))


class PointPillarsDetector:
    """PointPillars + GD anchor head (reference
    ``hv_pointpillars_secfpn_kld5tau1_12x4_160e_kitti-3d-3class``).  With
    no ``model_cfg`` it runs that config's own ``voxelize_mode='hard'``
    (the packed pillar encoder, ``hard_encoder='packed'``; ``'sorted'`` is
    the same function through K1) on the plain canvas; ``'dynamic'`` takes
    the space-to-depth canvas (``s2d_canvas='auto'``) or the plain one
    (``'off'``).  Each runs in f32 or with ``compute_dtype='bfloat16'``.  In
    bf16 the parameters, their gradients and AdamW's moments stay f32, and
    there is no loss scaling, as in the JAX package's train step."""

    def __init__(self, model_cfg: Optional[Dict[str, Any]] = None,
                 head_cfg: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        mc = copy.deepcopy(KITTI_3CLASS_MODEL)
        mc.update(model_cfg or {})
        hc = copy.deepcopy(KITTI_3CLASS_HEAD)
        hc.update(head_cfg or {})
        self.model_cfg = mc
        self.trunk = PointPillarsNet(**mc)
        init_weights(self.trunk, seed)
        self.trunk.to(self.device).eval()
        self.head = GDAnchor3DHead(**hc)
        nx, ny = self.trunk.grid()
        stride = mc['backbone_cfg']['layer_strides'][0]
        self.featmap_size = (ny // stride, nx // stride)
        self.anchors = torch.from_numpy(
            self.head.anchors_for(self.featmap_size)).to(self.device)

    def apply_train(self, batch: Dict[str, torch.Tensor]):
        """-> NHWC (cls_score, bbox_pred, dir_pred, packed), differentiable
        in the trunk's parameters.  The trunk runs in training mode: its
        BatchNorms use batch statistics and update their running statistics
        in place (the JAX package returns them as new ``batch_stats``)."""
        self.trunk.train()
        return self.trunk(batch['points'].to(self.device),
                          batch['points_mask'].to(self.device))

    def loss(self, outputs, batch: Dict[str, torch.Tensor]):
        """Head outputs -> (total loss, {loss_cls, loss_bbox, loss_dir});
        targets for the whole batch at once."""
        cls, bbox, dirp, packed = outputs
        targets = self.head.get_targets(
            self.anchors, batch['gt_bboxes'].to(self.device),
            batch['gt_labels'].to(self.device),
            batch['gt_valid'].to(self.device))
        losses = self.head.loss(cls, bbox, dirp, self.anchors, targets,
                                packed=packed)
        return sum(losses.values()), losses

    def init_train(self, base_lr: float = 1e-3, total_steps: int = 1000,
                   **optimizer_kw) -> TrainState:
        """Build the optimizer (``make_optimizer``) and the train step for
        :meth:`train_step`; returns the initial :class:`TrainState`."""
        self.optimizer = make_optimizer(base_lr, total_steps, **optimizer_kw)
        self._step_fn = make_train_step(self.apply_train, self.loss,
                                        self.optimizer)
        return init_state(self.trunk, self.optimizer)

    def train_step(self, batch: Dict[str, torch.Tensor],
                   state: Optional[TrainState] = None):
        """One step: forward in training mode, loss, backward, AdamW
        update of the trunk's parameters in place.  Without ``state`` the
        optimizer and state are built first (:meth:`init_train` defaults).
        -> (new state, metrics: each loss term, ``loss``, ``grad_norm``)."""
        if state is None:
            state = self.init_train()
        return self._step_fn(state, batch)

    @torch.inference_mode()
    def apply_eval(self, batch: Dict[str, torch.Tensor]):
        """-> NHWC (cls_score, bbox_pred, dir_pred, packed)."""
        self.trunk.eval()
        return self.trunk(batch['points'].to(self.device),
                          batch['points_mask'].to(self.device))

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]):
        """-> (boxes (B, max_num, 7), scores (B, max_num), labels
        (B, max_num) int32, valid (B, max_num) bool)."""
        cls, bbox, dirp = self.apply_eval(batch)[:3]
        return self.head.get_bboxes(cls, bbox, dirp, self.anchors)


def synthetic_batch(batch_size: int = 2, num_points: int = 8192,
                    num_gt: int = 16, seed: int = 0,
                    pc_range=(0., -39.68, -3., 69.12, 39.68, 1.),
                    num_feats: int = 4,
                    device: Optional[Union[str, torch.device]] = None):
    """KITTI-like random batch, the same numpy stream as the JAX package's
    ``synthetic_batch`` (equal arrays for equal arguments)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    lo = np.asarray(pc_range[:3])
    hi = np.asarray(pc_range[3:])
    pts = rng.uniform(lo, hi, (batch_size, num_points, 3)).astype(np.float32)
    inten = rng.rand(batch_size, num_points,
                     max(1, num_feats - 3)).astype(np.float32)
    points = np.concatenate([pts, inten], -1)
    mask = np.ones((batch_size, num_points), bool)

    ctr = rng.uniform(lo + 2, hi - 2, (batch_size, num_gt, 3))
    dims = rng.uniform([1.6, 0.6, 1.4], [4.5, 1.9, 1.8],
                       (batch_size, num_gt, 3))
    yaw = rng.uniform(-np.pi, np.pi, (batch_size, num_gt, 1))
    gt = np.concatenate([ctr, dims, yaw], -1).astype(np.float32)
    labels = rng.randint(0, 3, (batch_size, num_gt)).astype(np.int32)
    valid = np.ones((batch_size, num_gt), bool)
    arrays = dict(points=points, points_mask=mask, gt_bboxes=gt,
                  gt_labels=labels, gt_valid=valid)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def crowded_batch(batch_size: int = 2, num_points: int = 2048,
                  num_gt: int = 8, seed: int = 0,
                  pc_range=(0., -39.68, -3., 69.12, 39.68, 1.),
                  voxel_size=(0.16, 0.16, 4.0), pillars: int = 12,
                  per_pillar: int = 40, copies: int = 8,
                  device: Optional[Union[str, torch.device]] = None):
    """:func:`synthetic_batch` with the first ``pillars * per_pillar``
    points of each sample piled into ``pillars`` random pillars,
    ``per_pillar`` points each, inside the cell away from its edges; the
    first ``copies`` points of a pile are one point repeated.  Piles over
    ``max_points_per_voxel`` exercise hard voxelize's truncation, the
    copies ties in the pillar max.  The same arrays for equal arguments."""
    dev = resolve_device(device)
    batch = synthetic_batch(batch_size, num_points, num_gt, seed, pc_range,
                            device='cpu')
    pts = batch['points'].numpy().copy()
    rng = np.random.RandomState(seed + 1)
    lo = np.asarray(pc_range[:2], np.float64)
    vs = np.asarray(voxel_size[:2], np.float64)
    grid = np.round((np.asarray(pc_range[3:5]) - lo) / vs).astype(int)
    for s in range(batch_size):
        cells = rng.randint(0, grid, (pillars, 2))
        for j, cell in enumerate(cells):
            pile = slice(j * per_pillar, (j + 1) * per_pillar)
            frac = rng.uniform(0.05, 0.95, (per_pillar, 2))
            pts[s, pile, :2] = lo + (cell + frac) * vs
            pts[s, pile][:copies] = pts[s, j * per_pillar]
    batch['points'] = torch.from_numpy(pts)
    return {k: v.to(dev) for k, v in batch.items()}
