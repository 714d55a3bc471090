"""Detector engines: train step and predict.

Port of ``mmdet3d_gaussian_tpu/engine/detector.py``: the KITTI 3-class
configuration and :class:`PointPillarsDetector`, the point-sharded
:class:`ShardedPointPillarsDetector`, the nuScenes CenterPoint
configuration and :class:`CenterPointDetector` (construction,
``apply_train``, ``loss``, ``apply_eval``, ``predict``, and the
``train_step`` entry around ``parallel/train_state.py``),
:func:`synthetic_batch` and :func:`synthetic_nus_batch`.  A detector owns
its weights (an ``nn.Module`` trunk on one device); load JAX weights with
``det.trunk.load_state_dict(jax_variables_to_torch(variables,
upsample_strides=...))``.

Batch dict: points (B, N, C) f32, points_mask (B, N) bool, gt_bboxes
(B, G, 7+) f32, gt_labels (B, G) int, gt_valid (B, G) bool (the gt entries
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
from ..models.dense_heads.anchor3d_head import (PRIOR_PROB,
                                                Anchor3DHeadConvs,
                                                GDAnchor3DHead)
from ..models.dense_heads.centerpoint_head import CenterHead, SeparateHead
from ..models.detectors.voxelnet import PointPillarsNet
from ..models.middle_encoders import SparseConvBlock
from ..models.voxel_encoders import MaskedBatchNorm
from ..parallel.train_state import (AdamW, TrainState, init_state,
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
    """Seeded initialization, the same on every device: lecun-normal conv,
    linear and sparse conv weights (flax's default; a sparse conv's
    ``(K, Cin, Cout)`` weight has fan-in K Cin), BN identity with zero
    running mean and unit variance, zero biases except an anchor head's cls
    bias at the focal prior and the center head's heatmap biases at its
    ``init_bias``.  Drawn on the CPU from one ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in trunk.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear,
                              SparseConvBlock)):
                w = m.weight
                # ConvTranspose2d weights are (in, out, k, k)
                fan_in = (w.shape[0] * w[0, 0].numel()
                          if isinstance(m, nn.ConvTranspose2d)
                          else w[:, :, 0].numel()
                          if isinstance(m, SparseConvBlock)
                          else w[0].numel())
                w.copy_(torch.randn(w.shape, generator=gen)
                        / math.sqrt(fan_in))
                if getattr(m, 'bias', None) is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, MaskedBatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        for m in trunk.modules():
            if isinstance(m, Anchor3DHeadConvs):
                m.conv_cls.bias.fill_(
                    -math.log((1 - PRIOR_PROB) / PRIOR_PROB))
            elif isinstance(m, SeparateHead):
                m.heatmap[-1].bias.fill_(m.init_bias)


class _Detector:
    """What both detectors share: the trunk's forward in training and in
    eval mode, and the train step around ``parallel/train_state.py``.

    ``group`` (a ``parallel.mesh.Group``, from the constructor or
    :meth:`init_train`; None: one process) makes the train step data
    parallel: each rank's batch is its rows of the global batch, every
    BatchNorm of the trunk takes the whole batch's statistics, the loss
    normalizers are global, the voxel and site capacities are the global
    batch's (truncated over the ranks in key order, batch first) and the
    gradients are summed over the ranks, so a step on R ranks is the
    one-process step on all their rows, as the JAX package's step sharded
    over ``Mesh(('data',))`` is its unsharded program.  ``predict`` runs
    on each rank's own rows."""

    group = None

    def set_group(self, group) -> None:
        """Train over ``group``'s ranks (see the class docstring): hand the
        group to the trunk's BatchNorms and capacities
        (``mesh.sync_batchnorms``) and broadcast rank 0's weights."""
        from ..parallel.mesh import replicate, sync_batchnorms
        self.group = group
        sync_batchnorms(self.trunk, group)
        if group is not None:
            replicate(self.trunk, group)

    def _inputs(self, batch: Dict[str, torch.Tensor]):
        """The trunk's arguments from a batch, on the detector's device."""
        return [batch[k].to(self.device) for k in ('points', 'points_mask')]

    def apply_train(self, batch: Dict[str, torch.Tensor]):
        """-> the trunk's NHWC head outputs, differentiable in its
        parameters.  The trunk runs in training mode: its BatchNorms use
        batch statistics and update their running statistics in place (the
        JAX package returns them as new ``batch_stats``)."""
        self.trunk.train()
        return self.trunk(*self._inputs(batch))

    def init_train(self, base_lr: float = 1e-3, total_steps: int = 1000,
                   optimizer: Optional[AdamW] = None, group=None,
                   **optimizer_kw) -> TrainState:
        """Build the train step for :meth:`train_step` around
        ``optimizer`` (e.g. ``make_optimizer_from_cfg``) or else
        ``make_optimizer(base_lr, total_steps, **optimizer_kw)``, data
        parallel over ``group`` (:meth:`set_group`) or the constructor's;
        returns the initial :class:`TrainState`."""
        if group is not None:
            self.set_group(group)
        self.optimizer = optimizer or make_optimizer(base_lr, total_steps,
                                                     **optimizer_kw)
        self._step_fn = make_train_step(self.apply_train, self.loss,
                                        self.optimizer, self.group)
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
        """-> the trunk's NHWC head outputs in eval mode."""
        self.trunk.eval()
        return self.trunk(*self._inputs(batch))


class PointPillarsDetector(_Detector):
    """PointPillars + GD anchor head (reference
    ``hv_pointpillars_secfpn_kld5tau1_12x4_160e_kitti-3d-3class``).  With
    no ``model_cfg`` it runs that config's own ``voxelize_mode='hard'``
    (the packed pillar encoder, ``hard_encoder='packed'``; ``'sorted'`` is
    the same function through K1) on the plain canvas; ``'dynamic'`` takes
    the space-to-depth canvas (``s2d_canvas='auto'``) or the plain one
    (``'off'``).  Each runs in f32 or with ``compute_dtype='bfloat16'``.  In
    bf16 the parameters, their gradients and AdamW's moments stay f32, and
    there is no loss scaling, as in the JAX package's train step.
    ``apply_train`` and ``apply_eval`` return NHWC (cls_score, bbox_pred,
    dir_pred, packed).  Every trunk (hard, dynamic, MVF) trains data
    parallel over a ``group``."""

    def __init__(self, model_cfg: Optional[Dict[str, Any]] = None,
                 head_cfg: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, group=None):
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
        if group is not None:
            self.set_group(group)

    def loss(self, outputs, batch: Dict[str, torch.Tensor]):
        """Head outputs -> (total loss, {loss_cls, loss_bbox, loss_dir});
        targets for the whole batch at once (under a group, this rank's
        share of the global batch's loss)."""
        cls, bbox, dirp, packed = outputs
        targets = self.head.get_targets(
            self.anchors, batch['gt_bboxes'].to(self.device),
            batch['gt_labels'].to(self.device),
            batch['gt_valid'].to(self.device))
        losses = self.head.loss(cls, bbox, dirp, self.anchors, targets,
                                packed=packed, group=self.group)
        return sum(losses.values()), losses

    def serve(self, batch: Dict[str, torch.Tensor], anchors=None):
        """:meth:`predict`'s body with the trunk in whatever mode it is and
        autograd as the caller has it, on ``anchors`` (default the
        detector's): what ``engine/export.py`` exports."""
        cls, bbox, dirp = self.trunk(*self._inputs(batch))[:3]
        return self.head.get_bboxes(cls, bbox, dirp,
                                    self.anchors if anchors is None
                                    else anchors)

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]):
        """-> (boxes (B, max_num, 7), scores (B, max_num), labels
        (B, max_num) int32, valid (B, max_num) bool)."""
        self.trunk.eval()
        return self.serve(batch)


class ShardedPointPillarsDetector(PointPillarsDetector):
    """PointPillars with the point axis sharded over the ranks of a points
    group (port of the JAX package's ``ShardedPointPillarsDetector``): the
    trunk is :class:`~..parallel.sharded_model.ShardedPointPillarsNet`
    (the dense-canvas pillar encoder, SECOND, SECONDFPN, the anchor head's
    convolutions, f32) with the GD anchor head of ``KITTI_3CLASS_HEAD``.

    ``mesh`` (``parallel.mesh.init_mesh``; None: one process on the whole
    batch) with ``point_axis='points'``: each rank's batch is
    ``mesh.shard_points`` of the global batch.  The encoder's pillars
    merge over the points group (``merge='dense'``: one all-reduce of the
    canvas; ``'sparse'``: the stripe exchange, ``bucket_capacity`` rows a
    rank and stripe, which drops live cells past it with no signal, as
    JAX), its ``MaskedBatchNorm`` statistics are the world's, the trunk's
    SyncBN (K4's moments) and the head's ``num_pos`` normalizer are the
    data group's.  The train step sums the encoder's gradients over the
    world and the trunk's over the data group (``make_train_step``'s
    ``replicas``), so a step on the grid is the one-process step on the
    whole batch, as JAX's sharded step is its ``point_axis=None``
    program; the metrics are the data group's sums.  ``predict`` returns
    the data rank's samples, the same on every rank of its points group.
    ``point_axis=None`` ignores ``mesh``: one process."""

    def __init__(self, model_cfg: Optional[Dict[str, Any]] = None,
                 head_cfg: Optional[Dict[str, Any]] = None,
                 point_axis: Optional[str] = 'points',
                 merge: str = 'dense', mesh=None,
                 bucket_capacity: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        from ..parallel.sharded_model import ShardedPointPillarsNet
        self.device = resolve_device(device)
        mc = copy.deepcopy(KITTI_3CLASS_MODEL)
        mc.update(model_cfg or {})
        hc = copy.deepcopy(KITTI_3CLASS_HEAD)
        hc.update(head_cfg or {})
        for k in ('max_points_per_voxel', 'max_voxels_per_sample',
                  'voxelize_mode', 'head_type'):
            mc.pop(k, None)
        if merge == 'sparse' and mesh is None:
            raise ValueError("merge='sparse' needs a mesh (the stripe "
                             "exchange runs over its points group)")
        self.model_cfg = mc
        self.trunk = ShardedPointPillarsNet(merge=merge,
                                            bucket_capacity=bucket_capacity,
                                            **mc)
        init_weights(self.trunk, seed)
        self.trunk.to(self.device).eval()
        self.head = GDAnchor3DHead(**hc)
        nx, ny = self.trunk.grid()
        stride = mc['backbone_cfg']['layer_strides'][0]
        self.featmap_size = (ny // stride, nx // stride)
        self.anchors = torch.from_numpy(
            self.head.anchors_for(self.featmap_size)).to(self.device)
        self.mesh = mesh if point_axis else None
        self.trunk.set_mesh(self.mesh)
        if self.mesh is not None:
            from ..parallel.mesh import replicate
            self.group = self.mesh.data
            replicate(self.trunk, self.mesh.world)

    def set_group(self, group) -> None:
        raise ValueError('a point-sharded detector takes its groups from '
                         'its mesh')

    def init_train(self, base_lr: float = 1e-3, total_steps: int = 1000,
                   optimizer: Optional[AdamW] = None, **optimizer_kw
                   ) -> TrainState:
        """As :meth:`PointPillarsDetector.init_train`; under the mesh the
        gradients of the trunk after the merge (replicas over the points
        group) are summed over the data group and the encoder's over the
        world."""
        self.optimizer = optimizer or make_optimizer(base_lr, total_steps,
                                                     **optimizer_kw)
        world = None if self.mesh is None else self.mesh.world
        self._step_fn = make_train_step(self.apply_train, self.loss,
                                        self.optimizer, world,
                                        self.replicas())
        return init_state(self.trunk, self.optimizer)

    def replicas(self):
        """``make_train_step``'s ``replicas`` under the mesh (None without
        it): the points group and the parameters after the merge."""
        if self.mesh is None:
            return None
        return (self.mesh.points, frozenset(
            k for k, _ in self.trunk.named_parameters()
            if not k.startswith('voxel_encoder.')))


# the CenterPoint pillar model (reference configs/_base_/models/
# centerpoint_02pillar_second_secfpn_nus.py) and its head
NUS_CENTERPOINT_MODEL = dict(
    voxel_size=(0.2, 0.2, 8.0),
    point_cloud_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
    max_points_per_voxel=20,
    max_voxels_per_sample=30000,
    voxelize_mode='dynamic',
    head_type='center',
    encoder_cfg=dict(in_channels=5, feat_channels=(64,)),
    backbone_cfg=dict(in_channels=64, out_channels=(64, 128, 256),
                      layer_nums=(3, 5, 5), layer_strides=(2, 2, 2)),
    neck_cfg=dict(in_channels=(64, 128, 256), out_channels=(128, 128, 128),
                  upsample_strides=(0.5, 1, 2)),
)

NUS_CENTERPOINT_HEAD = dict(
    tasks=[
        dict(num_classes=1), dict(num_classes=2), dict(num_classes=2),
        dict(num_classes=1), dict(num_classes=2), dict(num_classes=2),
    ],
    out_size_factor=4,
    with_vel=True,
    code_weights=[1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2],
    loss_cls=dict(type='GaussianFocalLoss', loss_weight=1.0),
    loss_bbox=dict(type='L1Loss', loss_weight=0.25),
    max_objs=100,
    gaussian_overlap=0.1, min_radius=2.0,
    test_cfg=dict(post_center_limit_range=[-61.2, -61.2, -10.0, 61.2, 61.2,
                                           10.0],
                  max_per_img=128, score_threshold=0.1, nms_type='rotate',
                  nms_thr=0.2, post_max_size=83),
)


class CenterPointDetector(_Detector):
    """CenterPoint (pillars): dynamic pillars on the space-to-depth canvas
    (K1, K7) -> SECOND -> SECONDFPN concatenated -> the multi-task center
    head.  ``yaw_mode=True`` with ``loss_gd`` is the CenterGDHead variant.
    ``apply_train`` and ``apply_eval`` return a list of per-task dicts of
    NHWC maps; ``compute_dtype='bfloat16'`` as on
    :class:`PointPillarsDetector`."""

    def __init__(self, model_cfg: Optional[Dict[str, Any]] = None,
                 head_cfg: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, group=None):
        self.device = resolve_device(device)
        mc = copy.deepcopy(NUS_CENTERPOINT_MODEL)
        mc.update(model_cfg or {})
        hc = copy.deepcopy(NUS_CENTERPOINT_HEAD)
        hc.update(head_cfg or {})
        hc.setdefault('pc_range', mc['point_cloud_range'])
        hc.setdefault('voxel_size', mc['voxel_size'])
        self.head = CenterHead(**hc)
        mc.setdefault('head_cfg', dict(
            tasks=[dict(num_classes=t['num_classes'])
                   for t in self.head.tasks],
            in_channels=sum(mc['neck_cfg']['out_channels']),
            common_heads=self.head.common_heads))
        self.model_cfg = mc
        self.trunk = PointPillarsNet(**mc)
        init_weights(self.trunk, seed)
        self.trunk.to(self.device).eval()
        nx, ny = self.trunk.grid()
        f = self.head.out_size_factor
        self.featmap_size = (ny // f, nx // f)
        if group is not None:
            self.set_group(group)

    def loss(self, preds, batch: Dict[str, torch.Tensor]):
        """Per-task maps -> (total loss, {task{t}.loss_*}); targets for
        the whole batch at once (under a group, this rank's share of the
        global batch's loss)."""
        targets = self.head.get_targets(
            batch['gt_bboxes'].to(self.device),
            batch['gt_labels'].to(self.device),
            batch['gt_valid'].to(self.device), self.featmap_size)
        losses = self.head.loss(preds, targets, group=self.group)
        return sum(losses.values()), losses

    def serve(self, batch: Dict[str, torch.Tensor], anchors=None):
        """:meth:`predict`'s body (the center head has no anchors)."""
        return self.head.get_bboxes(self.trunk(*self._inputs(batch)))

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]):
        """-> (boxes (B, M, 7+), scores (B, M), labels (B, M) int32, valid
        (B, M) bool), M = min(post_max_size, tasks x max_per_img)."""
        self.trunk.eval()
        return self.serve(batch)


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


# nuScenes class sizes (dx, dy, dz) and speeds (m/s) for synthetic_nus_batch,
# in the dataset config's class order
NUS_SIZES = ((4.6, 1.95, 1.73), (6.9, 2.5, 2.8), (12.3, 2.9, 3.9),
             (11.0, 2.9, 3.5), (6.4, 2.7, 3.2), (1.7, 0.6, 1.3),
             (2.1, 0.8, 1.5), (0.7, 0.7, 1.8), (0.4, 0.4, 1.1),
             (0.5, 2.5, 1.0))
NUS_SPEEDS = (10.0, 8.0, 5.0, 8.0, 2.0, 4.0, 8.0, 1.5, 0.0, 0.0)


def synthetic_nus_batch(batch_size: int = 4, num_points: int = 60000,
                        num_gt: int = 128, seed: int = 0,
                        num_objects=(30, 40), sweeps: int = 10,
                        pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                        device: Optional[Union[str, torch.device]] = None):
    """A nuScenes-like batch from a seed (numpy): ``num_points`` points of
    five channels (x, y, z, intensity in [0, 255], the sweep's time lag in
    {0, 0.05, ...}) a sample, whose density falls with range as a LiDAR
    sweep's (log-uniform range from the sensor, so ~1/r^2 a square metre)
    over a ground plane at -1.8 m with a tenth of the points on the
    objects; ``num_objects`` (lo, hi) GT boxes a sample over the 10 classes
    with their sizes and a velocity each, padded to ``num_gt`` rows of
    (x, y, z, dx, dy, dz, yaw, vx, vy)."""
    dev = resolve_device(device)
    if num_objects[1] > num_gt:
        raise ValueError(f'up to {num_objects[1]} objects do not fit '
                         f'num_gt={num_gt} rows')
    rng = np.random.RandomState(seed)
    lo, hi = np.asarray(pc_range[:3]), np.asarray(pc_range[3:])
    span = float(min(hi[:2] - lo[:2])) / 2
    points = np.zeros((batch_size, num_points, 5), np.float32)
    gt = np.zeros((batch_size, num_gt, 9), np.float32)
    labels = np.zeros((batch_size, num_gt), np.int32)
    valid = np.zeros((batch_size, num_gt), bool)
    sizes = np.asarray(NUS_SIZES)
    for b in range(batch_size):
        g = rng.randint(num_objects[0], num_objects[1] + 1)
        cls = rng.randint(0, len(NUS_SIZES), g)
        r = np.exp(rng.uniform(np.log(3.0), np.log(span - 2), g))
        phi = rng.uniform(-np.pi, np.pi, g)
        dims = sizes[cls] * rng.uniform(0.9, 1.1, (g, 3))
        yaw = rng.uniform(-np.pi, np.pi, g)
        speed = np.asarray(NUS_SPEEDS)[cls] * rng.uniform(0, 1, g)
        gt[b, :g] = np.c_[r * np.cos(phi), r * np.sin(phi),
                          np.full(g, -1.8), dims, yaw,
                          speed * np.cos(yaw), speed * np.sin(yaw)]
        labels[b, :g] = cls
        valid[b, :g] = True
        # a tenth of the points inside the boxes, the rest on the ground
        n_obj = num_points // 10
        owner = rng.randint(0, g, n_obj)
        local = rng.uniform(-0.5, 0.5, (n_obj, 3)) * gt[b, owner, 3:6]
        c, s = np.cos(gt[b, owner, 6]), np.sin(gt[b, owner, 6])
        obj = np.c_[gt[b, owner, 0] + c * local[:, 0] - s * local[:, 1],
                    gt[b, owner, 1] + s * local[:, 0] + c * local[:, 1],
                    gt[b, owner, 2] + gt[b, owner, 5] / 2 + local[:, 2]]
        n_gnd = num_points - n_obj
        rr = np.exp(rng.uniform(np.log(1.0), np.log(span * 1.3), n_gnd))
        pp = rng.uniform(-np.pi, np.pi, n_gnd)
        gnd = np.c_[rr * np.cos(pp), rr * np.sin(pp),
                    rng.normal(-1.8, 0.05, n_gnd)]
        xyz = np.concatenate([obj, gnd])
        points[b, :, :3] = xyz
        points[b, :, 3] = rng.uniform(0, 255, num_points)
        points[b, :, 4] = rng.randint(0, sweeps, num_points) * 0.05
    mask = np.ones((batch_size, num_points), bool)
    arrays = dict(points=points, points_mask=mask, gt_bboxes=gt,
                  gt_labels=labels, gt_valid=valid)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
