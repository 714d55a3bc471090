"""PV-RCNN, the two-stage detector.

Port of ``mmdet3d_gaussian_tpu/engine/pvrcnn.py``: hard voxelize with
HardSimpleVFE's per-voxel mean (kernel K1) -> :class:`MlvlSparseEncoder`
-> the dense BEV -> SECOND / SECONDFPN (K4 in training) -> the RPN anchor
head and class-agnostic proposals (K5, K6) -> FPS keypoints and
:class:`VoxelSetAbstraction` -> the keypoint mask head, RoI-grid pooling
and :class:`PVRCNNBboxHead` -> in training RoI assignment and sampling,
targets and the four loss groups; in predict the refined boxes with
their rotated NMS (K5, K6).

Data parallel (a ``group``, ``parallel/mesh.py``): the train step on R
ranks is the one-process step on all their rows, as the JAX package's step
sharded over ``Mesh(('data',))`` is its unsharded program.  The voxelize
and every strided sparse level keep the global batch's capacity
(``max_voxels`` x the global B, truncated over the ranks in key order,
batch first), every BatchNorm takes the whole batch's statistics, and the
RPN's ``num_pos``, the semantic loss's positives and the RoI losses' two
weight sums are global.  The rest works per sample and needs no
collective: FPS, the ball queries and grouping, the BEV sample, RoI
assignment and sampling, the RoI-grid pooling and the targets.

The trunk is one ``nn.Module`` (:class:`PVRCNNNet`) with ``first`` and
``second`` children, the JAX package's two flax modules, so the train
state, checkpoints and the loop work as for the other detectors.  f32
only; the second stage's losses reach the sparse encoder through the
levels and the BEV (only the RPN outputs that make proposals are
detached).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from ..core.bbox.coders import DeltaXYZWLHRBBoxCoder
from ..device import resolve_device
from ..models.backbones import SECOND, SECONDFPN
from ..models.dense_heads.anchor3d_head import (Anchor3DHeadConvs,
                                                GDAnchor3DHead)
from ..models.middle_encoders import MlvlSparseEncoder, VoxelSetAbstraction
from ..models.roi_heads import (Batch3DRoIGridExtractor, PointwiseMaskHead,
                                PVRCNNBboxHead, RoISamples,
                                assign_and_sample, corner_loss_lidar,
                                decode_roi_boxes, roi_canonical_targets)
from ..ops.nms import nms_bev, top_k
from ..ops.rotated_iou import iou_3d
from ..ops.scatter import batch_coords, build_scatter, compute_voxel_coords
from ..parallel.mesh import all_reduce_sum, world_of
from ..registry import LOSSES
from .detector import _Detector, init_weights


KITTI_PVRCNN = dict(
    voxel_size=(0.05, 0.05, 0.1),
    point_cloud_range=(0., -40., -3., 70.4, 40., 1.),
    max_voxels=16000,
    sparse_shape=(41, 1600, 1408),        # (Z, Y, X)
    base_channels=16,
    encoder_channels=((16,), (32, 32, 32), (64, 64, 64), (64, 64, 64)),
    encoder_out_channels=128,
    backbone=dict(in_channels=256, out_channels=(128, 256),
                  layer_nums=(5, 5), layer_strides=(1, 2)),
    neck=dict(in_channels=(128, 256), out_channels=(256, 256),
              upsample_strides=(1, 2)),
    num_keypoints=2048,
    vsa_out_channels=128,
    voxel_sa_configs=[
        dict(scale_factor=1, in_channels=16, pool_radius=(0.4, 0.8),
             samples=(16, 16), mlps=((16, 16), (16, 16))),
        dict(scale_factor=2, in_channels=32, pool_radius=(0.8, 1.2),
             samples=(16, 32), mlps=((32, 32), (32, 32))),
        dict(scale_factor=4, in_channels=64, pool_radius=(1.2, 2.4),
             samples=(16, 32), mlps=((64, 64), (64, 64))),
        dict(scale_factor=8, in_channels=64, pool_radius=(2.4, 4.8),
             samples=(16, 32), mlps=((64, 64), (64, 64))),
    ],
    rawpoint_sa_config=dict(in_channels=1, pool_radius=(0.4, 0.8),
                            samples=(16, 16), mlps=((16, 16), (16, 16))),
    bev_sa=True,
    num_proposals=128,
    grid_size=6,
    roi_pool_radius=(0.8, 1.6),
    roi_samples_per_radius=(16, 16),
    roi_mlps=((64, 64), (64, 64)),
)

KITTI_PVRCNN_RPN_HEAD = dict(
    num_classes=3,
    anchor_generator=dict(
        ranges=[[0.2, -39.8, -0.6, 70.2, 39.8, -0.6],
                [0.2, -39.8, -0.6, 70.2, 39.8, -0.6],
                [0.2, -39.8, -1.78, 70.2, 39.8, -1.78]],
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
    loss_dir=dict(type='CrossEntropyLoss', use_sigmoid=False,
                  loss_weight=0.2),
    test_cfg=dict(use_rotate_nms=True, nms_thr=0.8, score_thr=0.0,
                  nms_pre=512, max_num=128),
)


class PVRCNNFirstStage(nn.Module):
    """Sparse encoder -> BEV -> SECOND -> SECONDFPN -> RPN head convs."""

    def __init__(self, cfg: Dict[str, Any], point_channels: int):
        super().__init__()
        c = cfg
        self.middle_encoder = MlvlSparseEncoder(
            in_channels=point_channels, sparse_shape=c['sparse_shape'],
            base_channels=c['base_channels'],
            encoder_channels=c['encoder_channels'],
            out_channels=c['encoder_out_channels'],
            max_voxels=c['max_voxels'])
        self.backbone = SECOND(**c['backbone'])
        self.neck = SECONDFPN(**c['neck'])
        self.rpn_head = Anchor3DHeadConvs(
            num_classes=c['rpn_num_classes'],
            num_anchors=c['rpn_num_anchors'],
            feat_channels=sum(c['neck']['out_channels']))

    def forward(self, voxel_feats, voxel_coords, batch_size: int):
        """-> (levels, bev (B, H, W, C), neck map, RPN (cls, bbox, dir,
        packed))."""
        levels, bev = self.middle_encoder(voxel_feats, voxel_coords,
                                          batch_size)
        # cuDNN's heuristics pick an FFT-tiling algorithm for SECOND's f32
        # convs at this BEV (200 x 176, 128 and 256 channels): ~500 ms a
        # forward on an H100 against ~18 ms for the implicit GEMM that its
        # benchmark mode finds (TF32 and determinism left as they are)
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=True,
                         deterministic=cudnn.deterministic,
                         allow_tf32=cudnn.allow_tf32):
            feats = self.neck(self.backbone(bev))
        return levels, bev, feats, self.rpn_head(feats)


class PVRCNNSecondStage(nn.Module):
    """Voxel set abstraction -> mask head -> RoI-grid pooling of the
    segmentation-weighted keypoints -> box head."""

    def __init__(self, cfg: Dict[str, Any], point_channels: int,
                 bev_channels: int):
        super().__init__()
        c = cfg
        self.keypoints_encoder = VoxelSetAbstraction(
            num_keypoints=c['num_keypoints'],
            out_channels=c['vsa_out_channels'],
            voxel_size=c['voxel_size'],
            point_cloud_range=c['point_cloud_range'],
            voxel_sa_configs=c['voxel_sa_configs'],
            rawpoint_sa_config=c['rawpoint_sa_config'],
            bev_sa_config=(dict(scale_factor=8) if c['bev_sa'] else None),
            point_channels=point_channels, bev_channels=bev_channels)
        self.semantic_head = PointwiseMaskHead(
            in_channels=self.keypoints_encoder.gathered_channels)
        self.roi_extractor = Batch3DRoIGridExtractor(
            in_channels=c['vsa_out_channels'],
            pool_radius=c['roi_pool_radius'],
            samples=c['roi_samples_per_radius'], mlps=c['roi_mlps'],
            grid_size=c['grid_size'])
        self.bbox_head = PVRCNNBboxHead(
            in_channels=self.roi_extractor.out_channels)

    def forward(self, levels, bev, points, points_mask, proposals,
                proposals_valid, generator: Optional[torch.Generator] = None):
        """-> dict(keypoints, keypoint_indices, seg_logits, roi_cls,
        roi_reg); ``generator`` turns the box head's dropout on."""
        n_sa = len(self.keypoints_encoder.voxel_sa_configs)
        vsa = self.keypoints_encoder(levels[:n_sa], points, points_mask, bev)
        seg_logits = self.semantic_head(vsa['keypoint_features'])
        weighted = (vsa['fusion_keypoint_features']
                    * torch.sigmoid(seg_logits[..., 0:1]))
        grid = self.roi_extractor(weighted, vsa['keypoints'], proposals,
                                  proposals_valid)
        cls, reg = self.bbox_head(grid, proposals_valid, generator)
        return dict(keypoints=vsa['keypoints'],
                    keypoint_indices=vsa['keypoint_indices'],
                    seg_logits=seg_logits, roi_cls=cls, roi_reg=reg)


class PVRCNNNet(nn.Module):
    """The trunk: ``first`` and ``second`` stage (state_dict names
    ``first.*``, ``second.*``) on points of ``point_channels`` (x, y, z,
    intensity)."""

    def __init__(self, cfg: Dict[str, Any], point_channels: int = 4):
        super().__init__()
        self.first = PVRCNNFirstStage(cfg, point_channels)
        self.second = PVRCNNSecondStage(
            cfg, point_channels, self.first.middle_encoder.bev_channels)


def positive_batch(det: 'PVRCNNDetector', batch: Dict[str, torch.Tensor]):
    """A copy of ``batch`` whose first two gt boxes a sample come from
    ``det``'s two best train-mode proposals, with their labels: the best
    proposal itself (a positive of the RoI sampling) and the anchor of the
    second's class that overlaps it most (a positive of the RPN).  A
    random detector's proposals rarely meet random boxes, so its losses
    would leave the RoI regression and the corner loss at 0.  ``det``'s
    running statistics are left as they were."""
    batch = {k: v.clone() for k, v in batch.items()}
    saved = copy.deepcopy(det.trunk.state_dict())
    b = batch['points'].shape[0]
    with torch.no_grad():
        det.trunk.train()
        feats, coords = det.voxelize(batch)
        rpn = det.trunk.first(feats, coords, b)[3]
        boxes, labels, _, valid = det.proposals(rpn)
    det.trunk.load_state_dict(saved)
    if not bool(valid[:, :2].all()):
        raise ValueError('fewer than two proposals in a sample')
    dev = batch['gt_bboxes'].device
    batch['gt_bboxes'][:, 0] = boxes[:, 0].to(dev)
    batch['gt_labels'][:, :2] = labels[:, :2].to(dev)
    batch['gt_valid'][:, :2] = True
    for i in range(b):
        cand = det.anchors[:, :, int(labels[i, 1])].reshape(-1, 7)
        best = int(iou_3d(boxes[i, 1:2], cand)[0].argmax())
        batch['gt_bboxes'][i, 1] = cand[best].to(dev)
    return batch


class PVRCNNDetector(_Detector):
    """PV-RCNN (reference ``hv_pvrcnn_secfpn_4x4_80e_kitti-3d-3class``):
    ``model_cfg`` updates :data:`KITTI_PVRCNN`, ``rpn_head_cfg``
    :data:`KITTI_PVRCNN_RPN_HEAD`.  ``train_step`` and ``predict`` as the
    other detectors' (data parallel over a ``group``, module docstring);
    ``dropout_generator`` (a ``torch.Generator`` on the device) turns on
    the box head's dropout in training, off by default."""

    def __init__(self, model_cfg: Optional[Dict[str, Any]] = None,
                 rpn_head_cfg: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0,
                 dropout_generator: Optional[torch.Generator] = None,
                 group=None):
        self.device = resolve_device(device)
        c = copy.deepcopy(KITTI_PVRCNN)
        c.update(model_cfg or {})
        if c.get('compute_dtype') not in (None, 'float32'):
            raise ValueError('PV-RCNN runs in f32 only, got compute_dtype='
                             f'{c["compute_dtype"]!r}')
        # the JAX module's cross-replica BatchNorm: here the group's work
        # (set_group), with or without it, as PointPillarsNet takes it
        c.pop('axis_name', None)
        hc = copy.deepcopy(KITTI_PVRCNN_RPN_HEAD)
        hc.update(rpn_head_cfg or {})
        self.rpn_head = GDAnchor3DHead(**hc)
        c['rpn_num_classes'] = self.rpn_head.num_classes
        c['rpn_num_anchors'] = self.rpn_head.anchor_generator.num_base_anchors
        self.cfg = c
        self.trunk = PVRCNNNet(c)
        init_weights(self.trunk, seed)
        self.trunk.to(self.device).eval()
        self.dropout_generator = dropout_generator
        self.roi_coder = DeltaXYZWLHRBBoxCoder()
        self.loss_seg = LOSSES.build(dict(
            type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0))
        self.loss_roi_bbox = LOSSES.build(dict(
            type='SmoothL1Loss', beta=1.0 / 9.0, reduction='none',
            loss_weight=1.0))
        _, ny, nx = c['sparse_shape']
        self.featmap_size = (ny // 8, nx // 8)
        self.anchors = torch.from_numpy(
            self.rpn_head.anchors_for(self.featmap_size)).to(self.device)
        if group is not None:
            self.set_group(group)

    # ------------------------------------------------------------------
    def scatter(self, batch: Dict[str, torch.Tensor]):
        """Hard voxelize: the points' voxels, ``max_voxels`` x B of them
        kept in key order (batch first; in training under a group, B is
        the global batch and the truncation runs over the ranks) ->
        (Scatter, points (B N, C))."""
        c = self.cfg
        points = batch['points'].to(self.device)
        b, n, cdim = points.shape
        flat = points.reshape(b * n, cdim)
        bidx = torch.arange(b, dtype=torch.int32,
                            device=self.device).repeat_interleave(n)
        coords3, _ = compute_voxel_coords(flat[:, :3], c['point_cloud_range'],
                                          c['voxel_size'])
        mask = batch['points_mask'].to(self.device).reshape(-1, 1)
        coords3 = torch.where(mask, coords3, -1)
        nz, ny, nx = c['sparse_shape']
        group = self.group if self.trunk.training else None
        return build_scatter(batch_coords(coords3, bidx), (b, nx, ny, nz),
                             c['max_voxels'] * b * world_of(group),
                             group=group), flat

    def voxelize(self, batch: Dict[str, torch.Tensor]):
        """:meth:`scatter` and HardSimpleVFE's per-voxel mean through K1 ->
        (feats (V, C), coords (V, 4) (b, z, y, x), -1 rows)."""
        sc, flat = self.scatter(batch)
        feats = sc.sorted_view().reduce(flat[sc.sort_order], 'mean')
        vc = sc.voxel_coords
        coords = torch.stack([vc[:, 0], vc[:, 3], vc[:, 2], vc[:, 1]], -1)
        return feats, torch.where(vc[:, :1] >= 0, coords, -1)

    def proposals(self, rpn_outs):
        """RPN maps -> (boxes (B, R, 7), labels, scores, valid), R =
        ``num_proposals``, class-agnostic (``GDAnchor3DHead.
        get_proposals``)."""
        cls, bbox, dirp = rpn_outs[:3]
        boxes, scores, labels, valid = self.rpn_head.get_proposals(
            cls, bbox, dirp, self.anchors,
            max_num=self.cfg['num_proposals'])
        return boxes, labels, scores, valid

    def apply_train(self, batch: Dict[str, torch.Tensor]):
        """Both stages in training mode -> (rpn_outs, second-stage outputs
        with ``sparse_overflow``, the RoI samples).  Proposals come from
        the detached RPN outputs; the RoIs are assigned and sampled first,
        so the second stage runs on exactly the sampled RoIs."""
        self.trunk.train()
        b = batch['points'].shape[0]
        feats, coords = self.voxelize(batch)
        levels, bev, _, rpn_outs = self.trunk.first(feats, coords, b)
        gt = {k: batch[k].to(self.device)
              for k in ('gt_bboxes', 'gt_labels', 'gt_valid')}
        with torch.no_grad():
            boxes, labels, _, valid = self.proposals(
                tuple(t.detach() for t in rpn_outs[:3]))
            samples = assign_and_sample(
                boxes, labels, valid, gt['gt_bboxes'], gt['gt_labels'],
                gt['gt_valid'], num_samples=self.cfg['num_proposals'])
        out2 = self.trunk.second(
            levels, bev, batch['points'].to(self.device),
            batch['points_mask'].to(self.device), samples.rois,
            samples.valid, self.dropout_generator)
        out2['sparse_overflow'] = levels[-1].overflow
        return rpn_outs, out2, samples

    # ------------------------------------------------------------------
    def rcnn_losses(self, samples: RoISamples, roi_cls, roi_reg):
        """Second-stage losses of the drawn samples: soft-IoU BCE, SmoothL1
        on the RoI-frame deltas and the corner loss, weights normalized
        over the whole batch (under a group, over every rank's
        samples)."""
        label, label_w, bbox_tgt, reg_w = roi_canonical_targets(
            samples, self.roi_coder)
        one = label_w.new_ones(())
        label_sum, reg_sum = label_w.sum(), reg_w.sum()
        if self.group is not None:
            label_sum, reg_sum = all_reduce_sum([label_sum, reg_sum],
                                                self.group)
        label_w = label_w / torch.maximum(label_sum, one)
        p = roi_cls[..., 0].reshape(-1)
        soft = label.reshape(-1)
        bce = torch.relu(p) - p * soft + torch.log1p(torch.exp(-p.abs()))
        reg_w_n = reg_w / torch.maximum(reg_sum, one)
        sml1 = self.loss_roi_bbox(roi_reg, bbox_tgt)
        # the corner loss of the positives only, as upstream takes it: the
        # JAX package decodes every RoI and weights the negatives' by 0,
        # which is NaN where a random RPN's proposal is so long that its
        # decode overflows (ROADMAP section 3); the negatives decode a unit
        # box here, so neither the loss nor its gradient sees theirs
        pos = (reg_w > 0)[..., None]
        unit = roi_reg.new_tensor([0., 0., 0., 1., 1., 1., 0.])
        dec = decode_roi_boxes(torch.where(pos, samples.rois, unit),
                               torch.where(pos, roi_reg, 0.), self.roi_coder)
        corner = corner_loss_lidar(dec.reshape(-1, 7),
                                   samples.gt_of_roi.reshape(-1, 7))
        return {'loss_roi_cls': (bce * label_w.reshape(-1)).sum(),
                'loss_roi_bbox': (sml1.sum(-1) * reg_w_n).sum(),
                'loss_corner': (corner * reg_w_n.reshape(-1)).sum()}

    def loss(self, outputs, batch: Dict[str, torch.Tensor]):
        """-> (total, {rpn.loss_cls, rpn.loss_bbox, rpn.loss_dir,
        loss_semantic, loss_roi_cls, loss_roi_bbox, loss_corner,
        metric.sparse_overflow}); the metric is not part of the total.
        Under a group the overflow is already the global count and the
        train step sums every metric over the ranks, so each rank reports
        its 1 / R share of it."""
        rpn_outs, out2, samples = outputs
        gt = [batch[k].to(self.device)
              for k in ('gt_bboxes', 'gt_labels', 'gt_valid')]
        cls, bbox, dirp, packed = rpn_outs
        targets = self.rpn_head.get_targets(self.anchors, *gt)
        rpn = self.rpn_head.loss(cls, bbox, dirp, self.anchors, targets,
                                 packed=packed, group=self.group)
        losses = {f'rpn.{k}': v for k, v in rpn.items()}
        mask_head = self.trunk.second.semantic_head
        seg_tgt = mask_head.get_targets(out2['keypoints'], *gt)
        losses['loss_semantic'] = mask_head.loss(
            out2['seg_logits'], seg_tgt, self.loss_seg, group=self.group)
        losses.update(self.rcnn_losses(samples, out2['roi_cls'],
                                       out2['roi_reg']))
        total = sum(losses.values())
        losses['metric.sparse_overflow'] = \
            out2['sparse_overflow'].float().detach() / world_of(self.group)
        return total, losses

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def apply_eval(self, batch: Dict[str, torch.Tensor]):
        """Both stages in eval mode on the proposals -> (second-stage
        outputs, (rois, labels, scores, valid))."""
        self.trunk.eval()
        b = batch['points'].shape[0]
        feats, coords = self.voxelize(batch)
        levels, bev, _, rpn_outs = self.trunk.first(feats, coords, b)
        rois = self.proposals(rpn_outs)
        out2 = self.trunk.second(levels, bev,
                                 batch['points'].to(self.device),
                                 batch['points_mask'].to(self.device),
                                 rois[0], rois[3])
        return out2, rois

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor],
                score_thr: float = 0.1, nms_thr: float = 0.1,
                max_num: int = 64):
        """Refined RoI boxes scored by the sigmoid IoU quality, one rotated
        NMS a sample (all in one K5 and one K6 launch) -> (boxes (B, M,
        7), scores (B, M), labels (B, M) int32, valid (B, M)), M =
        min(max_num, num_proposals)."""
        out2, (rois, labels, _, valid) = self.apply_eval(batch)
        refined = decode_roi_boxes(rois, out2['roi_reg'], self.roi_coder)
        score = torch.sigmoid(out2['roi_cls'][..., 0]) * valid.float()
        order = torch.argsort(-torch.where(valid, score, -torch.inf), dim=1,
                              stable=True)
        boxes = refined.gather(1, order[..., None].expand(-1, -1, 7))
        s, labels = score.gather(1, order), labels.gather(1, order)
        valid = valid.gather(1, order)
        keep = nms_bev(boxes[..., [0, 1, 3, 4, 6]], nms_thr,
                       valid & (s > score_thr))
        top_s, idx = top_k(torch.where(keep, s, -1.0),
                           min(max_num, s.shape[1]))
        return (boxes.gather(1, idx[..., None].expand(-1, -1, 7)), top_s,
                labels.gather(1, idx), top_s > score_thr)
