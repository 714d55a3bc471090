"""GD Anchor3D head: 1x1 head convs, targets, losses, decode and per-class
rotated or axis-aligned NMS.

Port of ``mmdet3d_gaussian_tpu/models/dense_heads/anchor3d_head.py``:
``Anchor3DHeadConvs`` and ``GDAnchor3DHead`` (``anchors_for``,
``get_targets``, ``loss`` with its dense and sparse-positive forms,
``get_bboxes``, the class-agnostic ``get_proposals`` of PV-RCNN's first
stage).  Targets are computed for the whole batch at once (the JAX
package vmaps one sample at a time).  The dense decoded-box GD loss runs
through kernel K3 (:func:`~mmdet3d_gaussian_tpu_torch.ops.gd_loss.
anchor_gd_loss`), reading ``bbox_pred`` in the conv layout.  ``get_bboxes``
runs a whole batch: the B x num_classes NMS problems go through one launch
of the rotated-IoU kernel and one of the sweep kernel, with the JAX
package's per-problem semantics (``lax.top_k`` order: descending, ties to
the lower index).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from .. import losses as _losses  # noqa: F401  (registers the losses)
from ..backbones import compute_dtype
from ...core.anchor import Anchor3DRangeGenerator
from ...core.bbox.assigners import (MaxIoUAssigner,
                                    assign_per_class_vectorized)
from ...core.bbox.coders import DeltaXYZWLHRBBoxCoder, get_direction_target
from ...core.bbox.structures import limit_period
from ...engine.profiling import span
from ...ops.gd_loss import anchor_gd_loss
from ...ops.nms import nms_bev, nms_normal_bev, top_k
from ...ops.scan import compact_indices
from ...registry import LOSSES, MODELS

PRIOR_PROB = 0.01   # focal-loss prior of the cls bias (mmdet
                    # bias_init_with_prob)


@MODELS.register_module()
class Anchor3DHeadConvs(nn.Module):
    """1x1 cls / reg / dir convs over the neck output, fused into one
    weight whose output is zero-padded to a multiple of ``pack_lanes``
    channels.  Returns NHWC (cls_score, bbox_pred, dir_pred, packed).

    As the JAX module, the fused weight is applied to each unconcatenated
    neck branch (its block of input channels) as a matmul and the products
    are summed, then the bias added.  With ``dtype='bfloat16'`` the weight
    and branches are cast to bf16 and the sum and bias are bf16, so the
    maps are bf16."""

    def __init__(self, num_classes: int, num_anchors: int,
                 feat_channels: int = 384,
                 use_direction_classifier: bool = True,
                 box_code_size: int = 7, pack_lanes: int = 128,
                 dtype: Optional[str] = None):
        super().__init__()
        self.nc = num_anchors * num_classes
        self.nb = num_anchors * box_code_size
        self.nd = num_anchors * 2 if use_direction_classifier else 0
        self.pack_lanes = pack_lanes
        self.compute_dtype = compute_dtype(dtype)
        self.conv_cls = nn.Conv2d(feat_channels, self.nc, 1)
        self.conv_reg = nn.Conv2d(feat_channels, self.nb, 1)
        self.conv_dir_cls = (nn.Conv2d(feat_channels, self.nd, 1)
                             if use_direction_classifier else None)

    def forward(self, x):
        branches = list(x) if isinstance(x, (list, tuple)) else [x]
        convs = [self.conv_cls, self.conv_reg]
        if self.conv_dir_cls is not None:
            convs.append(self.conv_dir_cls)
        w = torch.cat([m.weight for m in convs], 0)
        b = torch.cat([m.bias for m in convs], 0)
        total = w.shape[0]
        if self.pack_lanes and total % self.pack_lanes:
            pad = self.pack_lanes - total % self.pack_lanes
            w = torch.cat([w, w.new_zeros((pad,) + w.shape[1:])], 0)
            b = torch.cat([b, b.new_zeros(pad)])
        dt = self.compute_dtype or w.dtype
        w2 = w[:, :, 0, 0].t().to(dt)                     # (cin, total)
        packed, off = None, 0
        for xi in branches:
            ci = xi.shape[-1]
            yi = torch.matmul(xi.to(dt), w2[off:off + ci])
            packed = yi if packed is None else packed + yi
            off += ci
        packed = packed + b.to(dt)
        nc, nb, nd = self.nc, self.nb, self.nd
        cls_score = packed[..., :nc]
        bbox_pred = packed[..., nc:nc + nb]
        dir_pred = packed[..., nc + nb:nc + nb + nd] if nd else None
        return cls_score, bbox_pred, dir_pred, packed


class AnchorTargets(NamedTuple):
    """Per-anchor targets with a leading batch dim B; A = H*W*S*R anchors
    in (H, W, S, R) order.  Dense mode fills the (B, A) fields; sparse mode
    (``pos_cap`` > 0) carries regression / direction targets on K gathered
    positive slots per sample instead."""
    labels: torch.Tensor           # (B, A) int32 in [0, C]; C = background
    label_weights: torch.Tensor    # (B, A) f32
    bbox_targets: Optional[torch.Tensor]  # (B, A, 7) encoded deltas
    bbox_weights: torch.Tensor     # (B, A) f32
    dir_targets: Optional[torch.Tensor]   # (B, A) int32
    num_pos: torch.Tensor          # (B,) int32
    matched_gt: Optional[torch.Tensor] = None       # (B, A, 7) raw gt rows
    pos_idx: Optional[torch.Tensor] = None          # (B, K) anchor index
    pos_mask: Optional[torch.Tensor] = None         # (B, K) 1.0 = live
    pos_bbox_targets: Optional[torch.Tensor] = None  # (B, K, 7)
    pos_matched_gt: Optional[torch.Tensor] = None   # (B, K, 7)
    pos_dir: Optional[torch.Tensor] = None          # (B, K) int32
    pos_anchors: Optional[torch.Tensor] = None      # (B, K, 7)


class GDAnchor3DHead:
    """Config holder + target, loss and predict functions of the GD anchor
    head (the conv parameters live in :class:`Anchor3DHeadConvs`)."""

    def __init__(self, num_classes: int, anchor_generator: Dict[str, Any],
                 assigners: Sequence[Dict[str, Any]] = (),
                 loss_cls: Optional[Dict[str, Any]] = None,
                 loss_bbox: Optional[Dict[str, Any]] = None,
                 loss_decoded_bbox: Optional[Dict[str, Any]] = None,
                 loss_dir: Optional[Dict[str, Any]] = None,
                 dir_offset: float = -math.pi / 2,
                 diff_rad_by_sin: bool = True, assign_per_class: bool = True,
                 code_weight: Optional[Sequence[float]] = None,
                 decode_weight: Optional[float] = None,
                 pos_cap: int = 1024,
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None):
        self.num_classes = num_classes
        self.anchor_generator = Anchor3DRangeGenerator(**anchor_generator)
        self.assigners = [MaxIoUAssigner(**{k: v for k, v in a.items()
                                            if k != 'type'})
                          for a in assigners]
        self.coder = DeltaXYZWLHRBBoxCoder()
        build = lambda cfg: LOSSES.build(cfg) if cfg else None  # noqa: E731
        self.loss_cls = build(loss_cls)
        self.loss_bbox = build(loss_bbox)
        self.loss_decoded_bbox = build(loss_decoded_bbox)
        self.loss_dir = build(loss_dir)
        self.dir_offset = dir_offset
        self.diff_rad_by_sin = diff_rad_by_sin
        self.assign_per_class = assign_per_class
        self.code_weight = code_weight
        self.decode_weight = decode_weight
        # gathered-positive slots per sample (0 = dense targets / losses);
        # positives beyond pos_cap are dropped, highest anchor index first
        self.pos_cap = int(pos_cap)
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})

    def anchors_for(self, featmap_size: Sequence[int]):
        """(H, W) -> numpy anchors (H, W, S, R, 7)."""
        return self.anchor_generator.single_level_grid_anchors(
            tuple(featmap_size))

    def get_targets(self, anchors: torch.Tensor, gt_bboxes: torch.Tensor,
                    gt_labels: torch.Tensor, gt_valid: torch.Tensor
                    ) -> AnchorTargets:
        """anchors (H, W, S, R, 7); gt_bboxes (B, G, 7) padded, gt_labels
        (B, G) int, gt_valid (B, G) bool -> batched :class:`AnchorTargets`."""
        h, w, s, r, _ = anchors.shape
        flat = anchors.reshape(-1, 7)
        if self.assign_per_class and len(self.assigners) == s:
            res = assign_per_class_vectorized(
                anchors.reshape(h * w, s, r, 7), gt_bboxes, gt_labels,
                gt_valid, self.assigners)
        else:
            res = self.assigners[0].assign(flat, gt_bboxes, gt_labels,
                                           gt_valid)
        assigned = res.assigned_gt                              # (B, A)
        pos, neg = assigned > 0, assigned == 0
        safe_gt = (assigned - 1).clamp(min=0).long()
        labels = torch.where(pos, res.labels, self.num_classes).to(
            torch.int32)
        label_weights = (pos | neg).float()
        bbox_weights = pos.float()
        num_pos = pos.sum(-1).to(torch.int32)

        def gt_rows(gt_idx):                         # (B, K) -> (B, K, 7)
            return torch.gather(gt_bboxes, 1,
                                gt_idx[..., None].expand(-1, -1, 7))

        if self.pos_cap:
            k = min(self.pos_cap, flat.shape[0])
            idx, valid = compact_indices(pos, k)                # (B, K)
            anc_rows = flat[idx]
            mg_rows = gt_rows(torch.gather(safe_gt, 1, idx))
            enc_rows = self.coder.encode(anc_rows, mg_rows)
            dir_rows = get_direction_target(anc_rows, enc_rows,
                                            dir_offset=self.dir_offset)
            mrow = valid[..., None]
            return AnchorTargets(
                labels=labels, label_weights=label_weights,
                bbox_targets=None, bbox_weights=bbox_weights,
                dir_targets=None, num_pos=num_pos,
                pos_idx=idx, pos_mask=valid.float(),
                pos_bbox_targets=torch.where(mrow, enc_rows, 0.0),
                pos_matched_gt=torch.where(mrow, mg_rows, 0.0),
                pos_dir=torch.where(valid, dir_rows, 0).to(torch.int32),
                pos_anchors=anc_rows)

        matched = gt_rows(safe_gt)                              # (B, A, 7)
        bbox_targets = torch.where(pos[..., None],
                                   self.coder.encode(flat, matched), 0.0)
        dir_targets = torch.where(
            pos, get_direction_target(flat, bbox_targets,
                                      dir_offset=self.dir_offset), 0)
        return AnchorTargets(labels=labels, label_weights=label_weights,
                             bbox_targets=bbox_targets,
                             bbox_weights=bbox_weights,
                             dir_targets=dir_targets.to(torch.int32),
                             num_pos=num_pos,
                             matched_gt=torch.where(pos[..., None], matched,
                                                    0.0))

    def _code_weights(self):
        """Per-component SmoothL1 weights, or None when the sin-difference
        term is off."""
        if self.code_weight is not None:
            return ([float(v) for v in self.code_weight]
                    if any(self.code_weight) else None)
        return [1.0] * 7 if self.loss_decoded_bbox is None else None

    def _smooth_l1(self, pred_parts, tgt_parts, weight, avg):
        cw = self._code_weights()
        if cw is None:
            return 0.0
        p_parts, t_parts = tuple(pred_parts), tuple(tgt_parts)
        if self.diff_rad_by_sin:
            rp, rt = p_parts[6], t_parts[6]
            p_parts = p_parts[:6] + (torch.sin(rp) * torch.cos(rt),)
            t_parts = t_parts[:6] + (torch.cos(rp) * torch.sin(rt),)
        total = 0.0
        for i in range(7):
            if cw[i]:
                total = total + self.loss_bbox(p_parts[i], t_parts[i],
                                               weight=weight * cw[i],
                                               avg_factor=avg)
        return total

    def loss(self, cls_score, bbox_pred, dir_pred, anchors: torch.Tensor,
             targets: AnchorTargets, packed=None,
             group=None) -> Dict[str, torch.Tensor]:
        """Batched loss terms {loss_cls, loss_bbox, loss_dir}.

        cls_score (B, H, W, A*C), bbox_pred (B, H, W, A*7), dir_pred
        (B, H, W, A*2) NHWC maps; anchors (H, W, S, R, 7); targets from
        :meth:`get_targets`; packed: the fused head conv output, gathered
        from by the sparse form.  Every term is divided by ``max(sum of
        num_pos, 1)``; under ``group`` (a ``parallel.mesh.Group``) that sum
        is over every rank's samples (no gradient), so each rank's terms
        are its share of the whole batch's."""
        b, hh, ww = cls_score.shape[:3]
        a = anchors.shape[2] * anchors.shape[3]
        c = self.num_classes
        avg = targets.num_pos.sum().float()
        if group is not None:
            from ...parallel.mesh import all_reduce_sum
            avg, = all_reduce_sum([avg], group)
        avg = avg.clamp(min=1.0)
        losses = {'loss_cls': self.loss_cls(
            cls_score.reshape(b, hh, ww, a, c),
            targets.labels.reshape(b, hh, ww, a),
            targets.label_weights.reshape(b, hh, ww, a), avg_factor=avg)}
        if targets.pos_idx is not None:
            return self._loss_sparse(bbox_pred, dir_pred, targets, avg,
                                     losses, packed)

        m = b * hh * ww
        bbox_weights = targets.bbox_weights
        loss_bbox = 0.0
        gd = self.loss_decoded_bbox
        if gd is not None and self.decode_weight:
            w = bbox_weights * self.decode_weight
            if not gd.kwargs and gd.reduction == 'mean':
                # K3: decode + distance + weighted sum over (M, A*7) rows in
                # the conv layout, target deltas decoded as the JAX kernel
                cfg = (gd.loss_type, gd.center_offset, gd.fun,
                       float(gd.tau), float(gd.alpha))
                raw = anchor_gd_loss(
                    bbox_pred.float().reshape(m, a * 7),
                    targets.bbox_targets.reshape(m, a * 7),
                    w.reshape(m, a), anchors.reshape(hh * ww, a * 7),
                    hh * ww, cfg)
                loss_bbox = loss_bbox + gd.loss_weight * raw / avg
            else:
                flat_anc = anchors.reshape(-1, 7).expand(b, -1, -1)
                pred = bbox_pred.reshape(b, -1, 7).float()
                dec_p = self.coder.decode_parts(flat_anc.unbind(-1),
                                                pred.unbind(-1))
                loss_bbox = loss_bbox + gd(
                    dec_p, targets.matched_gt.unbind(-1), weight=w,
                    avg_factor=avg)
        loss_bbox = loss_bbox + self._smooth_l1(
            bbox_pred.reshape(b, -1, 7).float().unbind(-1),
            targets.bbox_targets.unbind(-1), bbox_weights, avg)
        losses['loss_bbox'] = loss_bbox
        if self.loss_dir is not None and dir_pred is not None:
            losses['loss_dir'] = self.loss_dir(
                dir_pred.reshape(b, hh, ww, a, 2).float(),
                targets.dir_targets.reshape(b, hh, ww, a),
                bbox_weights.reshape(b, hh, ww, a), avg_factor=avg)
        return losses

    def _loss_sparse(self, bbox_pred, dir_pred, tb: AnchorTargets, avg,
                     losses, packed=None):
        """Regression / direction losses on the K gathered positive slots
        of each sample (identical to the dense form while num_pos <= K).
        Component j of anchor t of cell q sits at channel t*width + j of
        its map, or at ``offset + t*width + j`` of the packed conv output;
        both gather the same values."""
        b = bbox_pred.shape[0]
        idx = tb.pos_idx                                     # (B, K)
        k = idx.shape[1]
        a = bbox_pred.shape[3] // 7
        cell, t_in_cell = idx // a, idx % a

        def rows_of(x, offset, width):
            lanes = x.shape[-1]
            ch = (cell * lanes + offset + t_in_cell * width)[..., None] \
                + torch.arange(width, device=idx.device)
            return torch.gather(x.reshape(b, -1), 1,
                                ch.reshape(b, -1)).reshape(b, k, width)

        nc, nb = a * self.num_classes, a * 7
        src_bbox = (packed, nc) if packed is not None else (bbox_pred, 0)
        pred_parts = rows_of(*src_bbox, 7).float().unbind(-1)
        w_pos = tb.pos_mask
        loss_bbox = 0.0
        gd = self.loss_decoded_bbox
        if gd is not None and self.decode_weight:
            dec_p = self.coder.decode_parts(tb.pos_anchors.unbind(-1),
                                            pred_parts)
            loss_bbox = loss_bbox + gd(
                dec_p, tb.pos_matched_gt.unbind(-1),
                weight=w_pos * self.decode_weight, avg_factor=avg)
        loss_bbox = loss_bbox + self._smooth_l1(
            pred_parts, tb.pos_bbox_targets.unbind(-1), w_pos, avg)
        losses['loss_bbox'] = loss_bbox
        if self.loss_dir is not None and dir_pred is not None:
            src_dir = (packed, nc + nb) if packed is not None \
                else (dir_pred, 0)
            losses['loss_dir'] = self.loss_dir(
                rows_of(*src_dir, 2).float(), tb.pos_dir, w_pos,
                avg_factor=avg)
        return losses

    def select_candidates(self, cls_score, bbox_pred, dir_pred, anchors):
        """Decode and pick the NMS candidates of every (sample, class).

        cls_score (B, H, W, S*R*C), bbox_pred (B, H, W, S*R*7), dir_pred
        (B, H, W, S*R*2) NHWC maps; anchors (H, W, S, R, 7) tensor.
        Returns boxes (B, C, K, 7), scores (B, C, K) and valid (B, C, K),
        each class's K = nms_pre candidates in descending score order."""
        cfg = self.test_cfg
        c = self.num_classes
        score_thr = float(cfg.get('score_thr', 0.05))
        b = cls_score.shape[0]
        scores, boxes = self.decode_boxes(cls_score, bbox_pred, dir_pred,
                                          anchors)
        k = min(int(cfg.get('nms_pre', 1024)), scores.shape[1])
        _, topi = top_k(scores.max(dim=-1).values, k)          # (B, K)
        scores_k = scores.gather(1, topi[..., None].expand(b, k, c))
        boxes_k = boxes.gather(1, topi[..., None].expand(b, k, 7))
        s = scores_k.transpose(1, 2)                           # (B, C, K)
        s_sorted, idx = top_k(torch.where(s > score_thr, s, -1.0), k)
        b_sorted = boxes_k[:, None].expand(b, c, k, 7).gather(
            2, idx[..., None].expand(b, c, k, 7))
        return b_sorted, s_sorted, s_sorted > score_thr

    def decode_boxes(self, cls_score, bbox_pred, dir_pred, anchors):
        """NHWC maps -> (scores (B, A, C), boxes (B, A, 7)) with the
        direction-corrected yaw."""
        b, c = cls_score.shape[0], self.num_classes
        scores = torch.sigmoid(cls_score.reshape(b, -1, c).float())
        deltas = bbox_pred.reshape(b, -1, 7).float()
        boxes = self.coder.decode(anchors.reshape(-1, 7), deltas)
        dir_cls = dir_pred.reshape(b, -1, 2).argmax(-1)
        # mmdet3d dir correction with dir_limit_offset = 0
        yaw = boxes[..., 6]
        dir_rot = limit_period(yaw - self.dir_offset, 0.0, math.pi)
        yaw = dir_rot + self.dir_offset + math.pi * dir_cls.to(yaw.dtype)
        return scores, torch.cat([boxes[..., :6], yaw[..., None]], dim=-1)

    def get_proposals(self, cls_score, bbox_pred, dir_pred, anchors,
                      max_num: Optional[int] = None):
        """Class-agnostic proposals (PartA2RPNHead, the PV-RCNN config's
        first stage): rank anchors by their largest class score, keep
        ``nms_pre``, one rotated (or axis-aligned) NMS over all classes,
        then the ``max_num`` best kept.  The B problems go through one
        launch of each NMS kernel.  -> (boxes (B, K, 7), scores (B, K),
        labels (B, K) int32, valid (B, K)), K = ``max_num``."""
        cfg = self.test_cfg
        score_thr = float(cfg.get('score_thr', 0.0))
        nms_thr = float(cfg.get('nms_thr', 0.8))
        max_num = int(max_num or cfg.get('max_num', 128))
        scores, boxes = self.decode_boxes(cls_score, bbox_pred, dir_pred,
                                          anchors)
        max_scores, labels = scores.max(dim=-1)
        k = min(int(cfg.get('nms_pre', 1024)), max_scores.shape[1])
        s_sorted, topi = top_k(max_scores, k)
        b_sorted = boxes.gather(1, topi[..., None].expand(-1, -1, 7))
        l_sorted = labels.gather(1, topi).to(torch.int32)
        nms = nms_bev if cfg.get('use_rotate_nms', True) else nms_normal_bev
        keep = nms(b_sorted[..., [0, 1, 3, 4, 6]], nms_thr,
                   s_sorted > score_thr)
        final, fidx = top_k(torch.where(keep, s_sorted, -1.0), max_num)
        return (b_sorted.gather(1, fidx[..., None].expand(-1, -1, 7)), final,
                l_sorted.gather(1, fidx), final > max(score_thr, 0.0))

    def get_bboxes(self, cls_score, bbox_pred, dir_pred, anchors,
                   max_num: Optional[int] = None):
        """Batched decode + per-class NMS (rotated, or with
        ``use_rotate_nms=False`` axis-aligned on the boxes' BEV bounding
        rectangles) -> fixed-size detections (boxes (B, M, 7), scores
        (B, M), labels (B, M) int32, valid (B, M) bool) with M =
        ``max_num`` or ``test_cfg['max_num']``."""
        cfg = self.test_cfg
        score_thr = float(cfg.get('score_thr', 0.05))
        nms_thr = float(cfg.get('nms_thr', 0.01))
        max_num = int(max_num or cfg.get('max_num', 100))
        b_sorted, s_sorted, v_sorted = self.select_candidates(
            cls_score, bbox_pred, dir_pred, anchors)
        b, c, k = s_sorted.shape
        bev = b_sorted[..., [0, 1, 3, 4, 6]].reshape(b * c, k, 5)
        nms = nms_bev if cfg.get('use_rotate_nms', True) else nms_normal_bev
        with span('nms'):
            keep = nms(bev, nms_thr, v_sorted.reshape(b * c, k))
        kept = torch.where(keep.reshape(b, c, k), s_sorted, -1.0)
        final_scores, fidx = top_k(kept.reshape(b, c * k), max_num)
        boxes = b_sorted.reshape(b, c * k, 7).gather(
            1, fidx[..., None].expand(-1, -1, 7))
        labels = (fidx // k).to(torch.int32)
        return boxes, final_scores, labels, final_scores > score_thr
