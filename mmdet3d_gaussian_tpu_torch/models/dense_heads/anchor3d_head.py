"""GD Anchor3D head (predict path): 1x1 head convs, decode and per-class
rotated NMS.

Port of ``mmdet3d_gaussian_tpu/models/dense_heads/anchor3d_head.py``:
``Anchor3DHeadConvs`` and the predict half of ``GDAnchor3DHead``
(``anchors_for``, ``get_bboxes``).  ``get_bboxes`` runs a whole batch: the
B x num_classes NMS problems go through one launch of the rotated-IoU kernel
and one of the sweep kernel, with the JAX package's per-problem semantics
(``lax.top_k`` order: descending, ties to the lower index).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchor import Anchor3DRangeGenerator
from ...core.bbox.coders import DeltaXYZWLHRBBoxCoder
from ...core.bbox.structures import limit_period
from ...ops.nms import nms_bev
from ...registry import MODELS

PRIOR_PROB = 0.01   # focal-loss prior of the cls bias (mmdet
                    # bias_init_with_prob)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim with ``lax.top_k``'s order: descending,
    ties broken by the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@MODELS.register_module()
class Anchor3DHeadConvs(nn.Module):
    """1x1 cls / reg / dir convs over the neck output, computed as one
    fused conv whose output is zero-padded to a multiple of ``pack_lanes``
    channels.  Returns NHWC (cls_score, bbox_pred, dir_pred, packed)."""

    def __init__(self, num_classes: int, num_anchors: int,
                 feat_channels: int = 384,
                 use_direction_classifier: bool = True,
                 box_code_size: int = 7, pack_lanes: int = 128):
        super().__init__()
        self.nc = num_anchors * num_classes
        self.nb = num_anchors * box_code_size
        self.nd = num_anchors * 2 if use_direction_classifier else 0
        self.pack_lanes = pack_lanes
        self.conv_cls = nn.Conv2d(feat_channels, self.nc, 1)
        self.conv_reg = nn.Conv2d(feat_channels, self.nb, 1)
        self.conv_dir_cls = (nn.Conv2d(feat_channels, self.nd, 1)
                             if use_direction_classifier else None)

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x = torch.cat(list(x), dim=-1)
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
        packed = F.conv2d(x.permute(0, 3, 1, 2), w, b).permute(0, 2, 3, 1)
        nc, nb, nd = self.nc, self.nb, self.nd
        cls_score = packed[..., :nc]
        bbox_pred = packed[..., nc:nc + nb]
        dir_pred = packed[..., nc + nb:nc + nb + nd] if nd else None
        return cls_score, bbox_pred, dir_pred, packed


class GDAnchor3DHead:
    """Config holder + predict-time functions of the GD anchor head.

    Training entries of the shared config (assigners, losses, code /
    decode weights, pos_cap, train_cfg) are accepted and ignored: this port
    covers prediction only so far."""

    def __init__(self, num_classes: int, anchor_generator: Dict[str, Any],
                 dir_offset: float = -math.pi / 2,
                 test_cfg: Optional[Dict[str, Any]] = None,
                 **_train_only: Any):
        self.num_classes = num_classes
        self.anchor_generator = Anchor3DRangeGenerator(**anchor_generator)
        self.coder = DeltaXYZWLHRBBoxCoder()
        self.dir_offset = dir_offset
        self.test_cfg = dict(test_cfg or {})
        if not self.test_cfg.get('use_rotate_nms', True):
            raise NotImplementedError('axis-aligned NMS is not ported yet')

    def anchors_for(self, featmap_size: Sequence[int]):
        """(H, W) -> numpy anchors (H, W, S, R, 7)."""
        return self.anchor_generator.single_level_grid_anchors(
            tuple(featmap_size))

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
        scores = torch.sigmoid(cls_score.reshape(b, -1, c).float())
        deltas = bbox_pred.reshape(b, -1, 7).float()
        boxes = self.coder.decode(anchors.reshape(-1, 7), deltas)
        dir_cls = dir_pred.reshape(b, -1, 2).argmax(-1)
        # mmdet3d dir correction with dir_limit_offset = 0
        yaw = boxes[..., 6]
        dir_rot = limit_period(yaw - self.dir_offset, 0.0, math.pi)
        yaw = dir_rot + self.dir_offset + math.pi * dir_cls.to(yaw.dtype)
        boxes = torch.cat([boxes[..., :6], yaw[..., None]], dim=-1)

        k = min(int(cfg.get('nms_pre', 1024)), scores.shape[1])
        _, topi = top_k(scores.max(dim=-1).values, k)          # (B, K)
        scores_k = scores.gather(1, topi[..., None].expand(b, k, c))
        boxes_k = boxes.gather(1, topi[..., None].expand(b, k, 7))
        s = scores_k.transpose(1, 2)                           # (B, C, K)
        s_sorted, idx = top_k(torch.where(s > score_thr, s, -1.0), k)
        b_sorted = boxes_k[:, None].expand(b, c, k, 7).gather(
            2, idx[..., None].expand(b, c, k, 7))
        return b_sorted, s_sorted, s_sorted > score_thr

    def get_bboxes(self, cls_score, bbox_pred, dir_pred, anchors,
                   max_num: Optional[int] = None):
        """Batched decode + per-class rotated NMS -> fixed-size detections
        (boxes (B, M, 7), scores (B, M), labels (B, M) int32, valid (B, M)
        bool) with M = ``max_num`` or ``test_cfg['max_num']``."""
        cfg = self.test_cfg
        score_thr = float(cfg.get('score_thr', 0.05))
        nms_thr = float(cfg.get('nms_thr', 0.01))
        max_num = int(max_num or cfg.get('max_num', 100))
        b_sorted, s_sorted, v_sorted = self.select_candidates(
            cls_score, bbox_pred, dir_pred, anchors)
        b, c, k = s_sorted.shape
        bev = b_sorted[..., [0, 1, 3, 4, 6]].reshape(b * c, k, 5)
        keep = nms_bev(bev, nms_thr, v_sorted.reshape(b * c, k))
        kept = torch.where(keep.reshape(b, c, k), s_sorted, -1.0)
        final_scores, fidx = top_k(kept.reshape(b, c * k), max_num)
        boxes = b_sorted.reshape(b, c * k, 7).gather(
            1, fidx[..., None].expand(-1, -1, 7))
        labels = (fidx // k).to(torch.int32)
        return boxes, final_scores, labels, final_scores > score_thr
