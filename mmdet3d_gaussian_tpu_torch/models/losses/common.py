"""Standard detection losses with the JAX package's formulas.

Port of ``mmdet3d_gaussian_tpu/models/losses/common.py``: ``FocalLoss``
(sigmoid focal over logits, mmdet label convention), ``SmoothL1Loss``,
``L1Loss``, ``CrossEntropyLoss`` and ``GaussianFocalLoss``, each an
elementwise loss followed by ``weight_reduce_loss``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...registry import LOSSES
from .gaussian import weight_reduce_loss


def sigmoid_focal_loss(pred, target_onehot, gamma=2.0, alpha=0.25):
    """Elementwise sigmoid focal loss; ``target_onehot`` is a bool class
    mask (or {0, 1} values; background = all false)."""
    pos = target_onehot if target_onehot.dtype == torch.bool \
        else target_onehot > 0
    pred = pred.float()
    p = torch.sigmoid(pred)
    pt = torch.where(pos, 1.0 - p, p)
    alpha_t = torch.where(pos, alpha, 1.0 - alpha)
    ce = torch.where(pos, -F.logsigmoid(pred), -F.logsigmoid(-pred))
    return alpha_t * pt ** gamma * ce


@LOSSES.register_module()
class FocalLoss:
    def __init__(self, use_sigmoid=True, gamma=2.0, alpha=0.25,
                 reduction='mean', loss_weight=1.0):
        if not use_sigmoid:
            raise ValueError('FocalLoss is sigmoid-only')
        self.gamma, self.alpha = gamma, alpha
        self.reduction, self.loss_weight = reduction, loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        """pred (..., C) logits; target (...) int labels in [0, C], C =
        background."""
        num_classes = pred.shape[-1]
        pos = target[..., None] == torch.arange(
            num_classes, dtype=target.dtype, device=target.device)
        loss = sigmoid_focal_loss(pred, pos, self.gamma, self.alpha)
        if weight is not None and weight.dim() == loss.dim() - 1:
            if avg_factor is not None:
                return self.loss_weight * weight_reduce_loss(
                    loss.sum(-1), weight, self.reduction, avg_factor)
            weight = weight[..., None]
        return self.loss_weight * weight_reduce_loss(
            loss, weight, self.reduction, avg_factor)


@LOSSES.register_module()
class SmoothL1Loss:
    def __init__(self, beta=1.0, reduction='mean', loss_weight=1.0):
        self.beta, self.reduction = beta, reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        diff = (pred - target).abs()
        loss = torch.where(diff < self.beta, 0.5 * diff * diff / self.beta,
                           diff - 0.5 * self.beta)
        return self.loss_weight * weight_reduce_loss(
            loss, weight, self.reduction, avg_factor)


@LOSSES.register_module()
class L1Loss:
    def __init__(self, reduction='mean', loss_weight=1.0):
        self.reduction, self.loss_weight = reduction, loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        return self.loss_weight * weight_reduce_loss(
            (pred - target).abs(), weight, self.reduction, avg_factor)


@LOSSES.register_module()
class CrossEntropyLoss:
    """Softmax CE over the class dim (or per-class sigmoid CE)."""

    def __init__(self, use_sigmoid=False, reduction='mean', loss_weight=1.0):
        self.use_sigmoid = use_sigmoid
        self.reduction, self.loss_weight = reduction, loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        if self.use_sigmoid:
            loss = torch.where(target.to(pred.dtype) > 0,
                               -F.logsigmoid(pred), -F.logsigmoid(-pred))
            loss = loss.sum(-1)
        else:
            logp = torch.log_softmax(pred, dim=-1)
            onehot = F.one_hot(target.long(), pred.shape[-1]).to(logp.dtype)
            loss = -(logp * onehot).sum(-1)
        return self.loss_weight * weight_reduce_loss(
            loss, weight, self.reduction, avg_factor)


@LOSSES.register_module()
class GaussianFocalLoss:
    """Heatmap focal loss (CornerNet / CenterNet form) over a [0, 1]
    Gaussian target heatmap; positives are cells with target == 1."""

    def __init__(self, alpha=2.0, gamma=4.0, reduction='mean',
                 loss_weight=1.0):
        self.alpha, self.gamma = alpha, gamma
        self.reduction, self.loss_weight = reduction, loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        eps = 1e-12
        pos = (target == 1.0).to(pred.dtype)
        neg = 1.0 - pos
        neg_w = torch.pow(torch.clamp(1.0 - target, 0.0, 1.0), self.gamma)
        loss = (-torch.log(pred + eps) * torch.pow(1 - pred, self.alpha) * pos
                - torch.log(1 - pred + eps) * torch.pow(pred, self.alpha)
                * neg_w * neg)
        return self.loss_weight * weight_reduce_loss(
            loss, weight, self.reduction, avg_factor)
