"""Gaussian-distribution-distance regression losses.

Port of ``mmdet3d_gaussian_tpu/models/losses/gaussian.py``: a 3D box
``(x, y, z, dx, dy, dz, yaw)`` is an anisotropic Gaussian with mean
``xyz + center_offset * dims`` and block-diagonal covariance
``[[R diag(a^2, b^2) R^T, 0], [0, sl^2]]``, ``a = dx/2, b = dy/2,
sl = dz/2``; every distance is scalar component arithmetic on same-shape
planes.  The seven losses of ``BAG_GD_LOSS``: gwd3d, kld3d, jd3d,
kld3d_symmax, kld3d_symmin, bd3d, kfiou3d.

Clips are written as ``maximum`` / ``minimum`` so the gradient at a tie is
split 0.5 / 0.5, as ``jnp.clip`` / ``jnp.maximum`` do (``torch.clamp``
passes the whole gradient at the boundary).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...registry import LOSSES

_EPS_DIM = 1e-7
_DIM_MAX = 1e7
_SQRT_FLOOR = 1e-9   # sqrt'(0) = inf: floor the radicand (finite gradient
                     # that a zero weight can kill)


def _clip(x: torch.Tensor, lo: float, hi: Optional[float] = None):
    x = torch.maximum(x, x.new_tensor(lo))
    return x if hi is None else torch.minimum(x, x.new_tensor(hi))


def _safe_sqrt(x):
    return torch.sqrt(_clip(x, _SQRT_FLOOR))


def gaussian_params(boxes, center_offset: Sequence[float] = (0., 0., 0.5)):
    """Box ``(..., 7)`` tensor or length-7 component sequence -> dict of
    Gaussian components ``x, y, z, cos, sin, a, b, sl``; dims clamped to
    [1e-7, 1e7] before halving."""
    if isinstance(boxes, (tuple, list)):
        x, y, z, w, l, h, yaw = boxes
    else:
        x, y, z, w, l, h, yaw = boxes[..., :7].unbind(-1)
    off = center_offset
    return dict(x=x + off[0] * w, y=y + off[1] * l, z=z + off[2] * h,
                cos=torch.cos(yaw), sin=torch.sin(yaw),
                a=0.5 * _clip(w, _EPS_DIM, _DIM_MAX),
                b=0.5 * _clip(l, _EPS_DIM, _DIM_MAX),
                sl=0.5 * _clip(h, _EPS_DIM, _DIM_MAX))


def _sigma_bev(g):
    """Sigma_bev = R diag(a^2, b^2) R^T as (s00, s01, s11)."""
    c, s, a2, b2 = g['cos'], g['sin'], g['a'] ** 2, g['b'] ** 2
    return (a2 * c * c + b2 * s * s, (a2 - b2) * c * s,
            a2 * s * s + b2 * c * c)


def _sigma_bev_inv(g):
    """Sigma_bev^-1 = R diag(1/a^2, 1/b^2) R^T as (i00, i01, i11)."""
    c, s = g['cos'], g['sin']
    ia2, ib2 = 1.0 / g['a'] ** 2, 1.0 / g['b'] ** 2
    return (ia2 * c * c + ib2 * s * s, (ia2 - ib2) * c * s,
            ia2 * s * s + ib2 * c * c)


def postprocess(distance, fun: str = 'log1p', tau: float = 1.0):
    """Nonlinearity + tau saturation."""
    if fun == 'log1p':
        distance = torch.log1p(distance)
    elif fun == 'expm1':
        distance = torch.expm1(distance)
    elif fun == 'nlog':
        distance = -torch.log(1.0 - distance + 1e-7)
    elif fun != 'none':
        raise ValueError(f'Invalid non-linear function {fun}')
    if tau >= 1.0:
        return 1.0 - tau / (tau + distance)
    return distance


def gwd3d(gp, gt, fun='log1p', tau=1.0, alpha=1.0, normalize=True):
    """3D Gaussian-Wasserstein distance."""
    xyz_d = ((gp['x'] - gt['x']) ** 2 + (gp['y'] - gt['y']) ** 2
             + (gp['z'] - gt['z']) ** 2)
    p00, p01, p11 = _sigma_bev(gp)
    t00, t01, t11 = _sigma_bev(gt)
    tr_pt = p00 * t00 + 2 * p01 * t01 + p11 * t11
    det_sqrt = gp['a'] * gp['b'] * gt['a'] * gt['b']
    whlr = (gp['a'] ** 2 + gp['b'] ** 2 + gt['a'] ** 2 + gt['b'] ** 2
            - 2 * _safe_sqrt(tr_pt + 2 * det_sqrt)
            + (gp['sl'] - gt['sl']) ** 2)
    distance = _safe_sqrt(xyz_d + alpha * alpha * whlr)
    if normalize:
        logsum = (torch.log(det_sqrt) + torch.log(gp['sl'])
                  + torch.log(gt['sl']))
        distance = distance / (2 * torch.exp(logsum / 6.0))
    return postprocess(distance, fun, tau)


def kld3d(gp, gt, fun='log1p', tau=1.0, alpha=1.0, sqrt=True):
    """KL-style divergence with the pred covariance inverted."""
    i00, i01, i11 = _sigma_bev_inv(gp)
    t00, t01, t11 = _sigma_bev(gt)
    dx, dy, dz = gp['x'] - gt['x'], gp['y'] - gt['y'], gp['z'] - gt['z']
    isl2_p = 1.0 / gp['sl'] ** 2
    xyz_d = 0.5 * (i00 * dx * dx + 2 * i01 * dx * dy + i11 * dy * dy)
    xyz_d = xyz_d + 0.5 * dz * dz * isl2_p
    whlr = 0.5 * (i00 * t00 + 2 * i01 * t01 + i11 * t11)
    whlr = whlr + 0.5 * isl2_p * gt['sl'] ** 2
    log_det_p = torch.log(gp['a']) + torch.log(gp['b']) + torch.log(gp['sl'])
    log_det_t = torch.log(gt['a']) + torch.log(gt['b']) + torch.log(gt['sl'])
    whlr = whlr + (log_det_p - log_det_t) - 1.5
    distance = xyz_d / (alpha * alpha) + whlr
    if sqrt:
        distance = _safe_sqrt(distance)
    return postprocess(distance, fun, tau)


def bd3d(gp, gt, fun='log1p', tau=1.0, alpha=1.0, sqrt=True):
    """Bhattacharyya distance."""
    p00, p01, p11 = _sigma_bev(gp)
    t00, t01, t11 = _sigma_bev(gt)
    m00, m01, m11 = 0.5 * (p00 + t00), 0.5 * (p01 + t01), 0.5 * (p11 + t11)
    ml = 0.5 * (gp['sl'] ** 2 + gt['sl'] ** 2)
    det = _clip(m00 * m11 - m01 * m01, 1e-7)
    inv_det = 1.0 / det
    dx, dy, dz = gp['x'] - gt['x'], gp['y'] - gt['y'], gp['z'] - gt['z']
    quad = (m11 * dx * dx - 2 * m01 * dx * dy + m00 * dy * dy) * inv_det
    xyz_d = 0.125 * quad + 0.125 * dz * dz / ml
    whlr = 0.5 * (torch.log(det) + torch.log(ml))
    whlr = whlr - 0.25 * (torch.log(gp['a'] ** 2) + torch.log(gp['b'] ** 2)
                          + torch.log(gp['sl'] ** 2))
    whlr = whlr - 0.25 * (torch.log(gt['a'] ** 2) + torch.log(gt['b'] ** 2)
                          + torch.log(gt['sl'] ** 2))
    distance = xyz_d / (alpha * alpha) + whlr
    if sqrt:
        distance = _safe_sqrt(distance)
    return postprocess(distance, fun, tau)


def jd3d(gp, gt, fun='log1p', tau=1.0, alpha=1.0, sqrt=True):
    """Jeffreys = 0.5 (KL(p, t) + KL(t, p))."""
    jd = 0.5 * (kld3d(gp, gt, fun='none', tau=0., alpha=alpha, sqrt=False)
                + kld3d(gt, gp, fun='none', tau=0., alpha=alpha, sqrt=False))
    if sqrt:
        jd = _safe_sqrt(jd)
    return postprocess(jd, fun, tau)


def kld3d_symmax(gp, gt, fun='log1p', tau=1.0, alpha=1.0, sqrt=True):
    """Max of both KL directions."""
    kl_pt = kld3d(gp, gt, fun='none', tau=0., alpha=alpha, sqrt=sqrt)
    kl_tp = kld3d(gt, gp, fun='none', tau=0., alpha=alpha, sqrt=sqrt)
    return postprocess(torch.maximum(kl_pt, kl_tp), fun, tau)


def kld3d_symmin(gp, gt, fun='log1p', tau=1.0, alpha=1.0, sqrt=True):
    """Min of both KL directions."""
    kl_pt = kld3d(gp, gt, fun='none', tau=0., alpha=alpha, sqrt=sqrt)
    kl_tp = kld3d(gt, gp, fun='none', tau=0., alpha=alpha, sqrt=sqrt)
    return postprocess(torch.minimum(kl_pt, kl_tp), fun, tau)


def kfiou3d(gp, gt, fun='expm1', tau=0.0, alpha=1.0, sqrt=False):
    """Kalman-filter IoU loss; ``tau`` and ``alpha`` are unused (tau 0)."""
    del alpha, sqrt
    p00, p01, p11 = _sigma_bev(gp)
    t00, t01, t11 = _sigma_bev(gt)
    s00, s01, s11 = p00 + t00, p01 + t01, p11 + t11
    det = (s00 * s11 - s01 * s01) * (gp['sl'] ** 2 + gt['sl'] ** 2)
    vol_p = gp['a'] * gp['b'] * gp['sl']
    vol_t = gt['a'] * gt['b'] * gt['sl']
    inter = vol_p * vol_t / torch.sqrt(_clip(det, 1e-7))
    union = _clip(vol_p + vol_t - inter, 1e-7)
    return postprocess(1.0 - 4.656854249492381 * (inter / union), fun, 0.0)


BAG_GD_LOSS = {
    'gwd3d': gwd3d,
    'kld3d': kld3d,
    'jd3d': jd3d,
    'kld3d_symmax': kld3d_symmax,
    'kld3d_symmin': kld3d_symmin,
    'bd3d': bd3d,
    'kfiou3d': kfiou3d,
}


def weight_reduce_loss(loss, weight=None, reduction='mean', avg_factor=None):
    """mmdet ``weight_reduce_loss`` semantics."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        if reduction == 'mean':
            return loss.mean()
        if reduction == 'sum':
            return loss.sum()
        return loss
    if reduction == 'mean':
        return loss.sum() / avg_factor
    if reduction == 'none':
        return loss
    raise ValueError('avg_factor can not be used with reduction="sum"')


@LOSSES.register_module()
class GDLoss:
    """Gaussian-distance loss module.  Entries with ``weight <= 0`` have
    their pred replaced by the target before the distance (branch-free
    zero-weight rule), so padded rows give no NaN and no gradient.

    ``pred`` / ``target``: (..., 7) tensors, or length-7 sequences of
    same-shape component planes with a ``weight`` of that shape."""

    def __init__(self, loss_type: str, center_offset=(0., 0., 0.5),
                 fun: str = 'log1p', tau: float = 1.0, alpha: float = 1.0,
                 reduction: str = 'mean', loss_weight: float = 1.0,
                 **kwargs):
        if reduction not in ('none', 'sum', 'mean'):
            raise ValueError(f'unknown reduction {reduction!r}')
        if loss_type not in BAG_GD_LOSS:
            raise ValueError(f'unknown loss_type {loss_type!r}')
        funs = ('nlog', 'expm1', 'none') if loss_type == 'kfiou3d' \
            else ('log1p', 'none')
        if fun not in funs:
            raise ValueError(f'{loss_type} takes fun in {funs}, got {fun!r}')
        self.loss_fn = BAG_GD_LOSS[loss_type]
        self.loss_type = loss_type
        self.center_offset = tuple(center_offset)
        self.fun = fun
        self.tau = tau
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.kwargs = kwargs

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override: Optional[str] = None, **kwargs):
        reduction = reduction_override or self.reduction
        fkwargs = dict(self.kwargs)
        fkwargs.update(kwargs)
        if isinstance(pred, (tuple, list)):
            if weight is not None:
                valid = weight > 0
                pred = tuple(torch.where(valid, p, t)
                             for p, t in zip(pred, target))
        else:
            pred = pred.reshape(-1, pred.shape[-1])
            target = target.reshape(-1, target.shape[-1])
            if weight is not None:
                weight = (weight.reshape(pred.shape[0], -1)
                          if weight.dim() > 1 else weight)
                if weight.dim() == 2 and weight.shape == pred.shape:
                    weight = weight.mean(-1)
                else:
                    weight = weight.reshape(-1)
                pred = torch.where((weight > 0)[:, None], pred, target)
        gp = gaussian_params(pred, self.center_offset)
        gt = gaussian_params(target, self.center_offset)
        loss = self.loss_fn(gp, gt, fun=self.fun, tau=self.tau,
                            alpha=self.alpha, **fkwargs)
        return self.loss_weight * weight_reduce_loss(loss, weight, reduction,
                                                     avg_factor)


def gd_loss(loss_type: str, pred, target, weight=None, avg_factor=None,
            **cfg):
    """Functional one-shot form of :class:`GDLoss`."""
    return GDLoss(loss_type, **cfg)(pred, target, weight=weight,
                                    avg_factor=avg_factor)
