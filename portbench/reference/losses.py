"""Loss functions of the reference (elementwise; the callers weight and
sum)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def focal_sum(logits, onehot, gamma, alpha):
    """Sigmoid focal loss summed over the class dim: (..., C) -> (...)."""
    p = torch.sigmoid(logits)
    pt = torch.where(onehot, 1 - p, p)
    at = torch.where(onehot, alpha, 1 - alpha)
    ce = torch.where(onehot, -F.logsigmoid(logits), -F.logsigmoid(-logits))
    return (at * pt.pow(gamma) * ce).sum(-1)


def cross_entropy(logits, target):
    return -torch.log_softmax(logits, -1).gather(
        -1, target[..., None]).squeeze(-1)


def _gauss(boxes, off):
    x, y, z, w, l, h, yaw = boxes.unbind(-1)
    a = 0.5 * w.clamp(1e-7, 1e7)
    b = 0.5 * l.clamp(1e-7, 1e7)
    sl = 0.5 * h.clamp(1e-7, 1e7)
    return (x + off[0] * w, y + off[1] * l, z + off[2] * h,
            torch.cos(yaw), torch.sin(yaw), a, b, sl)


def gd_distance(loss_type, pred, target, center_offset, fun, tau, alpha):
    """Gaussian distance of (N, 7) boxes after the nonlinearity and the tau
    saturation (KLD with the predicted covariance inverted, square-rooted;
    or the normalized GWD)."""
    px, py, pz, pc, ps, pa, pb, psl = _gauss(pred, center_offset)
    tx, ty, tz, tc, ts, ta, tb, tsl = _gauss(target, center_offset)
    if loss_type == 'kld3d':
        ia2, ib2 = 1 / pa ** 2, 1 / pb ** 2
        i00 = ia2 * pc * pc + ib2 * ps * ps
        i01 = (ia2 - ib2) * pc * ps
        i11 = ia2 * ps * ps + ib2 * pc * pc
        a2, b2 = ta ** 2, tb ** 2
        t00 = a2 * tc * tc + b2 * ts * ts
        t01 = (a2 - b2) * tc * ts
        t11 = a2 * ts * ts + b2 * tc * tc
        dx, dy, dz = px - tx, py - ty, pz - tz
        quad = 0.5 * (i00 * dx * dx + 2 * i01 * dx * dy + i11 * dy * dy) \
            + 0.5 * dz * dz / psl ** 2
        trace = 0.5 * (i00 * t00 + 2 * i01 * t01 + i11 * t11) \
            + 0.5 * tsl ** 2 / psl ** 2
        logdet = (torch.log(pa) + torch.log(pb) + torch.log(psl)
                  - torch.log(ta) - torch.log(tb) - torch.log(tsl))
        d = quad / (alpha * alpha) + trace + logdet - 1.5
        d = torch.sqrt(d.clamp(min=1e-9))
    else:
        raise NotImplementedError(f'reference loss {loss_type}')
    if fun == 'log1p':
        d = torch.log1p(d)
    elif fun != 'none':
        raise NotImplementedError(f'nonlinearity {fun}')
    return 1.0 - tau / (tau + d) if tau >= 1.0 else d
