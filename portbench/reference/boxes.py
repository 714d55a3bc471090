"""Box arithmetic of the reference: angle periods, the nearest-BEV IoU of
the anchor assigners, the anchor delta coder, direction targets, the
rotated BEV IoU (the intersection polygon of two rectangles: corners
inside the other box and edge crossings, ordered by angle about their
centroid, area by the shoelace formula) and greedy NMS."""
from __future__ import annotations

import math

import torch


def limit_period(val, offset=0.5, period=math.pi):
    return val - torch.floor(val / period + offset) * period


def nearest_bev(boxes):
    """(..., 7) -> axis-aligned (x1, y1, x2, y2): yaw snapped to the nearest
    quarter turn, dx and dy swapped on odd quarter turns."""
    yaw = limit_period(boxes[..., 6], 0.5, math.pi)
    swap = yaw.abs() > math.pi / 4
    dx = torch.where(swap, boxes[..., 4], boxes[..., 3])
    dy = torch.where(swap, boxes[..., 3], boxes[..., 4])
    half = torch.stack([dx, dy], -1) / 2
    return torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], -1)


def aligned_iou(a, b):
    """(..., N, 4) x (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-6)


def encode(anchors, gt):
    """Anchor deltas: xy over the anchor's BEV diagonal, z (box centre)
    over its height, log size ratios, raw yaw difference."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xg, yg, zg, wg, lg, hg, rg = gt[..., :7].unbind(-1)
    diag = torch.sqrt(la * la + wa * wa)
    return torch.stack([(xg - xa) / diag, (yg - ya) / diag,
                        ((zg + hg / 2) - (za + ha / 2)) / ha,
                        torch.log(wg / wa), torch.log(lg / la),
                        torch.log(hg / ha), rg - ra], -1)


def decode(anchors, d):
    xa, ya, za, wa, la, ha, ra = anchors.unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = d.unbind(-1)
    diag = torch.sqrt(la * la + wa * wa)
    w, l, h = torch.exp(wt) * wa, torch.exp(lt) * la, torch.exp(ht) * ha
    return torch.stack([xt * diag + xa, yt * diag + ya,
                        zt * ha + (za + ha / 2) - h / 2, w, l, h, rt + ra],
                       -1)


def direction_target(anchor_yaw, yaw_delta, dir_offset, bins=2):
    rot = limit_period(yaw_delta + anchor_yaw - dir_offset, 0, 2 * math.pi)
    return torch.floor(rot / (2 * math.pi / bins)).clamp(0, bins - 1).long()


def _corners(b):
    """(..., 5) (cx, cy, w, h, yaw) -> (..., 4, 2) counter-clockwise."""
    c, s = torch.cos(b[..., 4]), torch.sin(b[..., 4])
    hw, hh = b[..., 2:3] / 2, b[..., 3:4] / 2
    lx = torch.cat([-hw, hw, hw, -hw], -1)
    ly = torch.cat([-hh, -hh, hh, hh], -1)
    return torch.stack([b[..., 0:1] + c[..., None] * lx - s[..., None] * ly,
                        b[..., 1:2] + s[..., None] * lx + c[..., None] * ly],
                       -1)


def _inside(p, b):
    """Points p (..., n, 2) inside boxes b (..., 5) (boundary included)."""
    c, s = torch.cos(b[..., 4])[..., None], torch.sin(b[..., 4])[..., None]
    dx, dy = p[..., 0] - b[..., 0:1], p[..., 1] - b[..., 1:2]
    lx, ly = c * dx + s * dy, -s * dx + c * dy
    return ((lx.abs() <= b[..., 2:3] / 2 + 1e-5)
            & (ly.abs() <= b[..., 3:4] / 2 + 1e-5))


def rotated_iou(a, b):
    """IoU of rotated BEV boxes a (..., 5) and b (..., 5), elementwise."""
    ca, cb = _corners(a), _corners(b)                     # (..., 4, 2)
    pa, pb = ca, cb
    # edge crossings: edge i of a with edge j of b
    a0, a1 = ca, ca.roll(-1, -2)
    b0, b1 = cb, cb.roll(-1, -2)
    r = (a1 - a0)[..., :, None, :]                        # (..., 4, 1, 2)
    q = (b1 - b0)[..., None, :, :]                        # (..., 1, 4, 2)
    qp = b0[..., None, :, :] - a0[..., :, None, :]
    den = r[..., 0] * q[..., 1] - r[..., 1] * q[..., 0]
    safe = torch.where(den.abs() > 1e-12, den, torch.ones_like(den))
    t = (qp[..., 0] * q[..., 1] - qp[..., 1] * q[..., 0]) / safe
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / safe
    hit = (den.abs() > 1e-12) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    cross = a0[..., :, None, :] + t[..., None] * r        # (..., 4, 4, 2)
    shape = cross.shape[:-3]
    pts = torch.cat([pa, pb, cross.reshape(*shape, 16, 2)], -2)
    ok = torch.cat([_inside(pa, b), _inside(pb, a),
                    hit.reshape(*shape, 16)], -1)          # (..., 24)
    n = ok.sum(-1, keepdim=True)
    okf = ok.to(pts.dtype)[..., None]
    ctr = (pts * okf).sum(-2) / n.clamp(min=1).to(pts.dtype)
    ang = torch.atan2(pts[..., 1] - ctr[..., 1:2], pts[..., 0] - ctr[..., 0:1])
    ang = torch.where(ok, ang, torch.full_like(ang, 10.0))
    order = ang.argsort(-1)
    srt = torch.gather(pts, -2, order[..., None].expand_as(pts))
    sok = torch.gather(ok, -1, order)
    first = srt[..., :1, :].expand_as(srt)
    srt = torch.where(sok[..., None], srt, first)
    nxt = srt.roll(-1, -2)
    area2 = (srt[..., 0] * nxt[..., 1] - srt[..., 1] * nxt[..., 0]).sum(-1)
    inter = torch.where(n[..., 0] >= 3, area2.abs() / 2,
                        torch.zeros_like(area2))
    area_a, area_b = a[..., 2] * a[..., 3], b[..., 2] * b[..., 3]
    inter = torch.minimum(torch.minimum(inter, area_a), area_b)
    return inter / (area_a + area_b - inter).clamp(min=1e-6)


def nms(boxes, scores_valid, thr):
    """Greedy NMS of P problems of K boxes (P, K, 5) sorted by descending
    score: a box is kept when valid and no earlier kept box overlaps it by
    an IoU over ``thr``.  -> keep (P, K) bool and the IoU (P, K, K)."""
    k = boxes.shape[1]
    iou = rotated_iou(boxes[:, :, None, :].expand(-1, -1, k, -1),
                      boxes[:, None, :, :].expand(-1, k, -1, -1))
    keep = scores_valid.clone()
    over = iou > thr
    for i in range(k):
        kill = over[:, i] & keep[:, i:i + 1]
        kill[:, :i + 1] = False
        keep &= ~kill
    return keep, iou
