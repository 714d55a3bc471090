"""Exact rotated-box BEV IoU (kernel K5, ``csrc/rotated_iou.cu``).

Port of ``mmdet3d_gaussian_tpu/ops/rotated_iou.py`` (``box_corners``,
``iou_bev``, ``iou_3d``) and of the TPU kernel
``ops/pallas/rotated_iou_kernel.py``: the intersection polygon is built
branch-free from 24 candidate vertices (4 + 4 corners inside the other
box, 16 edge intersections), ordered around its centroid by the
pseudo-angle ``sign(dy) * (1 - dx / (|dx| + |dy|))``, and its shoelace
area is clamped by both box areas.

The kernel skips the polygon for *far* pairs, whose IoU is exactly that of
an empty intersection (0 for boxes of size >= 0): :func:`near_pairs_plain`
is its cull predicate, :func:`cull_radius` the radius it gives each box
(the proof that the cull is exact is in ``csrc/rotated_iou.cu``).

:func:`iou_bev_pairwise` is the registered op ``mmdet3d_torch::
rotated_iou``: the plain version on the CPU, the kernel on the card, shapes
only under tracing.
"""
from __future__ import annotations

import torch

from . import _cuda

_BIG = 1e9

# Cull radius R = CULL_REL * (half diagonal) + CULL_ABS + CULL_POS * (|cx| +
# |cy|); a box whose shorter side is not 0 but under THIN_REL * (half
# diagonal) + THIN_POS * (|cx| + |cy|) is near every box.  Powers of two,
# so an f32 product or sum with them rounds the same whether the constant
# is held as f32 (the kernel) or as a double (a PyTorch scalar).
CULL_REL = 1.0 + 2.0 ** -6
CULL_ABS = 2.0 ** -10
CULL_POS = 2.0 ** -17
THIN_REL = 2.0 ** -10
THIN_POS = 2.0 ** -16


def box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) (cx, cy, w, h, yaw) -> (..., 4, 2) CCW corners."""
    cx, cy, w, h, yaw = boxes.unbind(-1)
    c, s = torch.cos(yaw), torch.sin(yaw)
    hw, hh = 0.5 * w, 0.5 * h
    dx = torch.stack([-hw, hw, hw, -hw], dim=-1)
    dy = torch.stack([-hh, -hh, hh, hh], dim=-1)
    x = cx[..., None] + c[..., None] * dx - s[..., None] * dy
    y = cy[..., None] + s[..., None] * dx + c[..., None] * dy
    return torch.stack([x, y], dim=-1)


def _inside(px, py, box):
    """Points (..., K) inside broadcastable boxes (..., 1) given as a
    (cx, cy, w, h, cos, sin) tuple."""
    cx, cy, w, h, c, s = box
    dxv, dyv = px - cx, py - cy
    lx = c * dxv + s * dyv
    ly = -s * dxv + c * dyv
    return (lx.abs() <= 0.5 * w + 1e-5) & (ly.abs() <= 0.5 * h + 1e-5)


def _components(boxes):
    return (boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3],
            torch.cos(boxes[..., 4]), torch.sin(boxes[..., 4]))


def _iou_plain(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(P, N, 5) x (P, M, 5) -> (P, N, M): the kernel's arithmetic
    vectorized over every (problem, i, j) pair."""
    boxes_a, boxes_b = boxes_a.float(), boxes_b.float()
    inter = intersect_area_plain(boxes_a, boxes_b)
    area_a = (boxes_a[..., 2] * boxes_a[..., 3])[:, :, None]
    area_b = (boxes_b[..., 2] * boxes_b[..., 3])[:, None, :]
    inter = torch.minimum(torch.minimum(inter, area_a), area_b)
    return inter / (area_a + area_b - inter).clamp(min=1e-6)


def intersect_area_plain(boxes_a: torch.Tensor,
                         boxes_b: torch.Tensor) -> torch.Tensor:
    """(P, N, 5) x (P, M, 5) f32 -> (P, N, M) rotated intersection areas,
    before the clamp by the boxes' areas."""
    ca, cb = box_corners(boxes_a), box_corners(boxes_b)   # (P, ·, 4, 2)
    a = tuple(t[:, :, None, None] for t in _components(boxes_a))
    b = tuple(t[:, None, :, None] for t in _components(boxes_b))
    ax, ay = ca[:, :, None, :, 0], ca[:, :, None, :, 1]
    bx, by = cb[:, None, :, :, 0], cb[:, None, :, :, 1]
    shape = torch.broadcast_shapes(ax.shape, bx.shape)  # (P, N, M, 4)
    ax, ay, bx, by = (t.expand(shape) for t in (ax, ay, bx, by))
    in_b = _inside(ax, ay, b)
    in_a = _inside(bx, by, a)

    # edge i of A against edge j of B -> (P, K, K, 4, 4), A-edge major
    px, py = ax[..., :, None], ay[..., :, None]
    rx = (ax.roll(-1, -1) - ax)[..., :, None]
    ry = (ay.roll(-1, -1) - ay)[..., :, None]
    qx, qy = bx[..., None, :], by[..., None, :]
    sx = (bx.roll(-1, -1) - bx)[..., None, :]
    sy = (by.roll(-1, -1) - by)[..., None, :]
    rxs = rx * sy - ry * sx
    par = rxs.abs() < 1e-8
    safe = torch.where(par, 1.0, rxs)
    qpx, qpy = qx - px, qy - py
    t = (qpx * sy - qpy * sx) / safe
    u = (qpx * ry - qpy * rx) / safe
    ok_e = (~par & (t >= -1e-6) & (t <= 1 + 1e-6) & (u >= -1e-6)
            & (u <= 1 + 1e-6))
    ex, ey = px + t * rx, py + t * ry

    lead = shape[:-1]
    vx = torch.cat([ax, bx, ex.reshape(*lead, 16)], -1)  # (P, K, K, 24)
    vy = torch.cat([ay, by, ey.reshape(*lead, 16)], -1)
    ok = torch.cat([in_b, in_a, ok_e.reshape(*lead, 16)], -1)

    # Sums run slot by slot, in the kernel's order: the shoelace terms are
    # products of absolute coordinates that cancel, so the summation order
    # shows at ~1e-5 of IoU for boxes tens of metres from the origin.
    okf = ok.float()
    nvalid, sx, sy = (vx.new_zeros(lead) for _ in range(3))
    wx, wy = torch.where(ok, vx, 0.0), torch.where(ok, vy, 0.0)
    for k in range(24):
        nvalid = nvalid + okf[..., k]
        sx = sx + wx[..., k]
        sy = sy + wy[..., k]
    inv_n = 1.0 / nvalid.clamp(min=1.0)
    ctr_x, ctr_y = (sx * inv_n)[..., None], (sy * inv_n)[..., None]
    dx, dy = vx - ctr_x, vy - ctr_y
    p = 1.0 - dx / (dx.abs() + dy.abs() + 1e-12)
    key = torch.where(ok, torch.where(dy >= 0, p, -p), _BIG)
    key, order = torch.sort(key, dim=-1, stable=True)
    vx, vy = vx.gather(-1, order), vy.gather(-1, order)
    live = key < _BIG
    vx = torch.where(live, vx, vx[..., :1])
    vy = torch.where(live, vy, vy[..., :1])
    cross = vx * vy.roll(-1, -1) - vy * vx.roll(-1, -1)
    area2 = vx.new_zeros(lead)
    for k in range(24):
        area2 = area2 + cross[..., k]
    return torch.where(nvalid >= 3, 0.5 * area2.abs(), 0.0)


def iou_bev_pairwise_plain(boxes: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`iou_bev_pairwise`."""
    return _iou_plain(boxes, boxes)


def cull_radius(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) boxes -> (...,) f32 cull radius, the kernel's arithmetic:
    +inf for a thin box, NaN for a box with a non-finite field."""
    boxes = boxes.float()
    cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    hd = 0.5 * torch.sqrt(w * w + h * h)
    pos = cx.abs() + cy.abs()
    r = hd * CULL_REL + CULL_ABS + CULL_POS * pos
    side = torch.minimum(w.abs(), h.abs())
    thin = (side > 0) & (side < hd * THIN_REL + THIN_POS * pos)
    r = torch.where(thin, torch.inf, r)
    return torch.where(boxes.isfinite().all(-1), r, torch.nan)


def near_pairs_plain(boxes: torch.Tensor) -> torch.Tensor:
    """(P, K, 5) boxes -> (P, K, K) bool: the pairs the kernel computes in
    full.  Pair (i, j) is far iff d^2 > (R_i + R_j)^2 with d^2 finite (d the
    distance between the centres, R :func:`cull_radius`); a NaN anywhere
    makes the pair near."""
    r = cull_radius(boxes)
    cx, cy = boxes[..., 0].float(), boxes[..., 1].float()
    dx = cx[:, :, None] - cx[:, None, :]
    dy = cy[:, :, None] - cy[:, None, :]
    d2 = dx * dx + dy * dy
    s = r[:, :, None] + r[:, None, :]
    far = (d2 > s * s) & (d2 <= torch.finfo(torch.float32).max)
    return ~far


def _check_boxes(boxes):
    _cuda.check_tensor(boxes, 'boxes', torch.float32, (None, None, 5))


def _rotated_iou_cpu(boxes):
    _check_boxes(boxes)
    _cuda.same_device(boxes)
    return iou_bev_pairwise_plain(boxes)


def _rotated_iou_cuda(boxes):
    _check_boxes(boxes)
    dev = _cuda.same_device(boxes)
    p, k = boxes.shape[:2]
    out = torch.empty((p, k, k), dtype=torch.float32, device=dev)
    if out.numel():
        _cuda.launch('rotated_iou', dev, boxes.data_ptr(), out.data_ptr(),
                     p, k)
    return out


def _rotated_iou_fake(boxes):
    _check_boxes(boxes)
    p, k = boxes.shape[:2]
    return boxes.new_empty((p, k, k))


_ROTATED_IOU = _cuda.register_op(
    'rotated_iou(Tensor boxes) -> Tensor', _rotated_iou_cpu,
    _rotated_iou_cuda, _rotated_iou_fake)


def iou_bev_pairwise(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated BEV IoU within each of P problems.

    boxes (P, K, 5) f32 contiguous (cx, cy, w, h, yaw) -> (P, K, K) f32.
    Calls the registered op ``mmdet3d_torch::rotated_iou``."""
    return _ROTATED_IOU(boxes)


def iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 5) x (M, 5) -> (N, M) rotated BEV IoU, plain PyTorch (the
    predict path uses :func:`iou_bev_pairwise`)."""
    return _iou_plain(boxes1[None], boxes2[None])[0]


def iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor,
           z_offset: float = 0.5, eps: float = 1e-6) -> torch.Tensor:
    """Pairwise 3D IoU of 7-dim bottom-centred boxes, (N, 7) x (M, 7) ->
    (N, M), plain PyTorch as the JAX package computes it outside any
    kernel: the BEV intersection times the z overlap, clamped by both
    volumes.  Both sets span z + (z_offset -+ 0.5) dz.  ``torch.minimum``
    and ``maximum`` pass a NaN on, as ``jnp.minimum`` does."""
    b1, b2 = boxes1.float(), boxes2.float()
    bev1 = b1[:, [0, 1, 3, 4, 6]]
    bev2 = b2[:, [0, 1, 3, 4, 6]]
    inter_bev = intersect_area_plain(bev1[None], bev2[None])[0]
    z1lo = b1[:, 2] + (z_offset - 0.5) * b1[:, 5]
    z1hi = b1[:, 2] + (z_offset + 0.5) * b1[:, 5]
    z2lo = b2[:, 2] + (z_offset - 0.5) * b2[:, 5]
    z2hi = b2[:, 2] + (z_offset + 0.5) * b2[:, 5]
    zov = torch.maximum(torch.minimum(z1hi[:, None], z2hi[None, :])
                        - torch.maximum(z1lo[:, None], z2lo[None, :]),
                        z1lo.new_zeros(()))
    v1 = b1[:, 3] * b1[:, 4] * b1[:, 5]
    v2 = b2[:, 3] * b2[:, 4] * b2[:, 5]
    inter = torch.minimum(torch.minimum(inter_bev * zov, v1[:, None]),
                          v2[None, :])
    return inter / torch.maximum(v1[:, None] + v2[None, :] - inter,
                                 inter.new_tensor(eps))
