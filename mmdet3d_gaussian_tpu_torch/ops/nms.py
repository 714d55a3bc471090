"""Rotated and axis-aligned BEV NMS as fixed-size keep masks (kernel K6,
``csrc/nms_sweep.cu``).

Port of ``mmdet3d_gaussian_tpu/ops/nms.py`` (``nms_bev``,
``nms_normal_bev``, ``circle_nms``, ``_suppress_sweep``) and of the TPU
kernel ``ops/pallas/nms_kernel.py``.  Candidates arrive sorted by
descending score; a batch of P independent problems runs as one launch of
K5 (rotated only) and one of K6 (whose launcher enqueues its pack and its
sweep kernel).  :func:`suppress_sweep` is the registered op
``mmdet3d_torch::nms_sweep``: the plain version on the CPU, pack and sweep
on the card, shapes only under tracing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda
from .rotated_iou import iou_bev_pairwise

# The sweep stages whole 64-row blocks of the packed triangle in shared
# memory: the first holds 64 rows of ceil(K / 64) words, 192 KB at this K,
# beside the alive words, within a block's 227 KB; one warp's lanes hold
# the alive words, 12 a lane at this K.
_MAX_K = 24 * 1024


def suppress_sweep_plain(iou: torch.Tensor, valid: torch.Tensor,
                         thr: float) -> torch.Tensor:
    """Plain version of :func:`suppress_sweep`: the JAX ``fori_loop``."""
    k = iou.shape[-1]
    suppress = iou > thr
    later = torch.arange(k, device=iou.device)
    keep = valid.clone()
    for i in range(k):
        kill = suppress[:, i] & (later > i) & keep[:, i:i + 1]
        keep &= ~kill
    return keep


def _check_sweep(iou, valid):
    _cuda.check_tensor(iou, 'iou', torch.float32, (None, None, None))
    p, k = iou.shape[:2]
    if iou.shape[2] != k:
        raise ValueError(f'iou must be (P, K, K), got {tuple(iou.shape)}')
    _cuda.check_tensor(valid, 'valid', torch.bool, (p, k))
    if k > _MAX_K:
        raise ValueError(f'K={k} exceeds the sweep limit {_MAX_K}')


# K6, its pack and its sweep kernel, as one registered op
def _nms_sweep_cpu(iou, valid, thr):
    _check_sweep(iou, valid)
    _cuda.same_device(iou, valid)
    return suppress_sweep_plain(iou, valid, thr)


def _nms_sweep_cuda(iou, valid, thr):
    _check_sweep(iou, valid)
    dev = _cuda.same_device(iou, valid)
    p, k = iou.shape[:2]
    keep = torch.empty((p, k), dtype=torch.bool, device=dev)
    if keep.numel():
        words = torch.empty(p * packed_words(k), dtype=torch.int64,
                            device=dev)
        _cuda.launch('nms_sweep', dev, iou.data_ptr(), valid.data_ptr(),
                     keep.data_ptr(), words.data_ptr(), p, k, float(thr))
    return keep


def _nms_sweep_fake(iou, valid, thr):
    _check_sweep(iou, valid)
    return valid.new_empty(valid.shape)


_NMS_SWEEP = _cuda.register_op(
    'nms_sweep(Tensor iou, Tensor valid, float thr) -> Tensor',
    _nms_sweep_cpu, _nms_sweep_cuda, _nms_sweep_fake)


def suppress_sweep(iou: torch.Tensor, valid: torch.Tensor,
                   thr: float) -> torch.Tensor:
    """Greedy score-order suppression of P problems -> keep (P, K) bool.

    iou (P, K, K) f32 contiguous, rows/cols in descending score order;
    valid (P, K) bool.  keep starts as valid; row i clears every later
    column with IoU > thr while row i is still kept (invalid rows never
    suppress).  Calls the registered op ``mmdet3d_torch::nms_sweep``."""
    return _NMS_SWEEP(iou, valid, float(thr))


def packed_words(k: int) -> int:
    """64-bit words of one problem's packed suppression triangle in the
    kernel's workspace: row block b (rows 64 b .. 64 b + 63) keeps words
    b .. W-1 of each row, W = ceil(k / 64)."""
    w = -(-k // 64)
    return 32 * w * (w + 1)


def nms_bev(boxes: torch.Tensor, thr: float,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotated-BEV NMS of P problems.

    boxes (P, K, 5) (cx, cy, w, h, yaw), each problem sorted by descending
    score; valid (P, K) bool pre-mask.  Returns the keep mask (P, K)."""
    if valid is None:
        valid = torch.ones(boxes.shape[:2], dtype=torch.bool,
                           device=boxes.device)
    iou = iou_bev_pairwise(boxes.float().contiguous())
    return suppress_sweep(iou, valid.contiguous(), thr)


def aligned_iou_bev(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of the axis-aligned BEV rectangles that bound rotated
    boxes: (P, K, 5) (cx, cy, w, h, yaw) -> (P, K, K) f32, elementwise in
    f32 as the JAX ``nms_normal_bev`` writes it (union floored at 1e-6)."""
    boxes = boxes.float()
    cx, cy, w, h, yaw = boxes.unbind(-1)
    c, s = torch.cos(yaw).abs(), torch.sin(yaw).abs()
    hw = 0.5 * (w * c + h * s)
    hh = 0.5 * (w * s + h * c)
    x1, x2 = cx - hw, cx + hw
    y1, y2 = cy - hh, cy + hh
    area = (x2 - x1) * (y2 - y1)
    lt_x = torch.maximum(x1[..., :, None], x1[..., None, :])
    lt_y = torch.maximum(y1[..., :, None], y1[..., None, :])
    rb_x = torch.minimum(x2[..., :, None], x2[..., None, :])
    rb_y = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (rb_x - lt_x).clamp(min=0) * (rb_y - lt_y).clamp(min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp(min=1e-6)


def nms_normal_bev(boxes: torch.Tensor, thr: float,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Axis-aligned NMS of P problems on the BEV bounding rectangles of
    rotated boxes (:func:`aligned_iou_bev`), through K6.  Arguments and
    result as :func:`nms_bev`."""
    if valid is None:
        valid = torch.ones(boxes.shape[:2], dtype=torch.bool,
                           device=boxes.device)
    iou = aligned_iou_bev(boxes).contiguous()
    return suppress_sweep(iou, valid.contiguous(), thr)


def circle_nms(centers: torch.Tensor, min_radius: float,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CenterPoint circle NMS of P problems through K6: centers (P, K, 2)
    BEV (x, y), each problem sorted by descending score; valid (P, K) bool.
    -> keep (P, K).  As mmdet3d's ``circle_nms`` (and the JAX package), a
    later centre is suppressed when its *squared* distance is under the
    config's ``min_radius``, which is not squared: the sweep runs on -d^2
    with threshold -min_radius."""
    if valid is None:
        valid = torch.ones(centers.shape[:2], dtype=torch.bool,
                           device=centers.device)
    c = centers.float()
    d2 = ((c[..., :, None, :] - c[..., None, :, :]) ** 2).sum(-1)
    return suppress_sweep((-d2).contiguous(), valid.contiguous(),
                          -float(min_radius))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim with ``lax.top_k``'s order: descending,
    ties broken by the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
