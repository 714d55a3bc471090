"""Rotated BEV NMS as fixed-size keep masks (kernel K6,
``csrc/nms_sweep.cu``).

Port of ``mmdet3d_gaussian_tpu/ops/nms.py`` (``nms_bev``,
``_suppress_sweep``) and of the TPU kernel ``ops/pallas/nms_kernel.py``.
Candidates arrive sorted by descending score; a batch of P independent
problems runs as one launch of each kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .rotated_iou import iou_bev_pairwise

_MAX_K = 24 * 1024   # the sweep keeps a K-byte mask + one staged K-row in
                     # 48 KB of shared memory


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


def suppress_sweep(iou: torch.Tensor, valid: torch.Tensor,
                   thr: float) -> torch.Tensor:
    """Greedy score-order suppression of P problems -> keep (P, K) bool.

    iou (P, K, K) f32 contiguous, rows/cols in descending score order;
    valid (P, K) bool.  keep starts as valid; row i clears every later
    column with IoU > thr while row i is still kept (invalid rows never
    suppress)."""
    _cuda.check_tensor(iou, 'iou', torch.float32, (None, None, None))
    p, k = iou.shape[:2]
    if iou.shape[2] != k:
        raise ValueError(f'iou must be (P, K, K), got {tuple(iou.shape)}')
    _cuda.check_tensor(valid, 'valid', torch.bool, (p, k))
    if k > _MAX_K:
        raise ValueError(f'K={k} exceeds the sweep limit {_MAX_K}')
    dev = _cuda.same_device(iou, valid)
    if dev.type == 'cpu':
        return suppress_sweep_plain(iou, valid, thr)
    keep = torch.empty((p, k), dtype=torch.bool, device=dev)
    if keep.numel():
        _cuda.launch('nms_sweep', dev, iou.data_ptr(), valid.data_ptr(),
                     keep.data_ptr(), p, k, float(thr))
    return keep


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
