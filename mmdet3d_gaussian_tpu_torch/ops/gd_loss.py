"""Fused anchor-head decoded-box GD loss (kernel K3, ``csrc/gd_loss.cu``).

Port of ``mmdet3d_gaussian_tpu/ops/pallas/gd_loss_kernel.py::
anchor_gd_loss_pallas``: decode the pred and target deltas against the
anchors, replace pred by target where the weight is <= 0, take the
``BAG_GD_LOSS[loss_type]`` distance with ``postprocess(fun, tau)``, and
return ``sum(loss * weight)`` (divide by ``avg_factor`` outside).  The
gradient is d(pred) in the conv layout ``(M, A*7)``.  The kernels read an
anchor's pred, target and anchor only where its weight is not 0: an anchor
of weight 0 adds ``0 * loss(target, target)``, 0 for any finite target.
The forward is one launch (weights read as float4, the partial sums added
in order by the last block, so repeated calls agree bitwise); the backward
writes the rows of the anchors with weight > 0 and fills the rest of its
output with zeros in 16-byte stores.

* :func:`gd_loss_fwd` / :func:`gd_loss_bwd`: the kernel wrappers (plain
  PyTorch versions for CPU tensors, the kernels for CUDA tensors, no
  fallback between the two);
* :func:`anchor_gd_loss`: the differentiable entry, a
  ``torch.autograd.Function`` whose forward and backward are the two
  wrappers.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..core.bbox.coders import DeltaXYZWLHRBBoxCoder
from ..models.losses.gaussian import BAG_GD_LOSS, GDLoss
from . import _cuda

# codes passed to the kernel: the order of enum LossType / Fun in
# csrc/gd_loss.cu
LOSS_TYPES = tuple(BAG_GD_LOSS)
FUNS = ('none', 'log1p', 'expm1', 'nlog')

# (loss_type, center_offset, fun, tau, alpha), as the JAX kernel's cfg
Config = Tuple[str, Sequence[float], str, float, float]

_THREADS = 256
# the forward's blocks: one for every 16 weight quads a thread (4 loads of
# 4 in flight), at most 4 a streaming multiprocessor; fixed by the shape
# alone, so the sum's order is too
_FWD_ANCHORS_PER_BLOCK = 16 * _THREADS
_FWD_MAX_BLOCKS = 528


def anchor_gd_loss_plain(pred2, tgt2, w_a, anc2, hw: int, cfg: Config):
    """Plain version: ``GDLoss``'s component-plane path on decoded parts,
    reduction 'sum' (differentiable with autograd)."""
    loss_type, center_offset, fun, tau, alpha = cfg
    m, k7 = pred2.shape
    a = k7 // 7
    anc = anc2.reshape(hw, a, 7).repeat(m // hw, 1, 1).unbind(-1)
    coder = DeltaXYZWLHRBBoxCoder()
    dec_p = coder.decode_parts(anc, pred2.float().reshape(m, a, 7).unbind(-1))
    dec_t = coder.decode_parts(anc, tgt2.reshape(m, a, 7).unbind(-1))
    gd = GDLoss(loss_type, center_offset=center_offset, fun=fun, tau=tau,
                alpha=alpha, reduction='sum')
    return gd(dec_p, dec_t, weight=w_a)


def gd_loss_bwd_plain(gout, pred2, tgt2, w_a, anc2, hw: int, cfg: Config):
    """Plain version of :func:`gd_loss_bwd`: autograd through
    :func:`anchor_gd_loss_plain`."""
    with torch.enable_grad():
        p = pred2.detach().requires_grad_(True)
        val = anchor_gd_loss_plain(p, tgt2, w_a, anc2, hw, cfg)
        (grad,) = torch.autograd.grad(val, p)
    return (grad * gout).contiguous()


def _pred_rows(pred2: torch.Tensor) -> int:
    """Row stride of ``pred2`` (M, A*7) f32 with unit column stride (a
    channel slice of the conv output is read in place)."""
    if pred2.dtype != torch.float32 or pred2.dim() != 2:
        raise TypeError(f'pred2 must be a 2-D float32 tensor, got '
                        f'{pred2.dtype} {tuple(pred2.shape)}')
    if pred2.stride(1) != 1 or pred2.stride(0) < pred2.shape[1]:
        raise ValueError('pred2 must have unit column stride and rows that '
                         'do not overlap')
    return pred2.stride(0)


def _check(pred2, tgt2, w_a, anc2, hw, cfg):
    m, k7 = pred2.shape
    if k7 % 7 or hw <= 0 or m % hw:
        raise ValueError(f'pred2 {tuple(pred2.shape)} is not (B*HW, A*7) '
                         f'for HW={hw}')
    a = k7 // 7
    rs = _pred_rows(pred2)
    _cuda.check_tensor(tgt2, 'tgt2', torch.float32, (m, k7))
    _cuda.check_tensor(w_a, 'w_a', torch.float32, (m, a))
    _cuda.check_tensor(anc2, 'anc2', torch.float32, (hw, k7))
    loss_type, center_offset, fun, tau, alpha = cfg
    if loss_type not in LOSS_TYPES or fun not in FUNS:
        raise ValueError(f'unsupported GD config {cfg!r}')
    off = [float(v) for v in center_offset]
    return rs, a, [LOSS_TYPES.index(loss_type), FUNS.index(fun), float(tau),
                   float(alpha)] + off


def gd_loss_fwd(pred2, tgt2, w_a, anc2, hw: int, cfg: Config):
    """``sum(loss * w)`` as a 0-d f32 tensor.

    pred2 (M, A*7) f32 with unit column stride (any row stride); tgt2
    (M, A*7), w_a (M, A), anc2 (HW, A*7) f32 contiguous; M = B*HW."""
    rs, a, cargs = _check(pred2, tgt2, w_a, anc2, hw, cfg)
    dev = _cuda.same_device(pred2, tgt2, w_a, anc2)
    if dev.type == 'cpu':
        return anchor_gd_loss_plain(pred2, tgt2, w_a, anc2, hw, cfg)
    m = pred2.shape[0]
    parts_n = max(1, min(_FWD_MAX_BLOCKS,
                         -(-m * a // _FWD_ANCHORS_PER_BLOCK)))
    parts = torch.empty((parts_n,), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _cuda.launch('gd_loss_fwd', dev, pred2.data_ptr(), rs, tgt2.data_ptr(),
                 w_a.data_ptr(), anc2.data_ptr(), m, a, hw, *cargs,
                 parts.data_ptr(), parts_n, _ticket(dev, stream).data_ptr(),
                 out.data_ptr(), stream=stream)
    return out


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    """The zeroed counter the forward's blocks draw tickets from, one per
    device and stream; the block drawing the last ticket sets it back to
    0."""
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return t


_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def gd_loss_bwd(gout, pred2, tgt2, w_a, anc2, hw: int, cfg: Config):
    """``gout * d sum(loss * w) / d pred2`` as an (M, A*7) f32 contiguous
    tensor; gout is a 0-d f32 tensor (read on the device, no sync)."""
    rs, a, cargs = _check(pred2, tgt2, w_a, anc2, hw, cfg)
    dev = _cuda.same_device(gout, pred2, tgt2, w_a, anc2)
    if dev.type == 'cpu':
        return gd_loss_bwd_plain(gout, pred2, tgt2, w_a, anc2, hw, cfg)
    _cuda.check_tensor(gout.reshape(()), 'gout', torch.float32, ())
    gout = gout.reshape(()).contiguous()
    dpred = torch.empty(pred2.shape, dtype=torch.float32, device=dev)
    if dpred.numel():
        _cuda.launch('gd_loss_bwd', dev, gout.data_ptr(), pred2.data_ptr(),
                     rs, tgt2.data_ptr(), w_a.data_ptr(), anc2.data_ptr(),
                     pred2.shape[0], a, hw, *cargs, dpred.data_ptr())
    return dpred


class _AnchorGDLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred2, tgt2, w_a, anc2, hw, cfg):
        ctx.save_for_backward(pred2, tgt2, w_a, anc2)
        ctx.hw, ctx.cfg = hw, cfg
        return gd_loss_fwd(pred2, tgt2, w_a, anc2, hw, cfg)

    @staticmethod
    def backward(ctx, g):
        pred2, tgt2, w_a, anc2 = ctx.saved_tensors
        dpred = gd_loss_bwd(g.float(), pred2, tgt2, w_a, anc2, ctx.hw,
                            ctx.cfg)
        return dpred, None, None, None, None, None


def anchor_gd_loss(pred2, tgt2, w_a, anc2, hw: int, cfg: Config):
    """Differentiable (in ``pred2``) fused decoded-box GD loss sum; see
    :func:`gd_loss_fwd` for the arguments."""
    return _AnchorGDLoss.apply(pred2, tgt2, w_a, anc2, hw, cfg)
