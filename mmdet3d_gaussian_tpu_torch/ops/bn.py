"""Training-mode BatchNorm statistics (kernel K4, ``csrc/bn_moments.cu``).

Port of ``mmdet3d_gaussian_tpu/ops/pallas/bn_kernel.py``:

* :func:`moments` -> per-channel (sum x, sum x^2), one read of x;
* :func:`grad_moments` -> per-channel (sum g, sum g * xhat),
  ``xhat = (x - mean) * inv``, one read of (g, x);
* :func:`bn_train`, a ``torch.autograd.Function`` around them with the JAX
  package's formulas: ``var = max(sum x^2 / M - mean^2, 0)`` (biased),
  ``y = (x - mean) * (inv * scale) + bias``, and the backward
  ``dx = inv * scale * (g - sum g / M - xhat * sum(g xhat) / M)``.

Activations are read in the layout they arrive in: an ``(M, C)`` matrix, or
an NCHW tensor in either memory format (channels-last rows or per-channel
planes), described to the kernel by three element strides
(:func:`_layout`), so no copy is made around a BatchNorm.  They are f32, or
bf16 in the mixed-precision model (``FastBatchNorm(dtype='bfloat16')``):
the sums are f32 either way, and ``bn_train``'s output has the input's
type, computed in f32 and rounded once, as the JAX module's.  Each wrapper
computes its plain PyTorch version for CPU tensors and launches the kernel
for CUDA tensors; there is no fallback between the two.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda


def _channels_last_2d(x: torch.Tensor) -> torch.Tensor:
    """(M, C) or (B, C, H, W) -> (rows, C) with channels last (a view when
    the memory format allows, else a permuted copy)."""
    if x.dim() == 2:
        return x
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def moments_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`moments`."""
    x2 = _channels_last_2d(x).float()
    return x2.sum(0), (x2 * x2).sum(0)


def grad_moments_plain(g, x, mean, inv):
    """Plain version of :func:`grad_moments`."""
    g2 = _channels_last_2d(g).float()
    xhat = (_channels_last_2d(x).float() - mean) * inv
    return g2.sum(0), (g2 * xhat).sum(0)


def _layout(x: torch.Tensor):
    """(rows, C, S, row strides (batch, spatial), channel stride) of an
    (M, C) or (B, C, H, W) f32 or bf16 tensor: element (row r, channel c)
    sits at ``(r // S) * sb + (r % S) * ss + c * sc``.  Raises for a layout
    that three strides cannot describe."""
    if x.dtype not in _cuda.FLOAT_TYPES:
        raise TypeError(f'x must be float32 or bfloat16, got {x.dtype}')
    if x.dim() == 2:
        m, c = x.shape
        return m, c, m, 0, x.stride(0), x.stride(1)
    if x.dim() != 4:
        raise ValueError(f'x must be (M, C) or (B, C, H, W), got '
                         f'{tuple(x.shape)}')
    b, c, h, w = x.shape
    sb, sc, sh, sw = x.stride()
    if h > 1 and w > 1 and sh != w * sw:
        raise ValueError('x layout: H and W strides do not merge')
    ss = sw if w > 1 else sh
    s = h * w
    if sb == s * ss:        # batch and spatial merge into one row stride
        return b * s, c, b * s, 0, ss, sc
    return b * s, c, s, sb, ss, sc


def moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (sum x, sum x^2), each (C,) f32.

    x: (M, C) or (B, C, H, W) f32 or bf16 in any layout :func:`_layout`
    accepts."""
    lay = _layout(x)
    dev = _cuda.same_device(x)
    if dev.type == 'cpu':
        return moments_plain(x)
    c = lay[1]
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    if lay[0] == 0:
        return out.zero_()[0], out[1]
    parts = torch.empty((_cuda_partials(lay), 2, c), dtype=torch.float32,
                        device=dev)
    _cuda.launch('bn_moments', dev, x.data_ptr(), *lay, parts.data_ptr(),
                 parts.shape[0], out.data_ptr(), _is_bf16(x))
    return out[0], out[1]


def grad_moments(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                 inv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (sum g, sum g * (x - mean) * inv), each (C,) f32.

    g, x: the same shape and type (f32 or bf16), each in any layout
    :func:`_layout` accepts (they may differ: each gets its own strides,
    and rows are read in x's order); mean, inv: (C,) f32 contiguous."""
    if g.shape != x.shape:
        raise ValueError(f'g {tuple(g.shape)} and x {tuple(x.shape)} differ')
    if g.dtype != x.dtype:
        raise TypeError(f'g {g.dtype} and x {x.dtype} differ')
    lay_x, lay_g = _layout(x), _layout(g)
    c = lay_x[1]
    _cuda.check_tensor(mean, 'mean', torch.float32, (c,))
    _cuda.check_tensor(inv, 'inv', torch.float32, (c,))
    dev = _cuda.same_device(g, x, mean, inv)
    if dev.type == 'cpu':
        return grad_moments_plain(g, x, mean, inv)
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    if lay_x[0] == 0:
        return out.zero_()[0], out[1]
    parts = torch.empty((_cuda_partials(lay_x), 2, c), dtype=torch.float32,
                        device=dev)
    _cuda.launch('bn_grad_moments', dev, g.data_ptr(), x.data_ptr(),
                 mean.data_ptr(), inv.data_ptr(), *lay_x, *lay_g[2:],
                 parts.data_ptr(), parts.shape[0], out.data_ptr(),
                 _is_bf16(x))
    return out[0], out[1]


def _is_bf16(x: torch.Tensor) -> int:
    return int(x.dtype == torch.bfloat16)


# partial sums per channel: row blocks the first pass writes (a function of
# the shape only, so the reduction order, and the result, are reproducible)
_TARGET_PARTIALS = 512


def _cuda_partials(lay) -> int:
    rows = lay[0]
    return max(1, min(_TARGET_PARTIALS, rows // 64))


def _channel_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.view(1, -1, 1, 1) if ndim == 4 else t


class BNTrain(torch.autograd.Function):
    """``bn_train(x, scale, bias, eps) -> (y, mean, var)``; mean and var
    (biased) carry no gradient (they feed the running statistics)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        su, sq = moments(x)
        cnt = float(x.numel() // x.shape[1])
        mean = su / cnt
        var = torch.clamp_min(sq / cnt - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        k = _channel_view(inv * scale, x.dim())
        y = ((x.float() - _channel_view(mean, x.dim())) * k + _channel_view(
            bias, x.dim())).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.cnt = cnt
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, scale, mean, inv = ctx.saved_tensors
        sg, sgx = grad_moments(gy, x, mean, inv)
        cnt = ctx.cnt
        nd = x.dim()
        xhat = (x.float() - _channel_view(mean, nd)) * _channel_view(inv, nd)
        dx = _channel_view(inv * scale, nd) * (
            gy.float() - _channel_view(sg / cnt, nd)
            - xhat * _channel_view(sgx / cnt, nd))
        return dx.to(x.dtype), sgx, sg, None


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float):
    """Training-mode BN over the channel dim 1 of an (M, C) or (B, C, H, W)
    f32 or bf16 tensor -> (y of x's type, batch mean, batch biased var, both
    f32)."""
    return BNTrain.apply(x, scale, bias, eps)
