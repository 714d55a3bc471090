"""Layers of the reference: convolutions and linear layers that can run
as the lower-precision control, and the BatchNorms of the two trunks.

``lowp`` on a layer (set for a whole model by :func:`set_lowp`) computes
the product as TF32 does: inputs and weights rounded to TF32's 10-bit
mantissa, sums in f32.  On the card the control instead turns
``torch.backends``' TF32 switches on (:func:`precision`); the rounding is
what the CPU tests of the control use, where TF32 does not exist."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to nearest on TF32's 10-bit mantissa; the
    gradient passes through unrounded."""
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32).view(x.shape)
    return x + (r - x).detach()


class _Lowp:
    lowp = False

    def _in(self, x, w):
        if self.lowp:
            return tf32_round(x), tf32_round(w)
        return x, w


class Conv2d(_Lowp, nn.Conv2d):
    def forward(self, x):
        x, w = self._in(x, self.weight)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


class ConvTranspose2d(_Lowp, nn.ConvTranspose2d):
    def forward(self, x):
        x, w = self._in(x, self.weight)
        return F.conv_transpose2d(x, w, None, self.stride)


class Linear(_Lowp, nn.Linear):
    def forward(self, x):
        x, w = self._in(x, self.weight)
        return F.linear(x, w)


def set_lowp(model: nn.Module, on: bool) -> None:
    """Round every product of ``model`` as TF32 does (CPU control)."""
    for m in model.modules():
        if isinstance(m, _Lowp):
            m.lowp = on


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on or off for cuBLAS and cuDNN inside the block."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW maps: batch statistics (biased variance) in
    training, the running ones in eval; eps 1e-3."""

    def __init__(self, c):
        super().__init__(c, eps=BN_EPS)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]


class RowBatchNorm(nn.Module):
    """BatchNorm over the last dim of point rows, statistics over the rows
    where ``mask`` is set (at least one), eps 1e-3."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))

    def forward(self, x, mask, training: bool):
        if training:
            m = mask.reshape(-1).to(x.dtype)
            rows = x.reshape(-1, x.shape[-1])
            cnt = m.sum().clamp(min=1.0)
            mean = (rows * m[:, None]).sum(0) / cnt
            var = (((rows - mean) ** 2) * m[:, None]).sum(0) / cnt
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.weight) \
            + self.bias


def conv_bn_relu(cin, cout, k=3, stride=1, padding=1):
    return [Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False),
            BatchNorm2d(cout), nn.ReLU()]


class SECOND(nn.Module):
    """Stage i: a strided 3x3 conv-BN-ReLU, then ``layer_nums[i]`` more;
    one NCHW map a stage."""

    def __init__(self, in_channels, out_channels, layer_nums, layer_strides):
        super().__init__()
        blocks, cin = [], in_channels
        for ch, num, stride in zip(out_channels, layer_nums, layer_strides):
            layers = conv_bn_relu(cin, ch, stride=stride)
            for _ in range(num):
                layers += conv_bn_relu(ch, ch)
            blocks.append(nn.Sequential(*layers))
            cin = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        outs = []
        for block in self.blocks:
            x = block(x)
            outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    """Per level: a transposed conv (kernel = stride) for a stride over 1,
    a 1x1 conv for 1, a k x k conv at stride k for 1/k; BN, ReLU."""

    def __init__(self, in_channels, out_channels, upsample_strides):
        super().__init__()
        deblocks = []
        for cin, ch, s in zip(in_channels, out_channels, upsample_strides):
            if s > 1:
                up = ConvTranspose2d(cin, ch, int(s), stride=int(s),
                                     bias=False)
            else:
                k = max(1, int(round(1 / s)))
                up = Conv2d(cin, ch, k, stride=k, padding=0, bias=False)
            deblocks.append(nn.Sequential(up, BatchNorm2d(ch), nn.ReLU()))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, feats):
        return torch.cat([b(x) for b, x in zip(self.deblocks, feats)], 1)
