"""SECOND backbone and SECONDFPN neck as plain PyTorch convolutions.

Port of ``mmdet3d_gaussian_tpu/models/backbones.py`` (``ConvBNReLU``,
``_S2DDownConv``, ``SECOND``, ``SECONDFPN``).  Of its TPU layout rewrites,
the space-to-depth canvas is ported: with ``input_s2d`` the stage-0 stride-2
conv reads the ``(B, H/2, W/2, 4C)`` canvas of ``ops/voxelize.py::
bev_scatter_s2d`` through the folded 2 x 2 kernel (:func:`fold_s2d_kernel`),
the same function as the 3 x 3 stride-2 conv on the plain canvas.  The
neck's transposed convs run as the JAX package's default lowering, a matmul
and a depth-to-space reshape (:class:`ConvTranspose2d`).  The others (the
W-folded stage 0, H-chunk halos, the stride-1 neck conv as a matmul) are
exact rewrites of the plain ops written here.  Module
names follow mmdet3d's state_dict (``backbone.blocks.{s}.{j}``,
``neck.deblocks.{i}.{0,1}``), the same with the s2d canvas on or off;
BatchNorm eps 1e-3.

``dtype='bfloat16'`` is the JAX package's mixed precision: parameters stay
f32 and are cast to bf16 where a conv uses them, activations are bf16
between layers, and BatchNorm takes its statistics in f32 and rounds its
output to bf16 (:class:`BatchNorm2d`).

:class:`BatchNorm2d` is the port of ``FastBatchNorm``
(``ops/pallas/bn_kernel.py``): in training its statistics come from kernel
K4 (:func:`~mmdet3d_gaussian_tpu_torch.ops.bn.bn_train`) and the running
statistics move as the JAX module's, ``0.99 old + 0.01 batch`` with the
biased batch variance.

Public layout is the JAX package's NHWC; inside, tensors are NCHW views of
channels-last memory, so the NHWC <-> NCHW permutes are free.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn import bn_train
from ..registry import MODELS

MOMENTUM = 0.99   # flax convention: running = MOMENTUM * running + rest


def compute_dtype(name: Optional[Union[str, torch.dtype]]
                  ) -> Optional[torch.dtype]:
    """None (f32 throughout) or ``torch.bfloat16`` from a JAX config's
    ``dtype`` / ``compute_dtype`` entry."""
    if name is None or name in ('float32', torch.float32):
        return None
    if name in ('bfloat16', torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f'compute dtype {name!r} is not supported')


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and state_dict keys)
    whose training mode is the JAX package's ``FastBatchNorm``: batch
    statistics from K4 (no cuDNN), biased variance in the running update.
    Eval uses the running statistics.  The output has the input's type; a
    bf16 input is normalized in f32 with ``FastBatchNorm``'s formula and
    rounded once, in training and in eval.

    ``promote=True`` is flax's ``nn.BatchNorm`` with no dtype instead (the
    image branch of MVX): the same formula, its output left f32 whatever
    the input's type (the result type of the input and the f32
    parameters).

    ``group`` (a ``parallel.mesh.Group``, set by the detector of a
    data-parallel step; None by default): the training statistics are
    those of every rank's rows (SyncBN)."""

    def __init__(self, *args, promote: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.promote = promote
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = torch.float32 if self.promote else x.dtype
        if not self.training:
            if x.dtype == torch.float32:
                return super().forward(x)
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x.float() - self.running_mean[:, None, None])
                    * inv[:, None, None]
                    + self.bias[:, None, None]).to(out_dtype)
        y, mean, var = bn_train(x, self.weight, self.bias, self.eps,
                                out_dtype, self.group)
        with torch.no_grad():
            self.running_mean.mul_(MOMENTUM).add_(mean, alpha=1 - MOMENTUM)
            self.running_var.mul_(MOMENTUM).add_(var, alpha=1 - MOMENTUM)
            self.num_batches_tracked.add_(1)
        return y


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (None: the parameters'
    f32): input and weights cast where they are used.  In a compute dtype
    the bias (if any) is cast too and added to the rounded convolution, as
    the JAX package's ``nn.Conv`` adds it."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def _cast(self, x, w):
        if self.compute_dtype is None:
            return x, w
        return x.to(self.compute_dtype), w.to(self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = self._cast(x, self.weight)
        if self.bias is None or self.compute_dtype is None:
            return self._conv_forward(x, w, self.bias)
        return (self._conv_forward(x, w, None)
                + self.bias.to(self.compute_dtype)[:, None, None])


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (kernel = stride, no bias, no output padding)
    computing in ``compute_dtype``.

    It runs as the JAX package's default lowering of this layer (``'d2s'``):
    a kernel = stride transposed conv has no overlapping taps, so it is one
    matmul of each pixel's channels to ``Cout * s * s`` outputs and a
    depth-to-space reshape, rounded once per output as the conv would be.
    (PyTorch's CPU bf16 ``conv_transpose2d`` returns a wrong input gradient
    at the TINY model's stride-4 level, 64 -> 16 channels on an 8 x 8 map;
    ``tests/test_torch_bf16.py`` prints how far.)  The output is NCHW in
    channels-last memory."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        b, cin, h, wd = x.shape
        cout, s = w.shape[1], w.shape[2]
        dt = self.compute_dtype or w.dtype
        y = torch.matmul(nchw_to_nhwc(x).to(dt), w.reshape(cin, -1).to(dt))
        y = y.view(b, h, wd, cout, s, s).permute(0, 1, 4, 2, 5, 3)
        return nhwc_to_nchw(y.reshape(b, h * s, wd * s, cout))


def fold_s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """Fold a ``(Cout, Cin, 3, 3)`` stride-2 kernel for a space-to-depth
    input -> ``(Cout, 4 Cin, 2, 2)``.

    A 3 x 3 / stride-2 / pad-1 conv on (H, W, Cin) equals a 2 x 2 /
    stride-1 conv with padding (1, 0) in H and W on the s2d input (H/2, W/2,
    4 Cin): output row h reads input rows 2h-1, 2h, 2h+1, which are s2d
    blocks h-1 (parity 1), h (parity 0) and h (parity 1), so tap dy maps to
    (block, parity) = (0, 1) if dy == 0 else (1, dy - 1), the same along W.
    Input channels come in blocks of Cin by parity ``py * 2 + px``, as
    ``bev_scatter_s2d`` writes them.  A pure placement, differentiable in
    ``w``, so training learns the 3 x 3 kernel."""
    cout, cin, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f'fold_s2d_kernel needs a 3x3 kernel, got {kh}x{kw}')
    taps = [(0, 1), (1, 0), (1, 1)]      # dy or dx -> (block, parity)
    folded = w.new_zeros((cout, 4, cin, 2, 2))
    for dy, (bh, py) in enumerate(taps):
        for dx, (bw, px) in enumerate(taps):
            folded[:, py * 2 + px, :, bh, bw] = w[:, :, dy, dx]
    return folded.reshape(cout, 4 * cin, 2, 2)


class S2DDownConv(Conv2d):
    """The stride-2 3 x 3 stage-0 conv (same ``weight``, so the same
    state_dict as the plain conv) applied to an s2d canvas: pad (1, 0) in H
    and W, then the folded 2 x 2 kernel at stride 1."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = self._cast(x, fold_s2d_kernel(self.weight))
        return F.conv2d(F.pad(x, (1, 0, 1, 0)), w)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv_bn_relu(cin: int, cout: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 conv: type = Conv2d) -> List[nn.Module]:
    """3x3 conv (pad 1, no bias) -> BatchNorm(eps 1e-3) -> ReLU."""
    return [conv(cin, cout, 3, stride=stride, padding=1, bias=False,
                 compute_dtype=dtype),
            BatchNorm2d(cout, eps=1e-3), nn.ReLU()]


@MODELS.register_module()
class SECOND(nn.Module):
    """Stage i: strided ConvBNReLU then ``layer_nums[i]`` ConvBNReLU; one
    NHWC feature map per stage.

    ``input_s2d``: the input is the s2d canvas ``(B, H/2, W/2,
    4 in_channels)`` and stage 0 (stride 2) reads it through the folded
    kernel.  ``fold_w2`` (the JAX package's W-folded stage 0 after an s2d
    input) is accepted and computes the same function through the plain
    stage 0."""

    def __init__(self, in_channels: int = 64,
                 out_channels: Sequence[int] = (64, 128, 256),
                 layer_nums: Sequence[int] = (3, 5, 5),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 input_s2d: bool = False, fold_w2: bool = False,
                 dtype: Optional[Union[str, torch.dtype]] = None):
        super().__init__()
        self.layer_strides = tuple(layer_strides)
        self.input_s2d = input_s2d
        dt = compute_dtype(dtype)
        if input_s2d and self.layer_strides[0] != 2:
            raise ValueError('input_s2d needs a stride-2 stage 0, got '
                             f'{self.layer_strides[0]}')
        blocks = []
        cin = in_channels
        for i, (ch, num, stride) in enumerate(zip(out_channels, layer_nums,
                                                  layer_strides)):
            layers = conv_bn_relu(
                cin, ch, stride, dt,
                S2DDownConv if i == 0 and input_s2d else Conv2d)
            for _ in range(num):
                layers += conv_bn_relu(ch, ch, dtype=dt)
            blocks.append(nn.Sequential(*layers))
            cin = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: NHWC canvas (the s2d canvas with ``input_s2d``) -> list of
        NHWC maps."""
        x = nhwc_to_nchw(x)
        outs = []
        for i, (block, stride) in enumerate(zip(self.blocks,
                                                self.layer_strides)):
            if not (i == 0 and self.input_s2d) and (
                    x.shape[2] % stride or x.shape[3] % stride):
                raise ValueError(
                    f'SECOND stage {i}: spatial dims {tuple(x.shape[2:])} '
                    f'not divisible by stride {stride}')
            x = block(x)
            outs.append(nchw_to_nhwc(x))
        return outs


@MODELS.register_module()
class SECONDFPN(nn.Module):
    """Per level: ConvTranspose(k = stride) for stride > 1, a 1x1 conv for
    stride 1, or for a fractional stride 1/k a k x k conv at stride k (the
    nuScenes configs' 0.5), then BN and ReLU; levels concatenated on
    channels (or
    returned as a tuple with ``concat_out=False``).  The transposed conv is
    always the JAX package's ``'d2s'`` form (matmul + depth-to-space);
    ``deconv_impl`` (None, ``'d2s'`` or ``'convt'``) is accepted so that a
    JAX config builds, and has no effect."""

    def __init__(self, in_channels: Sequence[int] = (64, 128, 256),
                 out_channels: Sequence[int] = (128, 128, 128),
                 upsample_strides: Sequence[float] = (1, 2, 4),
                 concat_out: bool = True,
                 deconv_impl: Optional[str] = None,
                 dtype: Optional[Union[str, torch.dtype]] = None):
        super().__init__()
        if deconv_impl not in (None, 'd2s', 'convt'):
            raise ValueError(f'deconv_impl must be None, d2s or convt, got '
                             f'{deconv_impl!r}')
        self.concat_out = concat_out
        self.upsample_strides = tuple(upsample_strides)
        dt = compute_dtype(dtype)
        deblocks = []
        for cin, ch, s in zip(in_channels, out_channels, upsample_strides):
            if s > 1:
                up = ConvTranspose2d(cin, ch, s, stride=s, bias=False,
                                     compute_dtype=dt)
            else:   # stride 1: a 1x1 conv; 1/k: a k x k conv at stride k
                k = max(1, int(round(1 / s)))
                up = Conv2d(cin, ch, k, stride=k, bias=False,
                            compute_dtype=dt)
            deblocks.append(nn.Sequential(up, BatchNorm2d(ch, eps=1e-3),
                                          nn.ReLU()))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Union[torch.Tensor, tuple]:
        outs = [nchw_to_nhwc(block(nhwc_to_nchw(x)))
                for block, x in zip(self.deblocks, feats)]
        if not self.concat_out:
            return tuple(outs)
        return torch.cat(outs, dim=-1)
