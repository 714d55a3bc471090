"""SECOND backbone and SECONDFPN neck (eval) as plain PyTorch convolutions.

Port of ``mmdet3d_gaussian_tpu/models/backbones.py`` (``ConvBNReLU``,
``SECOND``, ``SECONDFPN``) without its TPU layout rewrites (space-to-depth
and W-folded canvases, d2s deconvolution, H-chunk halos): each of those is
an exact rewrite of the plain op written here.  Module names follow
mmdet3d's state_dict (``backbone.blocks.{s}.{j}``,
``neck.deblocks.{i}.{0,1}``); BatchNorm eps 1e-3.

Public layout is the JAX package's NHWC; inside, tensors are NCHW views of
channels-last memory, so the NHWC <-> NCHW permutes are free.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch
from torch import nn

from ..registry import MODELS


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv_bn_relu(cin: int, cout: int, stride: int = 1) -> List[nn.Module]:
    """3x3 conv (pad 1, no bias) -> BatchNorm(eps 1e-3) -> ReLU."""
    return [nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False),
            nn.BatchNorm2d(cout, eps=1e-3), nn.ReLU()]


@MODELS.register_module()
class SECOND(nn.Module):
    """Stage i: strided ConvBNReLU then ``layer_nums[i]`` ConvBNReLU; one
    NHWC feature map per stage."""

    def __init__(self, in_channels: int = 64,
                 out_channels: Sequence[int] = (64, 128, 256),
                 layer_nums: Sequence[int] = (3, 5, 5),
                 layer_strides: Sequence[int] = (2, 2, 2)):
        super().__init__()
        self.layer_strides = tuple(layer_strides)
        blocks = []
        cin = in_channels
        for ch, num, stride in zip(out_channels, layer_nums, layer_strides):
            layers = conv_bn_relu(cin, ch, stride)
            for _ in range(num):
                layers += conv_bn_relu(ch, ch)
            blocks.append(nn.Sequential(*layers))
            cin = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: NHWC canvas -> list of NHWC maps."""
        x = nhwc_to_nchw(x)
        outs = []
        for i, (block, stride) in enumerate(zip(self.blocks,
                                                self.layer_strides)):
            if x.shape[2] % stride or x.shape[3] % stride:
                raise ValueError(
                    f'SECOND stage {i}: spatial dims {tuple(x.shape[2:])} '
                    f'not divisible by stride {stride}')
            x = block(x)
            outs.append(nchw_to_nhwc(x))
        return outs


@MODELS.register_module()
class SECONDFPN(nn.Module):
    """Per level: ConvTranspose(k = stride) for stride > 1, or a 1x1 conv
    for stride 1, then BN and ReLU; levels concatenated on channels (or
    returned as a tuple with ``concat_out=False``)."""

    def __init__(self, in_channels: Sequence[int] = (64, 128, 256),
                 out_channels: Sequence[int] = (128, 128, 128),
                 upsample_strides: Sequence[int] = (1, 2, 4),
                 concat_out: bool = True):
        super().__init__()
        self.concat_out = concat_out
        deblocks = []
        for cin, ch, s in zip(in_channels, out_channels, upsample_strides):
            if s > 1:
                up = nn.ConvTranspose2d(cin, ch, s, stride=s, bias=False)
            elif s == 1:
                up = nn.Conv2d(cin, ch, 1, bias=False)
            else:
                raise NotImplementedError(
                    f'upsample stride {s} < 1 is not ported yet')
            deblocks.append(nn.Sequential(up, nn.BatchNorm2d(ch, eps=1e-3),
                                          nn.ReLU()))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Union[torch.Tensor, tuple]:
        outs = [nchw_to_nhwc(block(nhwc_to_nchw(x)))
                for block, x in zip(self.deblocks, feats)]
        if not self.concat_out:
            return tuple(outs)
        return torch.cat(outs, dim=-1)
