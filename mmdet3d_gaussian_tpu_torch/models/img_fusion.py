"""Image branch and LiDAR-camera point fusion of MVX.

Port of ``mmdet3d_gaussian_tpu/models/img_fusion.py``: the residual block
:class:`BasicResBlock`, the ResNet-style :class:`ImgBackbone`, the top-down
:class:`ImgFPNNeck`, :func:`project_points_to_img`,
:func:`bilinear_sample_img` and :class:`PointFusion`, which paints per-point
image features onto the cloud.  Maps are NHWC at the modules' edges, as in
the JAX package, and NCHW views of channels-last memory inside, so every
convolution writes channels last and every training BatchNorm takes K4's
rows path.

``dtype='bfloat16'`` is the JAX package's mixed precision for this branch:
each convolution computes in bf16 on f32 parameters, and each BatchNorm
follows flax's ``nn.BatchNorm`` (no dtype), whose output is the result type
of its bf16 input and f32 parameters: f32
(:class:`~.backbones.BatchNorm2d` with ``promote=True``).  So the ReLUs,
the max pool and the residual adds run in f32, the next convolution casts
to bf16 again, and the backbone's maps are f32; the neck's are bf16.  The
fusion's Dense layers compute in f32 whatever the dtype.

The bilinear sample gathers rows of the flattened maps through
:class:`_GatherRows`, whose backward adds each gathered row's gradient
into its source row with ``index_add_``.  Indexing's own backward on CUDA
(``index_put_`` with accumulate) sorts the indices and accumulates each
run serially, and the points off the image all clamp onto the border
pixels: the fusion's backward took 7.64 ms that way against 1.20 ms on an
H100 at KITTI_MVX_MODEL's width (``chip_smoke.py`` (xt)).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import MODELS
from .backbones import (BatchNorm2d, Conv2d, compute_dtype, nchw_to_nhwc,
                        nhwc_to_nchw)

BN_EPS = 1e-3
DEPTH_EPS = 1e-5


def _bn(channels: int) -> BatchNorm2d:
    """flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3)``: K4 in training,
    an f32 output."""
    return BatchNorm2d(channels, eps=BN_EPS, promote=True)


class BasicResBlock(nn.Module):
    """3 x 3 conv (stride s, no bias) -> BN -> ReLU -> 3 x 3 conv -> BN,
    plus the input (through a 1 x 1 conv at stride s and BN when the
    stride or the width changes), then ReLU.  NCHW in and out."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv2d(in_channels, channels, 3, stride=stride,
                            padding=1, bias=False, compute_dtype=dtype)
        self.bn1 = _bn(channels)
        self.conv2 = Conv2d(channels, channels, 3, padding=1, bias=False,
                            compute_dtype=dtype)
        self.bn2 = _bn(channels)
        if stride != 1 or in_channels != channels:
            self.down = Conv2d(in_channels, channels, 1, stride=stride,
                               bias=False, compute_dtype=dtype)
            self.bn_down = _bn(channels)
        else:
            self.down = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        if self.down is not None:
            x = self.bn_down(self.down(x))
        return torch.relu(h + x)


@MODELS.register_module()
class ImgBackbone(nn.Module):
    """7 x 7 stride-2 stem (no bias) -> BN -> ReLU -> 3 x 3 stride-2 max
    pool, then ``len(stage_channels)`` stages of ``blocks_per_stage``
    :class:`BasicResBlock` (stage i > 0 starts at stride 2): one NHWC map
    per stage, at strides 4, 8, 16, ...  Modules are named as the JAX
    tree's (``stem``, ``stem_bn``, ``stage{i}_block{j}``)."""

    def __init__(self, stage_channels: Sequence[int] = (32, 64, 128, 256),
                 blocks_per_stage: int = 2, in_channels: int = 3,
                 dtype: Optional[Union[str, torch.dtype]] = None):
        super().__init__()
        dt = compute_dtype(dtype)
        self.stem = Conv2d(in_channels, stage_channels[0], 7, stride=2,
                           padding=3, bias=False, compute_dtype=dt)
        self.stem_bn = _bn(stage_channels[0])
        self.blocks: List[List[str]] = []
        cin = stage_channels[0]
        for i, ch in enumerate(stage_channels):
            names = []
            for j in range(blocks_per_stage):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f'stage{i}_block{j}'
                self.add_module(name, BasicResBlock(cin, ch, stride, dt))
                names.append(name)
                cin = ch
            self.blocks.append(names)

    def forward(self, img: torch.Tensor) -> List[torch.Tensor]:
        """img (B, H, W, C) -> [(B, H_i, W_i, stage_channels[i])]."""
        x = torch.relu(self.stem_bn(self.stem(nhwc_to_nchw(img))))
        # padding counts as -inf, as flax's max_pool pads; ties go to the
        # first maximum in window order, as in JAX's gradient
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for names in self.blocks:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(nchw_to_nhwc(x))
        return outs


def upsample2_crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW nearest-neighbour x2 (each pixel repeated 2 x 2, as
    ``jnp.repeat`` twice), cropped to (h, w); channels innermost in
    memory."""
    b, c, hh, ww = x.shape
    y = nchw_to_nhwc(x)[:, :, None, :, None, :].expand(b, hh, 2, ww, 2, c)
    y = y.reshape(b, 2 * hh, 2 * ww, c)[:, :h, :w]
    return nhwc_to_nchw(y)


@MODELS.register_module()
class ImgFPNNeck(nn.Module):
    """Top-down FPN: a 1 x 1 lateral conv (with bias) a level, each level
    from the top down adds the one above it upsampled x2 (cropped to its
    size), then a 3 x 3 output conv (with bias) a level; every level gets
    ``out_channels``.  NHWC in and out."""

    def __init__(self, in_channels: Sequence[int] = (32, 64, 128, 256),
                 out_channels: int = 64,
                 dtype: Optional[Union[str, torch.dtype]] = None):
        super().__init__()
        dt = compute_dtype(dtype)
        for i, cin in enumerate(in_channels):
            self.add_module(f'lateral_{i}', Conv2d(cin, out_channels, 1,
                                                   compute_dtype=dt))
            self.add_module(f'fpn_out_{i}', Conv2d(
                out_channels, out_channels, 3, padding=1, compute_dtype=dt))
        self.num_levels = len(in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f'lateral_{i}')(nhwc_to_nchw(f))
                    for i, f in enumerate(feats)]
        for i in range(len(laterals) - 1, 0, -1):
            lo = laterals[i - 1]
            laterals[i - 1] = lo + upsample2_crop(laterals[i], lo.shape[2],
                                                  lo.shape[3])
        return [nchw_to_nhwc(getattr(self, f'fpn_out_{i}')(x))
                for i, x in enumerate(laterals)]


def project_points_to_img(points_xyz: torch.Tensor, lidar2img: torch.Tensor,
                          img_hw: Tuple[int, int]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LiDAR points -> pixel coordinates.

    points_xyz (..., N, 3); lidar2img (..., 4, 4) (a leading batch dim
    each, or none); img_hw (h, w) of the original image the matrix maps
    into.  -> uv (..., N, 2) pixels (x, y), the depth floored at 1e-5, and
    valid (..., N) bool: in front of the camera (depth > 1e-5) and inside
    the image (0 <= u <= w - 1, 0 <= v <= h - 1)."""
    ones = torch.ones_like(points_xyz[..., :1])
    hom = torch.cat([points_xyz, ones], dim=-1)
    cam = torch.matmul(hom, lidar2img.transpose(-1, -2))
    depth = cam[..., 2]
    uv = cam[..., :2] / torch.clamp_min(depth[..., None], DEPTH_EPS)
    h, w = img_hw
    valid = ((depth > DEPTH_EPS) & (uv[..., 0] >= 0) & (uv[..., 0] <= w - 1)
             & (uv[..., 1] >= 0) & (uv[..., 1] <= h - 1))
    return uv, valid


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` for a (R, C) table and (M,) row ids; the backward
    adds each gathered row's gradient into its source row
    (``index_add_``)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        grad = g.new_zeros((ctx.rows, g.shape[1]))
        return grad.index_add_(0, idx, g), None


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` with its gradient: a value on a bound gets half (as
    ``max`` / ``min`` split a tie)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def bilinear_sample_img(feat: torch.Tensor, uv: torch.Tensor
                        ) -> torch.Tensor:
    """Bilinear sample of NHWC maps at pixel coords uv = (x, y), pixel
    centres at integer coordinates (align-corners semantics): x clamped to
    [0, w - 1], its floor x0 to [0, w - 2] (so x = w - 1 reads dx = 1), the
    same for y; four gathers combined as the JAX package's FMA order.

    feat (H, W, C) with uv (N, 2), or (B, H, W, C) with uv (B, N, 2): each
    sample's points read its own map."""
    if feat.dim() == 3:
        return bilinear_sample_img(feat[None], uv[None])[0]
    b, h, w, c = feat.shape
    n = uv.shape[1]
    x = _clip(uv[..., 0], 0.0, w - 1.0)
    y = _clip(uv[..., 1], 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int32), 0, h - 2)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    base = (torch.arange(b, device=feat.device, dtype=torch.int64)[:, None]
            * h + y0.long()) * w + x0.long()
    table = feat.reshape(b * h * w, c)

    def corner(off):
        return _GatherRows.apply(table, (base + off).reshape(-1)).view(b, n,
                                                                       c)
    f00, f01, f10, f11 = corner(0), corner(1), corner(w), corner(w + 1)
    return ((1 - dy) * ((1 - dx) * f00 + dx * f01)
            + dy * ((1 - dx) * f10 + dx * f11))


@MODELS.register_module()
class PointFusion(nn.Module):
    """Paint per-point image features from multi-level FPN maps: for each
    level, a bilinear sample at ``uv / stride`` and a Dense ``lateral_i``;
    the levels summed, ReLU, Dense ``fuse``, ReLU, and zero for a point
    off the image.  ``img_levels``: each level's stride against the
    original image that ``lidar2img`` targets.  The Dense layers compute in
    f32.  Every output row depends on its own point and its own sample's
    maps only: the fusion has no batch-wide reduction, so a data-parallel
    step needs no collective here (the image branch's BatchNorms are
    synced with the trunk's, ``mesh.sync_batchnorms``)."""

    def __init__(self, in_channels: int = 64, out_channels: int = 64,
                 img_levels: Sequence[int] = (4, 8, 16, 32)):
        super().__init__()
        self.img_levels = tuple(img_levels)
        for i in range(len(self.img_levels)):
            self.add_module(f'lateral_{i}', nn.Linear(in_channels,
                                                      out_channels))
        self.fuse = nn.Linear(out_channels, out_channels)

    def forward(self, feats: Sequence[torch.Tensor], points_xyz: torch.Tensor,
                lidar2img: torch.Tensor, img_hw: Tuple[int, int]
                ) -> torch.Tensor:
        """feats: [(B, H_l, W_l, C)] f32 FPN maps; points_xyz (B, N, 3);
        lidar2img (B, 4, 4); img_hw the original (h, w).  -> (B, N,
        out_channels)."""
        uv, valid = project_points_to_img(points_xyz, lidar2img, img_hw)
        acc = None
        for i, (f, stride) in enumerate(zip(feats, self.img_levels)):
            sampled = bilinear_sample_img(f, uv / stride)
            y = getattr(self, f'lateral_{i}')(sampled)
            acc = y if acc is None else acc + y
        out = torch.relu(self.fuse(torch.relu(acc)))
        return out * valid[..., None].to(out.dtype)
