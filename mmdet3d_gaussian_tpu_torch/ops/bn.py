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
(:func:`_layout`), so no copy is made around a BatchNorm;
:func:`kernel_plan` picks the kernel's path for the layout and
:func:`chunking` cuts each channel's rows into chunks fixed by the shape,
one partial sum each, which the kernel's last block adds in order (one
launch a call, bitwise repeatable).  They are f32, or
bf16 in the mixed-precision model (``FastBatchNorm(dtype='bfloat16')``):
the sums are f32 either way, and ``bn_train``'s output has the input's
type, computed in f32 and rounded once, as the JAX module's (or is left
f32 with ``out_dtype``, as flax's ``nn.BatchNorm`` leaves it).  Each wrapper
computes its plain PyTorch version for CPU tensors and launches the kernel
for CUDA tensors; there is no fallback between the two.

Under a data-parallel group (``parallel/mesh.py``) :func:`bn_train` is
SyncBN, the JAX ``bn_train`` with ``axis_name``: K4's sums of this rank's
rows and its row count go through one ``all_reduce`` of ``2C + 1`` values
forward and one backward, so the statistics and ``dx`` are those of the
whole batch.  ``dscale`` and ``dbias`` stay this rank's sums: the step's
gradient all-reduce adds them up.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

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
    return _strided_layout(tuple(x.shape), x.stride())


def _strided_layout(shape, stride):
    if len(shape) == 2:
        m, c = shape
        return m, c, m, 0, stride[0], stride[1]
    if len(shape) != 4:
        raise ValueError(f'x must be (M, C) or (B, C, H, W), got {shape}')
    b, c, h, w = shape
    sb, sc, sh, sw = stride
    if h > 1 and w > 1 and sh != w * sw:
        raise ValueError('x layout: H and W strides do not merge')
    ss = sw if w > 1 else sh
    s = h * w
    if sb == s * ss:        # batch and spatial merge into one row stride
        return b * s, c, b * s, 0, ss, sc
    return b * s, c, s, sb, ss, sc


class Chunks(NamedTuple):
    """How the kernel cuts one channel's rows: chunk k holds whole planes
    ``[k * planes, (k + 1) * planes)`` when ``splits == 1``, else rows
    ``[j * span, (j + 1) * span)`` of plane ``k // splits``, ``j = k %
    splits``; ``count`` chunks (partial sums) a channel."""
    planes: int
    splits: int
    span: int
    count: int


# Rows (channels innermost): a chunk is a block's run of rows over a group
# of ROW_GROUP channels, sized for about ROW_BLOCKS blocks a call and at
# least ROW_CHUNK_MIN rows.  Planes: a chunk is a warp's run along one
# channel's plane, sized for about PLANE_CHUNKS chunks a call within
# PLANE_CHUNK_ROWS rows.
ROW_GROUP = 64
ROW_BLOCKS = 256
ROW_CHUNK_MIN = 64
PLANE_CHUNKS = 4096
PLANE_CHUNK_ROWS = (1024, 8192)
# tickets of one launch: one, or one per channel group of the rows path
MAX_GROUPS = 1024


def chunk_limit(path: str, rows: int, c: int) -> int:
    """Most rows of one chunk on ``path`` for ``rows`` x ``c`` elements."""
    if path == 'planes':
        lo, hi = PLANE_CHUNK_ROWS
        return min(hi, max(lo, rows * c // PLANE_CHUNKS))
    chunks = max(1, -(-ROW_BLOCKS // -(-c // ROW_GROUP)))
    return max(ROW_CHUNK_MIN, -(-rows // chunks))


def chunking(rows: int, plane: int, per: int) -> Chunks:
    """The chunks of ``rows`` rows in planes of ``plane`` rows, at most
    ``per`` rows a chunk but for a whole plane: a function of these numbers
    alone, so the kernel's summation order (and its result) depends on the
    shape, not on the card.  Planes longer than ``per`` are split evenly,
    shorter ones grouped; ``count <= 2 * rows / per + 1``."""
    if plane <= 0:
        return Chunks(1, 1, 0, 0)
    nplanes = rows // plane
    if plane >= per:
        splits = -(-plane // per)
        return Chunks(1, splits, -(-plane // splits), nplanes * splits)
    group = per // plane
    return Chunks(group, 1, plane, -(-nplanes // group))


def chunk_rows(ch: Chunks, k: int, plane: int, rows: int):
    """Row ranges ``[(start, stop), ...]`` of chunk ``k`` (the kernel's
    ``chunk_range``)."""
    if ch.splits > 1:
        b, j = divmod(k, ch.splits)
        s0 = j * ch.span
        return [(b * plane + s0, b * plane + min(plane, s0 + ch.span))]
    b1 = min(rows // plane, (k + 1) * ch.planes)
    return [(b * plane, (b + 1) * plane) for b in range(k * ch.planes, b1)]


PATHS = ('planes', 'rows-scalar', 'rows-vector')


class Plan(NamedTuple):
    """One kernel call: the path (an entry of :data:`PATHS`), rows, C, the
    plane length S shared by x and g, their (sb, ss, sc) strides, the
    chunking, and the launcher's integer arguments in its order."""
    path: str
    rows: int
    c: int
    plane: int
    x: Tuple[int, int, int]
    g: Tuple[int, int, int]
    chunks: Chunks
    args: Tuple[int, ...]


def kernel_plan(x: torch.Tensor, g: Optional[torch.Tensor] = None) -> Plan:
    """What the kernel does with ``x`` (and the backward's ``g``, of x's
    shape and type): a function of their shape, strides, element size and
    16-byte alignment only, so it is computed once for each of these (the
    train step's BatchNorms repeat them every step)."""
    if x.dtype not in _cuda.FLOAT_TYPES:
        raise TypeError(f'x must be float32 or bfloat16, got {x.dtype}')
    xp = x.data_ptr()
    if g is None:
        return _plan(x.shape, x.stride(), None, x.element_size(), xp % 16,
                     0)
    return _plan(x.shape, x.stride(), g.stride(), x.element_size(),
                 xp % 16, (g.data_ptr() - xp) % 16)


@functools.lru_cache(maxsize=1024)
def _plan(shape, xstride, gstride, esize: int, xmod: int, gmod: int) -> Plan:
    """:func:`kernel_plan` for x (and g) given by shape, strides, element
    size, x's address mod 16 and g's offset from x mod 16: both split into
    planes of the same length (a layout whose batch merged into its rows
    is split again at the other's plane), then

    * channels innermost (``sc == 1``): ``rows-vector`` when a thread can
      read 16 bytes of neighbouring channels (C, strides and address
      aligned, g laid out as x), else ``rows-scalar``;
    * otherwise ``planes``, one element a lane."""
    lx = _strided_layout(shape, xstride)
    lg = lx if gstride is None else _strided_layout(shape, gstride)
    rows, c, plane = lx[0], lx[1], lx[2]
    if lg[2] != plane:      # one side merged its batch: S == rows there
        if plane == rows:
            plane = lg[2]
        lx, lg = (_split(lx, plane), _split(lg, plane))
    sb, ss, sc = lx[3:]
    if sc == 1:
        vector = (lg[3:] == lx[3:] and gmod == 0 and xmod == 0
                  and (c * esize) % 16 == 0 and (sb * esize) % 16 == 0
                  and (ss * esize) % 16 == 0)
        path = 'rows-vector' if vector else 'rows-scalar'
        if -(-c // ROW_GROUP) > MAX_GROUPS:
            raise ValueError(f'{c} channels: at most '
                             f'{MAX_GROUPS * ROW_GROUP} channels innermost')
    else:
        path = 'planes'
    chunks = chunking(rows, plane, chunk_limit(path, rows, c))
    strides = lx[3:] + (() if gstride is None else lg[3:])
    return Plan(path, rows, c, plane, lx[3:], lg[3:], chunks,
                (rows, c, plane) + strides + (PATHS.index(path),) + chunks)


def _split(lay, plane: int):
    """``lay`` as planes of ``plane`` rows: a layout with ``S == rows``
    addresses row r at ``r * ss``, which is ``(r // plane) * plane * ss +
    (r % plane) * ss``."""
    rows, c, s, sb, ss, sc = lay
    if s == plane:
        return lay
    return rows, c, plane, plane * ss, ss, sc


def _tickets(dev: torch.device, stream: int) -> torch.Tensor:
    """The zeroed uint32 counters the kernel's blocks draw tickets from (one
    a channel group), one set per device and stream; the block drawing a
    counter's last ticket sets it back to 0."""
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(MAX_GROUPS, dtype=torch.int32,
                                        device=dev)
    return t


_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _launch(name: str, dev: torch.device, plan: Plan, ptrs, esize: int):
    """One kernel call: out (2, C) and the partials in one buffer."""
    c, count = plan.c, plan.chunks.count
    buf = torch.empty(2 * c * (1 + count), dtype=torch.float32, device=dev)
    if count == 0:
        return buf[:2 * c].zero_().view(2, c).unbind(0)
    out = buf.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _cuda.launch(name, dev, *ptrs, *plan.args, out + 8 * c,
                 _tickets(dev, stream).data_ptr(), out, int(esize == 2),
                 stream=stream)
    return buf[:2 * c].view(2, c).unbind(0)


def moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (sum x, sum x^2), each (C,) f32.

    x: (M, C) or (B, C, H, W) f32 or bf16 in any layout :func:`_layout`
    accepts."""
    dev = _cuda.same_device(x)
    if dev.type == 'cpu':
        _layout(x)
        return moments_plain(x)
    return _launch('bn_moments', dev, kernel_plan(x), (x.data_ptr(),),
                   x.element_size())


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
    if x.is_cuda:
        plan = kernel_plan(x, g)
        c = plan.c
    else:
        c = _layout(x)[1]
        _layout(g)
    _cuda.check_tensor(mean, 'mean', torch.float32, (c,))
    _cuda.check_tensor(inv, 'inv', torch.float32, (c,))
    dev = _cuda.same_device(g, x, mean, inv)
    if dev.type == 'cpu':
        return grad_moments_plain(g, x, mean, inv)
    return _launch('bn_grad_moments', dev, plan,
                   (g.data_ptr(), x.data_ptr(), mean.data_ptr(),
                    inv.data_ptr()), x.element_size())


def batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased variance) of x from K4's sums, f32:
    ``var = max(sum x^2 / M - mean^2, 0)``."""
    su, sq = moments(x)
    return _stats(su, sq, float(x.numel() // x.shape[1]))


def _stats(su, sq, cnt):
    mean = su / cnt
    return mean, torch.clamp_min(sq / cnt - mean * mean, 0.0)


def _group_sums(a: torch.Tensor, b: torch.Tensor, cnt: float, group):
    """(a, b, cnt) summed over ``group``'s ranks by one ``all_reduce`` of a
    flat ``2C + 1`` f32 buffer; cnt comes back a 0-d tensor."""
    from ..parallel.mesh import all_reduce_sum
    c = a.shape[0]
    flat, = all_reduce_sum([torch.cat([a, b, a.new_full((1,), cnt)])],
                           group)
    return flat[:c], flat[c:2 * c], flat[2 * c]


def _channel_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.view(1, -1, 1, 1) if ndim == 4 else t


class BNTrain(torch.autograd.Function):
    """``bn_train(x, scale, bias, eps, out_dtype, group) -> (y, mean,
    var)``; mean and var (biased) carry no gradient (they feed the running
    statistics)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float,
                out_dtype: Optional[torch.dtype] = None, group=None):
        cnt = float(x.numel() // x.shape[1])
        if group is None:
            mean, var = batch_stats(x)
        else:
            su, sq, cnt = _group_sums(*moments(x), cnt, group)
            mean, var = _stats(su, sq, cnt)
        inv = torch.rsqrt(var + eps)
        k = _channel_view(inv * scale, x.dim())
        y = ((x.float() - _channel_view(mean, x.dim())) * k + _channel_view(
            bias, x.dim())).to(out_dtype or x.dtype)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.cnt = float(x.numel() // x.shape[1])
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, scale, mean, inv = ctx.saved_tensors
        dtype = x.dtype
        if gy.dtype != dtype:
            # an f32 output of a bf16 input: the sums read both in f32 (the
            # cast keeps x's memory format, so its rows path)
            x = x.float()
            gy = gy.float()
        sg, sgx = grad_moments(gy, x, mean, inv)
        cnt = ctx.cnt
        # dscale, dbias: this rank's sums (the gradient all-reduce adds
        # them up); dx: the whole batch's
        dscale, dbias = sgx, sg
        if ctx.group is not None:
            sg, sgx, cnt = _group_sums(sg, sgx, cnt, ctx.group)
        nd = x.dim()
        xhat = (x.float() - _channel_view(mean, nd)) * _channel_view(inv, nd)
        dx = _channel_view(inv * scale, nd) * (
            gy.float() - _channel_view(sg / cnt, nd)
            - xhat * _channel_view(sgx / cnt, nd))
        return dx.to(dtype), dscale, dbias, None, None, None


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             eps: float, out_dtype: Optional[torch.dtype] = None,
             group=None):
    """Training-mode BN over the channel dim 1 of an (M, C) or (B, C, H, W)
    f32 or bf16 tensor -> (y of ``out_dtype`` (None: x's type), batch mean,
    batch biased var, both f32).  ``out_dtype=torch.float32`` on a bf16 x
    is flax's ``nn.BatchNorm`` rule (the result type of x and the f32
    parameters); the gradient of x then has x's type.  ``group`` (a
    ``parallel.mesh.Group``): the batch is every rank's rows (SyncBN)."""
    return BNTrain.apply(x, scale, bias, eps, out_dtype, group)
