"""The yardstick of the hand kernels: the published peaks of one H100,
the bytes and operations each kernel's function needs on its inputs
(frozen from ``chip_smoke.py``: ``k1_work``, ``k5_work``, ``k6_work`` and
the K2, K4 and K7 byte counts), and where the benchmark records each op's
inputs (the op's entry in the port's ``ops/``) and which device kernels
carry it.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 and 67 TFLOP/s of
f32 outside the tensor cores, a fused multiply-add counted as two
operations; at the card's full 700 W power limit.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Tuple

import torch

PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12

# f32 operations per pair of the rotated IoU and of its cull test
# (chip_smoke.py: IOU_OPS_PER_PAIR, CULL_OPS_PER_PAIR)
IOU_OPS_PER_PAIR = 4 + 72 + 144 + 440 + 124 + 288 + 840 + 72 + 100 + 8
CULL_OPS_PER_PAIR = 10
# K5's cull radius (ops/rotated_iou.py constants, powers of two)
CULL_REL = 1.0 + 2.0 ** -6
CULL_ABS = 2.0 ** -10
CULL_POS = 2.0 ** -17
THIN_REL = 2.0 ** -10
THIN_POS = 2.0 ** -16


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds at the published peaks."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS)


def k1_work(form, data, ids, starts, counts):
    """(bytes, operations) of K1's ``form``: the rows of the live segments
    read once, segment bounds and ids where read, outputs written once."""
    n, c = data.shape
    v = counts.shape[0]
    live = int(counts.sum())
    ops = live * c
    if form == 'reduce':
        return live * c * 4 + v * 8 + v * c * 4, ops
    if form == 'mapback':
        return live * c * 4 + n * c * 4 + n * 4 + v * 8, n * c
    return live * c * 4 + v * 8 + n * 4 + v * c * 4 + n * c, ops  # winner


def near_pairs(boxes):
    """(P, K, 5) -> number of pairs K5 computes in full (its cull)."""
    b = boxes.float()
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    hd = 0.5 * torch.sqrt(w * w + h * h)
    pos = cx.abs() + cy.abs()
    r = hd * CULL_REL + CULL_ABS + CULL_POS * pos
    side = torch.minimum(w.abs(), h.abs())
    thin = (side > 0) & (side < hd * THIN_REL + THIN_POS * pos)
    r = torch.where(thin, torch.inf, r)
    r = torch.where(b.isfinite().all(-1), r, torch.nan)
    dx = cx[:, :, None] - cx[:, None, :]
    dy = cy[:, :, None] - cy[:, None, :]
    d2 = dx * dx + dy * dy
    s = r[:, :, None] + r[:, None, :]
    far = (d2 > s * s) & (d2 <= torch.finfo(torch.float32).max)
    return int((~far).sum())


def k5_work(boxes):
    p, k = boxes.shape[:2]
    return (boxes.numel() * 4 + p * k * k * 4,
            near_pairs(boxes) * IOU_OPS_PER_PAIR
            + p * k * k * CULL_OPS_PER_PAIR)


def k6_work(iou, valid, thr, keep):
    """The strict upper triangle read once, valid read and keep written;
    a compare of every upper IoU and, for each kept row, one update of
    each later column."""
    p, k = valid.shape
    upper = p * k * (k - 1) // 2
    pos = torch.arange(k, device=keep.device)
    return upper * 4 + 2 * p * k, upper + int(((k - 1 - pos) * keep).sum())


def _splat(args, out):
    feats, lin, ncell = args[:3]
    extra = lin.numel() * 4 * (2 if len(args) == 4 else 1)
    return (feats.numel() * feats.element_size() + extra
            + out.numel() * out.element_size(), 0)


def _moments(args, out):
    """K4 forward on x (M, C) or (B, C, H, W): x read once, two sums of
    C written."""
    x = args[0]
    c = x.shape[1]
    m = x.numel() // c
    return m * c * x.element_size() + 2 * c * 4, 2 * m * c


def _grad_moments(args, out):
    """K4 backward on (g, x, mean, inv): g and x read once, mean and inv
    read, two sums written."""
    x = args[1]
    c = x.shape[1]
    m = x.numel() // c
    return 2 * m * c * x.element_size() + 4 * c * 4, 4 * m * c


# op -> (module of the port, attribute called at the op's entry, device
# kernel base names that carry it, work(args, output) -> (bytes, flops))
OPS: Dict[str, Tuple[str, str, Tuple[str, ...], Callable]] = {
    'segment_reduce': (
        'mmdet3d_gaussian_tpu_torch.ops.scatter', 'segment_reduce',
        ('segment_reduce_kernel',),
        lambda a, o: k1_work('reduce', a[0], None, a[1], a[2])),
    'segment_reduce_mapback': (
        'mmdet3d_gaussian_tpu_torch.ops.scatter', 'segment_reduce_mapback',
        ('segment_mapback_kernel',),
        lambda a, o: k1_work('mapback', a[0], a[1], a[2], a[3])),
    'segment_max_winner': (
        'mmdet3d_gaussian_tpu_torch.ops.scatter', 'segment_max_winner',
        ('segment_max_winner_kernel',),
        lambda a, o: k1_work('winner', a[0], a[1], a[2], a[3])),
    'bev_splat': ('mmdet3d_gaussian_tpu_torch.ops.voxelize', 'bev_splat',
                  ('splat_kernel',), _splat),
    'bev_splat_pairs': ('mmdet3d_gaussian_tpu_torch.ops.voxelize',
                        'bev_splat_pairs', ('splat_kernel',), _splat),
    'bn_moments': ('mmdet3d_gaussian_tpu_torch.ops.bn', 'moments',
                   ('planes_kernel', 'rows_kernel'), _moments),
    'bn_grad_moments': ('mmdet3d_gaussian_tpu_torch.ops.bn', 'grad_moments',
                        ('planes_kernel', 'rows_kernel'), _grad_moments),
    'rotated_iou': ('mmdet3d_gaussian_tpu_torch.ops.nms', 'iou_bev_pairwise',
                    ('rotated_iou_kernel',), lambda a, o: k5_work(a[0])),
    'nms_sweep': ('mmdet3d_gaussian_tpu_torch.ops.nms', 'suppress_sweep',
                  ('nms_pack_kernel', 'nms_sweep_kernel'),
                  lambda a, o: k6_work(a[0], a[1], a[2], o)),
}


class Shape:
    """What the work counters read of a large tensor (its shape and
    element size), kept in its place so that recording a call holds no
    activation alive: the allocator would then call ``cudaMalloc`` inside
    the traced window."""

    def __init__(self, t: torch.Tensor):
        self.shape, self._size = tuple(t.shape), t.element_size()

    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def element_size(self) -> int:
        return self._size

    def dim(self) -> int:
        return len(self.shape)


SMALL_BYTES = 1 << 20


def light(x):
    """``x``, or a :class:`Shape` in place of a tensor over SMALL_BYTES
    (the counters read only the shapes of those)."""
    if isinstance(x, (tuple, list)):
        return type(x)(light(v) for v in x)
    if isinstance(x, torch.Tensor) and \
            x.numel() * x.element_size() > SMALL_BYTES:
        return Shape(x)
    return x


class Recorder:
    """Wraps each op of :data:`OPS` at its entry while active and keeps
    every call's arguments and output (large tensors as their shapes),
    for the work counters."""

    def __init__(self):
        self.calls: Dict[str, List] = {}
        self._saved = []

    def __enter__(self):
        for name, (mod_name, attr, _k, _w) in OPS.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr, None)
            if fn is None:
                continue
            self._saved.append((mod, attr, fn))

            def rec(*args, _fn=fn, _name=name):
                out = _fn(*args)
                self.calls.setdefault(_name, []).append((light(args),
                                                         light(out)))
                return out
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self._saved.clear()

    def work(self) -> Dict[str, Tuple[int, float, float]]:
        """op -> (calls, summed least seconds, summed bytes)."""
        out = {}
        for name, calls in self.calls.items():
            f = OPS[name][3]
            total_s, total_b = 0.0, 0.0
            for args, res in calls:
                nbytes, flops = f(args, res)
                total_s += bound_s(nbytes, flops)
                total_b += nbytes
            out[name] = (len(calls), total_s, total_b)
        return out
