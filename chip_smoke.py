#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing its own lines (any failure exits non-zero):
  (a) build every CUDA kernel from ``mmdet3d_gaussian_tpu_torch/csrc``;
      nvcc time and ptxas registers / spills per kernel;
  (b) each kernel against its plain PyTorch version on the card, on the
      exact inputs the full-width main paths hand it (captured from one
      warm-up predict, and from one warm full-width train step with dense
      targets): max error; device time (torch.profiler: the summed
      durations of what each call ran on the card, host time left out) of
      the kernel, the plain version and a one-call library yardstick where
      PyTorch has one; the kernel's time per call on the host's clock
      (CUDA events over back-to-back calls, its wrapper's host work
      included); and the bound;
  (c) TINY predict and one TINY train step on the card against the same
      port on the CPU;
  (d) the predict path: PointPillars KITTI 3-class at full width (dynamic
      voxelize, batch 4 x 16384 points, random weights from a seed with a
      zero cls bias so scores clear the threshold) answering 6 requests
      (3 batches x 2 rounds); launch counts are zeroed just before and read
      just after, and every predict kernel must have run; then NMS
      candidate and suppression counts, and a torch.profiler run of 5 more
      predicts for the device-busy share and the kernels with the most
      device time;
  (t) the train path: the same model trained by ``train_step`` on one
      repeated batch (sparse targets, ``pos_cap=1024``), 3 warm-up and 10
      timed steps, launch counts zeroed before the timed steps; step time,
      peak memory, loss terms per step (finite, descending); then 3 steps
      with dense targets (``pos_cap=0``), where K3 runs; then a
      torch.profiler run of 3 more steps;
  (e) one JSON line listing the kernels, the card's name and power limit
      from nvidia-smi, and the result line.

All phases run in f32 with TF32 off for matmuls and cuDNN convolutions.
The script exits non-zero, printing no result, without a CUDA device or
outside a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, 700 W limit): HBM3
# bytes/s, and f32 operations/s outside the tensor cores. The data sheet's
# 67 TFLOP/s counts a fused multiply-add as two operations; the kernels
# below do compares, selects, adds and single multiplies, one operation
# per issued instruction, so their peak is half of it.
PEAK_BYTES = 3.35e12
PEAK_F32_OPS = 67e12 / 2

# f32 operations per pair that the rotated IoU needs (each add, sub, mul,
# div, abs, min/max, compare, select and sin/cos counted once): the steps of
# csrc/rotated_iou.cu, with its 24-slot sort counted as the best-known
# 24-input sorting network of 120 comparators instead of the kernel's 276
IOU_OPS_PER_PAIR = (4          # cos, sin of both boxes
                    + 72       # corners of both boxes
                    + 144      # 8 corner-inside tests
                    + 440      # 16 edge intersections
                    + 124      # valid count and centroid
                    + 288      # 24 pseudo-angle keys
                    + 840      # 120 compare-swaps x (1 compare + 6 selects)
                    + 72       # collapse invalid slots
                    + 100      # shoelace
                    + 8)       # area clamp and division

# Phase (c): head maps may differ between card and CPU by MAP_TOL. Decode
# scales a map error by its derivative: the anchor's BEV diagonal for x and
# y, the anchor height plus half the box height for z (z delta and log h
# delta both move it), the box's own size for w, l, h (exp(delta) * anchor
# = the decoded size), 1 for yaw. Each box element may differ by MAP_TOL
# times that derivative plus f32 rounding of its own magnitude.
MAP_TOL = 1e-4
ROUND_TOL = 8 * torch.finfo(torch.float32).eps

# f32 operations per anchor of the decoded-box GD loss in the main path's
# configuration (kld3d, fun log1p, tau 1), each add, mul, div, select,
# compare and transcendental counted once: decode of pred and target (36),
# Gaussian parameters of both (34), inverse pred and target covariances
# (30), centre term (19), shape term with 6 logs (24), sqrt, log1p and tau
# saturation (9), weighting and sum (2).  The function needs them for
# weighted anchors only, plus one test of every weight; the backward needs
# ~3x the forward's operations, for anchors with weight > 0 only.  Both
# stay bytes-bound at any count within a few times of this one.
GD_OPS_PER_ANCHOR = 154

TPU = 'mmdet3d_gaussian_tpu/ops/pallas/'
SRC = 'mmdet3d_gaussian_tpu_torch/csrc/'
# kernel -> (source, TPU kernel it replaces, the path that launches it)
KERNELS = {
    'segment_reduce': (SRC + 'segment_reduce.cu',
                       TPU + 'segment_kernel.py:171', 'predict'),
    'segment_reduce_mapback': (SRC + 'segment_reduce.cu',
                               TPU + 'segment_kernel.py:171', 'predict'),
    'bev_splat': (SRC + 'bev_splat.cu', TPU + 'bev_splat_kernel.py:218',
                  'predict'),
    'rotated_iou': (SRC + 'rotated_iou.cu', TPU + 'rotated_iou_kernel.py:166',
                    'predict'),
    'nms_sweep': (SRC + 'nms_sweep.cu', TPU + 'nms_kernel.py:37', 'predict'),
    'segment_argmax': (SRC + 'segment_reduce.cu',
                       TPU + 'segment_kernel.py:263', 'train'),
    'bn_moments': (SRC + 'bn_moments.cu', TPU + 'bn_kernel.py:101', 'train'),
    'bn_grad_moments': (SRC + 'bn_moments.cu', TPU + 'bn_kernel.py:120',
                        'train'),
    'gd_loss_fwd': (SRC + 'gd_loss.cu', TPU + 'gd_loss_kernel.py:244',
                    'train_dense'),
    'gd_loss_bwd': (SRC + 'gd_loss.cu', TPU + 'gd_loss_kernel.py:268',
                    'train_dense'),
}
# launches per train step: one BN forward and backward for each of the 19
# BatchNorm2d layers (16 in SECOND, 3 in SECONDFPN), one winner pass for the
# encoder's final voxel max; K3 once each way per dense-target step
TRAIN_LAUNCHES = {'bn_moments': 19, 'bn_grad_moments': 19,
                  'segment_argmax': 1}
DENSE_LAUNCHES = {'gd_loss_fwd': 1, 'gd_loss_bwd': 1}

TINY_MODEL = dict(
    voxel_size=(0.4, 0.4, 4.0),
    point_cloud_range=(0., -12.8, -3., 25.6, 12.8, 1.),
    max_points_per_voxel=16,
    max_voxels_per_sample=1024,
    voxelize_mode='dynamic',
    encoder_cfg=dict(in_channels=4, feat_channels=(16,)),
    backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                      layer_nums=(1, 1, 1), layer_strides=(2, 2, 2)),
    neck_cfg=dict(in_channels=(16, 32, 64), out_channels=(16, 16, 16),
                  upsample_strides=(1, 2, 4)),
    head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=48),
)
TINY_HEAD = dict(test_cfg=dict(use_rotate_nms=True, nms_thr=0.01,
                               score_thr=0.05, nms_pre=128, max_num=32))
BATCH, POINTS, SEEDS, ROUNDS = 4, 16384, (0, 1, 2), 2
WARM_STEPS, TIMED_STEPS, DENSE_STEPS, LR = 3, 10, 3, 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events,
    after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_spans(prof):
    """(start us, end us, name) of every activity the profiler saw on the
    card."""
    from torch.autograd import DeviceType
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn, iters, warmup=2):
    """Mean device ms per call: the summed durations of the kernels,
    copies and fills that ``iters`` calls of ``fn`` ran on the card
    (torch.profiler), so host time between launches is left out."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = cuda_spans(prof)
    check(spans, 'the profiler recorded no device time')
    return sum(end - start for start, end, _ in spans) / 1e3 / iters


def capture_inputs(det, batch):
    """Run one predict with every kernel wrapper wrapped to record the
    arguments the main path gives it."""
    from mmdet3d_gaussian_tpu_torch.ops import nms, scatter, voxelize
    seen = {}
    patches = [(scatter, 'segment_reduce', 'segment_reduce'),
               (scatter, 'segment_reduce_mapback', 'segment_reduce_mapback'),
               (voxelize, 'bev_splat', 'bev_splat'),
               (nms, 'iou_bev_pairwise', 'rotated_iou'),
               (nms, 'suppress_sweep', 'nms_sweep')]
    originals = []
    for mod, attr, name in patches:
        fn = getattr(mod, attr)
        originals.append((mod, attr, fn))

        def rec(*args, _fn=fn, _name=name):
            seen.setdefault(_name, args)
            return _fn(*args)
        setattr(mod, attr, rec)
    try:
        det.predict(batch)
        torch.cuda.synchronize()
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    want = {k for k, v in KERNELS.items() if v[2] == 'predict'}
    check(set(seen) == want, f'captured only {sorted(seen)}')
    return seen


def bound(bytes_, ops):
    """(least ms, 'bytes' | 'operations') for moving ``bytes_`` and doing
    ``ops`` f32 operations at the card's published peaks."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def report(results, name, card, err, tol, ok, kernel, plain, library,
           iters, plain_iters, bytes_, ops, note=''):
    """Time one kernel, its plain version and its library yardstick (if
    any), store its phase-(b) numbers, print them, fail on ``ok`` False."""
    check(ok, f'{name}: kernel disagrees with plain version (max_abs_err '
          f'{err:.3g}, tol {tol})')
    ms = device_ms(kernel, iters)
    call_ms = cuda_ms(kernel, iters)
    plain_ms = device_ms(plain, plain_iters, warmup=1)
    library_ms = device_ms(library, iters) if library else None
    bound_ms, bound_by = bound(bytes_, ops)
    results[name] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_,
                         operations=ops)
    lib = 'none' if library_ms is None else f'{library_ms:.4f} ms'
    print(f'(b) {name}: max_abs_err={err:.3g} (tol {tol}){note} '
          f'kernel={ms:.4f} ms (per call on the host clock {call_ms:.4f}) '
          f'plain={plain_ms:.4f} ms library={lib} '
          f'bound={bound_ms:.4f} ms ({bound_by}) [{card}]')


def kernel_checks(inputs, card):
    """Phase (b), predict kernels: each vs its plain version on the
    captured inputs."""
    from mmdet3d_gaussian_tpu_torch.ops import nms, rotated_iou, segment
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    results = {}

    def record(name, kernel, plain, library, err, tol, bytes_, ops, iters,
               plain_iters, exact=None):
        eq = '' if exact is None else f' exact_equal={exact}'
        report(results, name, card, err, f'{tol:g}',
               err <= tol and exact is not False, kernel, plain, library,
               iters, plain_iters, bytes_, ops, eq)

    # K1 reduce form (final per-voxel max, 64 channels)
    data, starts, counts, op = inputs['segment_reduce']
    out = segment.segment_reduce(data, starts, counts, op)
    ref = segment.segment_reduce_plain(data, starts, counts, op)
    n_live = int(torch.count_nonzero(counts))
    rows = int(counts.sum())
    v, c = counts.shape[0], data.shape[1]
    lengths = counts[:n_live].long()
    check(bool((counts[n_live:] == 0).all()), 'live voxels not first')
    live_rows = data[:rows]
    record('segment_reduce',
           lambda: segment.segment_reduce(data, starts, counts, op),
           lambda: segment.segment_reduce_plain(data, starts, counts, op),
           lambda: torch.segment_reduce(live_rows, op, lengths=lengths,
                                        unsafe=True),
           float((out - ref).abs().max()), 0.0,
           data.numel() * 4 + v * 8 + v * c * 4, rows * c, 200, 10)

    # K1 mapback form (cluster mean: xyz + ones column, 4 channels)
    data, ids, starts, counts, op = inputs['segment_reduce_mapback']
    out = segment.segment_reduce_mapback(data, ids, starts, counts, op)
    ref = segment.segment_reduce_mapback_plain(data, ids, starts, counts, op)
    n, c = data.shape
    record('segment_reduce_mapback',
           lambda: segment.segment_reduce_mapback(data, ids, starts, counts,
                                                  op),
           lambda: segment.segment_reduce_mapback_plain(data, ids, starts,
                                                        counts, op),
           None, float((out - ref).abs().max()), 1e-4,
           n * c * 8 + n * 4 + counts.shape[0] * 8, n * c, 200, 10)

    # K2 BEV splat
    feats, lin, ncell = inputs['bev_splat']
    out = voxelize.bev_splat(feats, lin, ncell)
    ref = voxelize.bev_splat_plain(feats, lin, ncell)
    live = lin < ncell
    lin_live, feats_live = lin[live].long(), feats[live]
    canvas = torch.zeros_like(ref)
    record('bev_splat', lambda: voxelize.bev_splat(feats, lin, ncell),
           lambda: voxelize.bev_splat_plain(feats, lin, ncell),
           lambda: canvas.zero_().index_copy_(0, lin_live, feats_live),
           float((out - ref).abs().max()), 0.0,
           feats.numel() * 4 + lin.numel() * 4 + ncell * feats.shape[1] * 4,
           0, 50, 10)
    check(torch.equal(canvas, ref), 'index_copy_ yardstick disagrees')
    print(f'(b) bev_splat: zero fill of the canvas alone '
          f'{cuda_ms(canvas.zero_, 50):.4f} ms ({ncell * feats.shape[1] * 4} '
          f'bytes) [{card}]')

    # K5 rotated IoU
    (boxes,) = inputs['rotated_iou']
    p, k = boxes.shape[:2]
    out = rotated_iou.iou_bev_pairwise(boxes)
    ref = rotated_iou.iou_bev_pairwise_plain(boxes)
    thr = 0.01
    overlap = float((ref > thr).float().mean())
    print(f'(b) rotated_iou inputs: {p} problems x {k} boxes, share of '
          f'pairs with IoU > {thr}: {overlap:.4f}')
    check(overlap > 0, 'rotated IoU inputs do not overlap')
    record('rotated_iou', lambda: rotated_iou.iou_bev_pairwise(boxes),
           lambda: rotated_iou.iou_bev_pairwise_plain(boxes), None,
           float((out - ref).abs().max()), 1e-5,
           boxes.numel() * 4 + p * k * k * 4, p * k * k * IOU_OPS_PER_PAIR,
           20, 2)
    del ref

    # K6 NMS sweep, on the main path's IoU and valid mask
    iou, valid, thr = inputs['nms_sweep']
    keep = nms.suppress_sweep(iou, valid, thr)
    ref = nms.suppress_sweep_plain(iou, valid, thr)
    exact = bool(torch.equal(keep, ref))
    p, k = valid.shape
    # compares of every IoU plus, for each kept row, its sweep of later
    # columns
    pos = torch.arange(k, device=keep.device)
    sweep = int(((k - 1 - pos) * ref).sum())
    record('nms_sweep', lambda: nms.suppress_sweep(iou, valid, thr),
           lambda: nms.suppress_sweep_plain(iou, valid, thr), None,
           float((keep.int() - ref.int()).abs().max()), 0.0,
           iou.numel() * 4 + 2 * p * k, iou.numel() + sweep, 50, 2,
           exact=exact)
    return results


def tiny_card_vs_cpu(card):
    """Phase (c): the same seeded TINY detector on the card and the CPU."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import (
        PointPillarsDetector, synthetic_batch)
    outs = {}
    for dev in ('cuda', 'cpu'):
        det = PointPillarsDetector(TINY_MODEL, TINY_HEAD, device=dev, seed=1)
        with torch.no_grad():
            det.trunk.bbox_head.conv_cls.bias.zero_()
        batch = synthetic_batch(2, 1024, 8, seed=3,
                                pc_range=TINY_MODEL['point_cloud_range'],
                                device=dev)
        maps = [m.cpu() for m in det.apply_eval(batch)]
        dets = [d.cpu() for d in det.predict(batch)]
        outs[dev] = (maps, dets)
    anchors = det.anchors.reshape(-1, 7)
    (gm, gd), (cm, cd) = outs['cuda'], outs['cpu']
    map_err = max(float((a - b).abs().max()) for a, b in zip(gm, cm))
    valid_eq = torch.equal(gd[3], cd[3])
    labels_eq = valid_eq and torch.equal(gd[2][gd[3]], cd[2][cd[3]])
    print(f'(c) TINY predict card vs CPU: head-map max_abs_err={map_err:.3g} '
          f'(tol {MAP_TOL:g}) valid_equal={valid_eq} labels_equal={labels_eq} '
          f'valid={int(gd[3].sum())} [{card}]')
    check(map_err <= MAP_TOL, 'TINY head maps differ between card and CPU')
    check(valid_eq and labels_eq, 'TINY detections differ')
    check(int(gd[3].sum()) > 0, 'TINY predict kept no detection')
    ref = cd[0][cd[3]][:, :7]
    diff = (gd[0][gd[3]][:, :7] - ref).abs()
    diag = float(torch.sqrt(anchors[:, 3] ** 2 + anchors[:, 4] ** 2).max())
    height = float(anchors[:, 5].max())
    deriv = torch.stack([torch.full_like(ref[:, 0], diag),
                         torch.full_like(ref[:, 0], diag),
                         height + ref[:, 5].abs() / 2,
                         ref[:, 3].abs(), ref[:, 4].abs(), ref[:, 5].abs(),
                         torch.ones_like(ref[:, 0])], -1)
    tol = MAP_TOL * deriv + ROUND_TOL * ref.abs()
    for col, name in enumerate(('x', 'y', 'z', 'w', 'l', 'h', 'yaw')):
        i = int(diff[:, col].argmax())
        print(f'(c) TINY box {name}: max_abs_err={float(diff[i, col]):.3g} '
              f'at |box|={float(ref[i, col].abs()):.4g}, tol there '
              f'{float(tol[i, col]):.3g}; largest err/tol '
              f'{float((diff[:, col] / tol[:, col]).max()):.3g}')
    score_err = float((gd[1][gd[3]] - cd[1][cd[3]]).abs().max())
    print(f'(c) TINY scores max_abs_err={score_err:.3g} (tol 1e-5) [{card}]')
    check(bool((diff <= tol).all()), 'TINY boxes differ')
    check(score_err <= 1e-5, 'TINY scores differ')


def capture_train_inputs(det, batch, state):
    """Run one train step with the train-path kernel wrappers wrapped to
    record every call's arguments (K4: all 19 BatchNorms, forward and
    backward; K1 winner; K3 forward and backward)."""
    from mmdet3d_gaussian_tpu_torch.ops import bn, gd_loss, scatter
    seen = {}
    patches = [(bn, 'moments', 'bn_moments'),
               (bn, 'grad_moments', 'bn_grad_moments'),
               (scatter, 'segment_argmax', 'segment_argmax'),
               (gd_loss, 'gd_loss_fwd', 'gd_loss_fwd'),
               (gd_loss, 'gd_loss_bwd', 'gd_loss_bwd')]
    originals = []
    for mod, attr, name in patches:
        fn = getattr(mod, attr)
        originals.append((mod, attr, fn))

        def rec(*args, _fn=fn, _name=name):
            seen.setdefault(_name, []).append(args)
            return _fn(*args)
        setattr(mod, attr, rec)
    try:
        state, _ = det.train_step(batch, state)
        torch.cuda.synchronize()
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    want = {**TRAIN_LAUNCHES, **DENSE_LAUNCHES}
    check({k: len(v) for k, v in seen.items()} == want,
          f'captured {({k: len(v) for k, v in seen.items()})}, want {want}')
    return seen, state


def train_kernel_checks(inputs, card):
    """Phase (b), train kernels, on the inputs of one full-width dense
    train step.  K4's numbers are sums over the step's 19 calls."""
    from mmdet3d_gaussian_tpu_torch.ops import bn, gd_loss, segment
    results = {}

    # K1 winner form: the encoder's final per-voxel max (64 channels)
    ((data, starts, counts),) = inputs['segment_argmax']
    out, win = segment.segment_argmax(data, starts, counts)
    ref, ref_w = segment.segment_argmax_plain(data, starts, counts)
    exact = bool(torch.equal(out, ref) and torch.equal(win, ref_w))
    v, c = counts.shape[0], data.shape[1]
    rows = int(counts.sum())
    report(results, 'segment_argmax', card, float((out - ref).abs().max()),
           '0, winners equal', exact,
           lambda: segment.segment_argmax(data, starts, counts),
           lambda: segment.segment_argmax_plain(data, starts, counts), None,
           200, 5, data.numel() * 4 + v * 8 + v * c * 8, rows * c,
           f' exact_equal={exact}')

    # K4: every BatchNorm of the step; f32 sums in another order, each
    # held to 1e-5 of the per-channel sum of magnitudes
    def rows_of(t):
        return bn._channels_last_2d(t)

    def lib_bwd(g, x, mean, inv):
        return torch.batch_norm_backward_reduce(g, x, mean, inv, None, True,
                                                False, False)

    for name, calls in (('bn_moments', inputs['bn_moments']),
                        ('bn_grad_moments', inputs['bn_grad_moments'])):
        fwd = name == 'bn_moments'
        kern = bn.moments if fwd else bn.grad_moments
        plain = bn.moments_plain if fwd else bn.grad_moments_plain
        err = rel = 0.0
        bytes_ = ops = 0
        shapes = []
        for args in calls:
            x = args[0] if fwd else args[1]
            m, cc = rows_of(x).shape
            shapes.append(f'{m}x{cc}')
            got, want = kern(*args), plain(*args)
            if fwd:
                mags = (rows_of(x).abs().sum(0), (rows_of(x) ** 2).sum(0))
            else:
                g, _, mean, inv = args
                xhat = (rows_of(x) - mean) * inv
                mags = (rows_of(g).abs().sum(0),
                        (rows_of(g) * xhat).abs().sum(0))
            for a, b, mag in zip(got, want, mags):
                err = max(err, float((a - b).abs().max()))
                rel = max(rel, float(((a - b).abs() / mag.clamp(
                    min=1e-30)).max()))
            bytes_ += (1 if fwd else 2) * m * cc * 4 + (2 if fwd else 4) \
                * cc * 4
            ops += (2 if fwd else 4) * m * cc
        print(f'(b) {name}: {len(calls)} calls of one step, rows x '
              f'channels {shapes}; max error / per-channel sum of '
              f'magnitudes {rel:.3g}')

        def lib(fwd=fwd, calls=calls):
            for args in calls:
                if fwd:
                    x = args[0]
                    torch.var_mean(x, (0, 2, 3) if x.dim() == 4 else (0,),
                                   correction=0)
                else:
                    lib_bwd(*args)
        report(results, name, card, err, '1e-5 of the sum of magnitudes',
               rel <= 1e-5, lambda k=kern, c=calls: [k(*a) for a in c],
               lambda p=plain, c=calls: [p(*a) for a in c], lib, 20, 3,
               bytes_, ops, ' (times, bytes and bound summed over the '
               'step)')

    # K3: the dense decoded-box GD loss and its d(pred)
    ((pred2, tgt2, w_a, anc2, hw, cfg),) = inputs['gd_loss_fwd']
    ((gout, *_),) = inputs['gd_loss_bwd']
    # The function reads every weight and, of the rest, only what the
    # weighted anchors need: pred, target and anchor (21 floats) where
    # w > 0, target and anchor (14) where w < 0; an anchor with w == 0 adds
    # 0 and has a 0 gradient.  The backward writes every gradient row.
    m, k7 = pred2.shape
    anchors = m * k7 // 7
    n_pos = int((w_a > 0).sum())
    n_neg = int(((w_a != 0) & ~(w_a > 0)).sum())
    print(f'(b) gd_loss inputs: {m} rows x {k7 // 7} anchors, config {cfg}, '
          f'{n_pos} anchors with weight > 0, {n_neg} with weight < 0')
    check(n_pos > 0, 'no positive anchor in the dense step')
    args = (tgt2, w_a, anc2, hw, cfg)
    got = gd_loss.gd_loss_fwd(pred2, *args)
    want = gd_loss.anchor_gd_loss_plain(pred2, *args)
    err = abs(float(got) - float(want))
    in_bytes = (anchors + 21 * n_pos + 14 * n_neg) * 4
    report(results, 'gd_loss_fwd', card, err, '1e-5 relative',
           err <= 1e-5 * abs(float(want)),
           lambda: gd_loss.gd_loss_fwd(pred2, *args),
           lambda: gd_loss.anchor_gd_loss_plain(pred2, *args), None, 50, 5,
           in_bytes + 4,
           anchors + (n_pos + n_neg) * GD_OPS_PER_ANCHOR)
    dgot = gd_loss.gd_loss_bwd(gout, pred2, *args)
    dwant = gd_loss.gd_loss_bwd_plain(gout, pred2, *args)
    diff = (dgot - dwant).abs()
    report(results, 'gd_loss_bwd', card, float(diff.max()),
           '5e-6 + 1e-4 |plain|', bool((diff <= 5e-6 + 1e-4 * dwant.abs())
                                        .all()),
           lambda: gd_loss.gd_loss_bwd(gout, pred2, *args),
           lambda: gd_loss.gd_loss_bwd_plain(gout, pred2, *args), None, 50,
           5, (anchors + 21 * n_pos + 7 * anchors + 1) * 4,
           anchors + n_pos * 3 * GD_OPS_PER_ANCHOR)
    return results


def tiny_train_card_vs_cpu(card):
    """Phase (c): one TINY train step (sparse targets) from the same seed,
    weights and batch on the card and on the CPU: loss terms, every
    parameter gradient, and after the AdamW step the running statistics,
    Adam's moments and the weights.

    Adam's first step moves a weight by lr * (g / (|g| + eps) + wd * w):
    about lr whatever |g|, so where g is near 0 a tiny gradient difference
    may move the weight either way.  The weights are therefore held tightly
    only where |mu| (the clipped gradient times 1 - b1) is at least 1e-2 of
    its parameter's largest, far above the gradient tolerance, so card and
    CPU agree on its sign; there a sign flip or a dropped update (lr apart)
    fails a tolerance of 1e-2 lr."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import (
        PointPillarsDetector, synthetic_batch)
    out = {}
    for dev in ('cuda', 'cpu'):
        det = PointPillarsDetector(TINY_MODEL, TINY_HEAD, device=dev, seed=2)
        batch = synthetic_batch(2, 1024, 8, seed=0,
                                pc_range=TINY_MODEL['point_cloud_range'],
                                device=dev)
        total, losses = det.loss(det.apply_train(batch), batch)
        params = dict(det.trunk.named_parameters())
        grads = torch.autograd.grad(total, list(params.values()))
        state = det.init_train(LR, total_steps=100)
        state, _ = det.train_step(batch, state)
        out[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                    {k: g.cpu() for k, g in zip(params, grads)},
                    {k: v.detach().cpu().float()
                     for k, v in det.trunk.state_dict().items()},
                    {k: (state.opt_state.mu[k].cpu(),
                         state.opt_state.nu[k].cpu()) for k in params})
    (lc, gc, sc, mc), (lp, gp, sp, mp) = out['cuda'], out['cpu']
    check(min(lp.values()) > 0, f'a TINY loss term is 0: {lp}')
    loss_rel = max(abs(lc[k] - lp[k]) / abs(lp[k]) for k in lp)
    grad_rel = max(float((gc[k] - gp[k]).abs().max() / gp[k].abs().max())
                   for k in gp)
    stat_err = max(float((sc[k] - sp[k]).abs().max()) for k in sp
                   if 'running' in k)
    mu_rel = max(float((mc[k][0] - mp[k][0]).abs().max()
                       / mp[k][0].abs().max()) for k in mp)
    nu_rel = max(float((mc[k][1] - mp[k][1]).abs().max()
                       / mp[k][1].abs().max()) for k in mp)
    w_err, w_all, n_sel, n_all = 0.0, 0.0, 0, 0
    for k in mp:
        mu = mp[k][0].abs()
        sel = (mu >= 1e-2 * mu.max()) & (mu > 1e-6)
        diff = (sc[k] - sp[k]).abs()
        w_err = max(w_err, float(diff[sel].max()))
        w_all = max(w_all, float(diff.max()))
        n_sel, n_all = n_sel + int(sel.sum()), n_all + sel.numel()
    print(f'(c) TINY train step card vs CPU: loss terms {lc} vs {lp}, '
          f'largest relative error {loss_rel:.3g} (tol 1e-4); gradients '
          f'max error / max |grad| per parameter {grad_rel:.3g} (tol 1e-4); '
          f'running statistics max_abs_err {stat_err:.3g} (tol 1e-4); '
          f'Adam mu and nu max error / max per parameter {mu_rel:.3g} and '
          f'{nu_rel:.3g} (tol 1e-4, 2e-4); weights after the step where '
          f'|mu| >= 1e-2 max ({n_sel} of {n_all}) max_abs_err {w_err:.3g} '
          f'(tol {1e-2 * LR:g}), all weights {w_all:.3g} (lr {LR:g}) '
          f'[{card}]')
    check(loss_rel <= 1e-4, 'TINY train losses differ')
    check(grad_rel <= 1e-4, 'TINY train gradients differ')
    check(stat_err <= 1e-4, 'TINY running statistics differ')
    check(mu_rel <= 1e-4 and nu_rel <= 2e-4, 'TINY Adam moments differ')
    check(w_err <= 1e-2 * LR, 'TINY weights after the step differ')
    check(w_all <= 2.5 * LR, 'a TINY weight moved more than one Adam step')


def train_path(det, dense_det, batch, state, dense_state, card):
    """Phase (t): the full-width train path on one repeated batch."""
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    rows, times = [], []

    def step(d, st):
        t0 = time.perf_counter()
        st, metrics = d.train_step(batch, st)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows.append({k: float(v) for k, v in metrics.items()})
        return st

    for _ in range(WARM_STEPS):
        state = step(det, state)
    times.clear()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    for _ in range(TIMED_STEPS):
        state = step(det, state)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for i, r in enumerate(rows):
        print(f'(t) step {i} {json.dumps(r)}')
        check(all(map(math.isfinite, r.values())), 'non-finite loss')
    check(rows[-1]['loss'] < rows[0]['loss'],
          'the loss on a repeated batch did not go down')
    print(f'(t) main path: {TIMED_STEPS} timed train steps, launches '
          f'{launches}')
    for name, per in TRAIN_LAUNCHES.items():
        check(launches[name] == per * TIMED_STEPS,
              f'{name} launched {launches[name]} times in {TIMED_STEPS} '
              f'steps, want {per} per step')
    med = statistics.median(times)
    print(f'(t) train step median {med * 1e3:.3f} ms (min '
          f'{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) over '
          f'{TIMED_STEPS} steps of {BATCH}x{POINTS} points; '
          f'{BATCH * POINTS / med:.0f} points/s; max_memory_allocated '
          f'{peak / 2**20:.1f} MiB; loss {rows[0]["loss"]:.4f} -> '
          f'{rows[-1]["loss"]:.4f} [{card}]')
    summary = dict(step_ms=med * 1e3, step_min_ms=min(times) * 1e3,
                   step_max_ms=max(times) * 1e3, points_per_s=BATCH * POINTS
                   / med, peak_mib=peak / 2**20)

    rows.clear()
    _cuda.reset_launches()
    for _ in range(DENSE_STEPS):
        dense_state = step(dense_det, dense_state)
    dense_launches = dict(_cuda.LAUNCHES)
    for i, r in enumerate(rows):
        print(f'(t) dense step {i} {json.dumps(r)}')
        check(all(map(math.isfinite, r.values())), 'non-finite dense loss')
    print(f'(t) dense targets: {DENSE_STEPS} steps, launches '
          f'{dense_launches}, median {statistics.median(times[-DENSE_STEPS:]) * 1e3:.3f} ms')
    for name, per in {**TRAIN_LAUNCHES, **DENSE_LAUNCHES}.items():
        check(dense_launches[name] == per * DENSE_STEPS,
              f'{name} launched {dense_launches[name]} times in '
              f'{DENSE_STEPS} dense steps, want {per} per step')
    summary['dense_step_ms'] = statistics.median(times[-DENSE_STEPS:]) * 1e3
    return launches, dense_launches, state, summary


def main_path(det, batches, card):
    """Phase (d): the full-width predict path answering requests."""
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, outs = [], []
    _cuda.reset_launches()
    for _ in range(ROUNDS):
        for batch in batches:
            t0 = time.perf_counter()
            out = det.predict(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            outs.append(out)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_req = len(times)
    print(f'(d) main path: {n_req} predicts, launches {launches}')
    for name, (_, _, path) in KERNELS.items():
        if path == 'predict':
            check(launches[name] == n_req, f'{name} launched '
                  f'{launches[name]} times in {n_req} predicts')
    for boxes, scores, labels, valid in outs:
        check(tuple(boxes.shape) == (BATCH, 100, 7), 'boxes shape')
        check(bool(torch.isfinite(boxes).all()
                   and torch.isfinite(scores).all()), 'non-finite output')
        check(bool(valid.any(dim=1).all()), 'a sample kept no detection')
        check(bool(((labels >= 0) & (labels < 3)).all()), 'labels range')
    med = statistics.median(times)
    print(f'(d) predict latency median {med * 1e3:.3f} ms '
          f'(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) over '
          f'{n_req} requests of {BATCH}x{POINTS} points; '
          f'{BATCH * POINTS / med:.0f} points/s; max_memory_allocated '
          f'{peak / 2**20:.1f} MiB [{card}]')
    return launches, dict(latency_ms=med * 1e3, points_per_s=BATCH * POINTS
                          / med, peak_mib=peak / 2**20)


def nms_counts(det, batch):
    """Valid NMS candidates and suppressions per (sample, class) of one
    request (run after the main path's counts were read)."""
    from mmdet3d_gaussian_tpu_torch.ops.nms import nms_bev
    with torch.inference_mode():
        cls, bbox, dirp = det.apply_eval(batch)[:3]
        b_sorted, _, v_sorted = det.head.select_candidates(
            cls, bbox, dirp, det.anchors)
        b, c, k = v_sorted.shape
        keep = nms_bev(b_sorted[..., [0, 1, 3, 4, 6]].reshape(b * c, k, 5),
                       det.head.test_cfg['nms_thr'],
                       v_sorted.reshape(b * c, k)).reshape(b, c, k)
    valid = v_sorted.sum(-1).cpu()
    kept = keep.sum(-1).cpu()
    print(f'(d) NMS valid candidates per sample x class {valid.tolist()}, '
          f'kept {kept.tolist()}, suppressed {int((valid - kept).sum())}')
    check(bool((valid > 0).any(dim=1).all()),
          'a sample has no valid NMS candidate')
    check(int((valid - kept).sum()) > 0, 'the sweep suppressed nothing')


def device_profile(run, what, tag, card, iters):
    """Where the device time of ``run()`` goes: ``torch.profiler`` over
    ``iters`` back-to-back calls (after the main path's counts were read).
    Prints the device-busy share of the wall time (the union of kernel
    intervals) and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    spans, per_kernel = cuda_spans(prof), {}
    for start, end, name in spans:
        ms, calls = per_kernel.get(name, (0.0, 0))
        per_kernel[name] = (ms + (end - start) / 1e3 / iters,
                            calls + 1 / iters)
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, _ in sorted(spans):
        if cur_end is not None and start <= cur_end:
            cur_end = max(cur_end, end)
            continue
        if cur_end is not None:
            busy += cur_end - cur_start
        cur_start, cur_end = start, end
    if cur_end is not None:
        busy += cur_end - cur_start
    busy = busy / 1e3 / iters
    if busy == 0:
        print(f'{tag} profile: no device time recorded; busy share not '
              f'measured')
        return {}
    print(f'{tag} profile of {iters} back-to-back {what}s (profiler on): '
          f'{wall:.3f} ms wall and {busy:.3f} ms device busy per {what}, '
          f'idle share {100 * (1 - busy / wall):.1f}% [{card}]')
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (ms, calls) in top[:20]:
        print(f'{tag} profile: {ms:9.4f} ms {calls:6.1f} launches per '
              f'{what}  {name[:100]}')
    return dict(profiled_wall_ms=wall, device_busy_ms=busy,
                idle_share=1 - busy / wall)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the card',
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from mmdet3d_gaussian_tpu_torch.engine.detector import (
        PointPillarsDetector, synthetic_batch)
    from mmdet3d_gaussian_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f'card: {card}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}; f32 with TF32 off (matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, cudnn '
          f'{torch.backends.cudnn.allow_tf32})')

    # (a) build
    _cuda.library()
    info = _cuda.BUILD_INFO
    print(f'(a) build: {"nvcc + link" if info["built"] else "cached"} '
          f'{info["seconds"]:.2f} s -> {os.path.relpath(info["path"], root)}')
    for kern, text in _cuda.ptxas_summary(info['ptxas']).items():
        print(f'(a) ptxas {kern}: {text}')

    # full-width detector and requests
    det = PointPillarsDetector(dict(voxelize_mode='dynamic'), device='cuda',
                               seed=0)
    with torch.no_grad():
        det.trunk.bbox_head.conv_cls.bias.zero_()
    batches = [synthetic_batch(BATCH, POINTS, 16, seed=s, device='cuda')
               for s in SEEDS]
    with torch.inference_mode():
        _, _, scatter = det.trunk.pillars(batches[0]['points'],
                                          batches[0]['points_mask'])
        print(f'(d) voxels {int(scatter.num_voxels)} of capacity '
              f'{scatter.max_voxels}, overflow {int(scatter.num_overflow)}')
        inputs = capture_inputs(det, batches[0])
        results = kernel_checks(inputs, card)          # (b) predict
    del inputs

    # full-width trainers from one seed: sparse targets (the default) and
    # dense targets (pos_cap=0, the decoded-box loss through K3)
    tdet = PointPillarsDetector(dict(voxelize_mode='dynamic'),
                                device='cuda', seed=0)
    ddet = PointPillarsDetector(dict(voxelize_mode='dynamic'),
                                dict(pos_cap=0), device='cuda', seed=0)
    tbatch = batches[0]
    tstate = tdet.init_train(LR, total_steps=100)
    dstate = ddet.init_train(LR, total_steps=100)
    dstate, _ = ddet.train_step(tbatch, dstate)        # warm-up
    train_inputs, dstate = capture_train_inputs(ddet, tbatch, dstate)
    with torch.no_grad():
        results.update(train_kernel_checks(train_inputs, card))  # (b) train
    del train_inputs
    torch.cuda.empty_cache()
    tiny_card_vs_cpu(card)                             # (c)
    tiny_train_card_vs_cpu(card)
    launches, e2e = main_path(det, batches, card)      # (d)
    nms_counts(det, batches[-1])
    e2e.update(device_profile(lambda: det.predict(batches[0]), 'predict',
                              '(d)', card, 5))
    launches_t, launches_d, tstate, train = train_path(   # (t)
        tdet, ddet, tbatch, tstate, dstate, card)
    holder = [tstate]

    def one_step():
        holder[0] = tdet.train_step(tbatch, holder[0])[0]
    train.update(device_profile(one_step, 'train step', '(t)', card, 3))

    kernels = []                                       # (e)
    counts = {'predict': (launches, len(SEEDS) * ROUNDS, 'predict'),
              'train': (launches_t, TIMED_STEPS, 'step'),
              'train_dense': (launches_d, DENSE_STEPS, 'dense step')}
    for name, (source, replaces, path) in KERNELS.items():
        r = results[name]
        runs, n, unit = counts[path]
        kernels.append(dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=runs[name], path=path,
            launches_per=f'{runs[name] / n:g} per {unit}',
            max_abs_err=r['max_abs_err'], ms=r['ms'], call_ms=r['call_ms'],
            plain_ms=r['plain_ms'],
            bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            library_ms=r['library_ms'], bytes=r['bytes'],
            operations=r['operations']))
    print(f'(e) predict summary {json.dumps(e2e)} [{card}]')
    print(f'(e) train summary {json.dumps(train)} [{card}]')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
