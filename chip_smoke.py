#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing its own lines (any failure exits non-zero):
  (a) build every CUDA kernel from ``mmdet3d_gaussian_tpu_torch/csrc``;
      nvcc time and ptxas registers / spills per kernel;
  (b) each kernel against its plain PyTorch version on the card, on the
      exact inputs the full-width predict path hands it (captured from one
      warm-up predict): max error, CUDA-event times of kernel, plain version
      and a one-call library yardstick where PyTorch has one, and the bound;
  (c) TINY predict on the card against the same port on the CPU;
  (d) the main path: PointPillars KITTI 3-class at full width (dynamic
      voxelize, batch 4 x 16384 points, random weights from a seed with a
      zero cls bias so scores clear the threshold) answering 9 requests
      (3 batches x 3 rounds); launch counts are zeroed just before and read
      just after, and every kernel must have run; then NMS candidate and
      suppression counts, and a torch.profiler run of 5 more predicts for
      the device-busy share and the kernels with the most device time;
  (e) one JSON line listing the kernels, the card's name and power limit
      from nvidia-smi, and the result line.

All phases run in f32 with TF32 off for matmuls and cuDNN convolutions.
The script exits non-zero, printing no result, without a CUDA device or
outside a checkout of the repository.
"""
from __future__ import annotations

import json
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

TPU = 'mmdet3d_gaussian_tpu/ops/pallas/'
KERNELS = {
    'segment_reduce': ('mmdet3d_gaussian_tpu_torch/csrc/segment_reduce.cu',
                       TPU + 'segment_kernel.py:171'),
    'segment_reduce_mapback': (
        'mmdet3d_gaussian_tpu_torch/csrc/segment_reduce.cu',
        TPU + 'segment_kernel.py:171'),
    'bev_splat': ('mmdet3d_gaussian_tpu_torch/csrc/bev_splat.cu',
                  TPU + 'bev_splat_kernel.py:218'),
    'rotated_iou': ('mmdet3d_gaussian_tpu_torch/csrc/rotated_iou.cu',
                    TPU + 'rotated_iou_kernel.py:166'),
    'nms_sweep': ('mmdet3d_gaussian_tpu_torch/csrc/nms_sweep.cu',
                  TPU + 'nms_kernel.py:37'),
}

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
BATCH, POINTS, SEEDS, ROUNDS = 4, 16384, (0, 1, 2), 3


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
    check(set(seen) == set(KERNELS), f'captured only {sorted(seen)}')
    return seen


def kernel_checks(inputs, card):
    """Phase (b): each kernel vs its plain version on the captured inputs."""
    from mmdet3d_gaussian_tpu_torch.ops import nms, rotated_iou, segment
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    results = {}

    def record(name, kernel, plain, library, err, tol, bytes_, ops, iters,
               plain_iters, exact=None):
        ms = cuda_ms(kernel, iters)
        plain_ms = cuda_ms(plain, plain_iters, warmup=1)
        library_ms = cuda_ms(library, iters) if library else None
        t_bytes, t_ops = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
        results[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by='bytes' if t_bytes >= t_ops else 'operations',
            bytes=bytes_, operations=ops)
        eq = '' if exact is None else f' exact_equal={exact}'
        lib = 'none' if library_ms is None else f'{library_ms:.4f} ms'
        print(f'(b) {name}: max_abs_err={err:.3g} (tol {tol:g}){eq} '
              f'kernel={ms:.4f} ms plain={plain_ms:.4f} ms library={lib} '
              f'bound={results[name]["bound_ms"]:.4f} ms '
              f'({results[name]["bound_by"]}) [{card}]')
        check(err <= tol, f'{name}: kernel disagrees with plain version')
        if exact is not None:
            check(exact, f'{name}: kernel output not equal to plain')

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
    for name in KERNELS:
        check(launches[name] == n_req,
              f'{name} launched {launches[name]} times in {n_req} predicts')
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


def device_profile(det, batch, card, iters=5):
    """Where a predict's device time goes: ``torch.profiler`` over ``iters``
    back-to-back predicts (run after the main path's counts were read).
    Prints the device-busy share of the wall time (the union of kernel
    intervals) and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                det.predict(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
    spans, per_kernel = [], {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        ms, calls = per_kernel.get(evt.name, (0.0, 0))
        per_kernel[evt.name] = (ms + (end - start) / 1e3 / iters,
                                calls + 1 / iters)
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
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
        print('(d) profile: no device time recorded; busy share not measured')
        return {}
    print(f'(d) profile of {iters} back-to-back predicts (profiler on): '
          f'{wall:.3f} ms wall and {busy:.3f} ms device busy per predict, '
          f'idle share {100 * (1 - busy / wall):.1f}% [{card}]')
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (ms, calls) in top[:15]:
        print(f'(d) profile: {ms:9.4f} ms {calls:5.1f} launches per predict  '
              f'{name[:100]}')
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
        results = kernel_checks(inputs, card)          # (b)
    del inputs
    torch.cuda.empty_cache()
    tiny_card_vs_cpu(card)                             # (c)
    launches, e2e = main_path(det, batches, card)      # (d)
    nms_counts(det, batches[-1])
    e2e.update(device_profile(det, batches[0], card))

    kernels = []                                       # (e)
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append(dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=launches[name],
            launches_per_predict=launches[name] // (len(SEEDS) * ROUNDS),
            max_abs_err=r['max_abs_err'], ms=r['ms'], plain_ms=r['plain_ms'],
            bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            library_ms=r['library_ms'], bytes=r['bytes'],
            operations=r['operations']))
    print(f'(e) predict summary {json.dumps(e2e)} [{card}]')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
