#!/usr/bin/env python3
"""Per-call time of the predict path's kernel wrappers (K1 reduce and
mapback, K2, K7, K5, K6) on one CUDA card, on the arguments the full-width
KITTI predicts hand them: the f32 dynamic predict on the plain canvas and
the bf16 one on the s2d canvas, as ``chip_smoke.py`` phase (b) times them.

    python3 op_host_time.py [--other CHECKOUT]

``--other`` also imports the port of another checkout (an earlier commit
unpacked with ``git archive`` into a git-ignored directory) as a second
package, and times both in the same process on the same tensors, in
alternating order round by round, so that the host's drift falls on both
alike.  Per wrapper and version it prints ``call_ms`` (CUDA events around
back-to-back calls, as phase (b)'s "per call on the host clock": the
larger of the host's and the card's time a call) and the host time a call
(``time.perf_counter`` around the same calls, nothing synchronised between
them), each the median of the rounds, and this checkout's minus the
other's.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import torch

BATCH, POINTS, ROUNDS = 4, 16384, 30
# back-to-back calls a round: phase (b)'s iterations of each kernel
CALLS = dict(segment_reduce=200, segment_reduce_mapback=200, bev_splat=50,
             bev_splat_pairs=50, rotated_iou=20, nms_sweep=50)
# phase (b)'s full-width models and the autograd mode it times them in
MODELS = (('f32', dict(voxelize_mode='dynamic', s2d_canvas='off'),
           torch.inference_mode),
          ('bf16', dict(voxelize_mode='dynamic', compute_dtype='bfloat16'),
           torch.no_grad))
ROOT = os.path.dirname(os.path.abspath(__file__))


def load_port(root: str, name: str):
    """The port of checkout ``root``, imported as package ``name`` (its
    kernels build under that checkout's ``build/``)."""
    pkg = os.path.join(root, 'mmdet3d_gaussian_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, '__init__.py'),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    for sub in ('ops.segment', 'ops.voxelize', 'ops.rotated_iou', 'ops.nms',
                'ops.scatter', 'engine.detector'):
        importlib.import_module(f'{name}.{sub}')
    return mod


def wrappers(port):
    """{kernel: the public wrapper phase (b) calls} of one port."""
    ops = port.ops
    return dict(segment_reduce=ops.segment.segment_reduce,
                segment_reduce_mapback=ops.segment.segment_reduce_mapback,
                bev_splat=ops.voxelize.bev_splat,
                bev_splat_pairs=ops.voxelize.bev_splat_pairs,
                rotated_iou=ops.rotated_iou.iou_bev_pairwise,
                nms_sweep=ops.nms.suppress_sweep)


def predict_args(port, model, mode):
    """The first arguments of each kernel wrapper in one predict of the
    full-width detector ``model`` (seed 0, cls biases zeroed)."""
    det = port.engine.detector.PointPillarsDetector(model, device='cuda',
                                                    seed=0)
    with torch.no_grad():
        det.trunk.bbox_head.conv_cls.bias.zero_()
    batch = port.engine.detector.synthetic_batch(BATCH, POINTS, 16, seed=0,
                                                 device='cuda')
    ops = port.ops
    patches = [(ops.scatter, 'segment_reduce', 'segment_reduce'),
               (ops.scatter, 'segment_reduce_mapback',
                'segment_reduce_mapback'),
               (ops.voxelize, 'bev_splat', 'bev_splat'),
               (ops.voxelize, 'bev_splat_pairs', 'bev_splat_pairs'),
               (ops.nms, 'iou_bev_pairwise', 'rotated_iou'),
               (ops.nms, 'suppress_sweep', 'nms_sweep')]
    seen, originals = {}, []
    for mod, attr, name in patches:
        fn = getattr(mod, attr)
        originals.append((mod, attr, fn))

        def rec(*args, _fn=fn, _name=name):
            seen.setdefault(_name, args)
            return _fn(*args)
        setattr(mod, attr, rec)
    try:
        with mode():
            det.predict(batch)
        torch.cuda.synchronize()
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    return seen


def time_round(fn, calls):
    """(CUDA-event ms a call, host us a call) of ``calls`` back-to-back
    calls."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls, (t1 - t0) * 1e6 / calls


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--other', help='checkout whose port is timed too')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('op_host_time: no CUDA device', file=sys.stderr)
        return 1
    versions = {'this': load_port(ROOT, 'port_this')}
    if args.other:
        versions['other'] = load_port(os.path.abspath(args.other),
                                      'port_other')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = dict(card=card, other=args.other)
    for tag, model, mode in MODELS:
        seen = predict_args(versions['this'], model, mode)
        for name, call_args in seen.items():
            fns = {v: (lambda w=wrappers(p)[name]: w(*call_args))
                   for v, p in versions.items()}
            results = {}
            with mode():
                for fn in fns.values():
                    outs = [fn() for _ in range(2)]
                if len(fns) == 2:
                    a, b = (fn() for fn in fns.values())
                    if not torch.equal(a, b):
                        print(f'{tag} {name}: the versions disagree',
                              file=sys.stderr)
                        return 1
                del outs
                event = {v: [] for v in fns}
                host = {v: [] for v in fns}
                order = list(fns)
                for r in range(ROUNDS):
                    for v in (order if r % 2 == 0 else order[::-1]):
                        ms, us = time_round(fns[v], CALLS[name])
                        event[v].append(ms)
                        host[v].append(us)
            for v in fns:
                results[v] = dict(call_ms=statistics.median(event[v]),
                                  host_us=statistics.median(host[v]))
            line = ', '.join(f'{v}: call_ms {r["call_ms"]:.4f}, host '
                             f'{r["host_us"]:.2f} us' for v, r in
                             results.items())
            if 'other' in results:
                results['diff'] = dict(
                    call_ms=results['this']['call_ms']
                    - results['other']['call_ms'],
                    host_us=results['this']['host_us']
                    - results['other']['host_us'])
                line += (f'; this - other: call_ms '
                         f'{results["diff"]["call_ms"]:+.4f}, host '
                         f'{results["diff"]["host_us"]:+.2f} us')
            print(f'{tag} {name}: {line} ({CALLS[name]} calls a round, '
                  f'median of {ROUNDS} rounds in turns) [{card}]')
            out[f'{tag} {name}'] = results
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
