"""Summarize a ``torch.profiler`` Chrome trace: device time by category
and by kernel (the port's counterpart of the JAX package's
``tools/misc/profile_top_ops.py``, which reads xplane files).

    python -m mmdet3d_gaussian_tpu_torch.tools.misc.summarize_trace \
        TRACE.json [--steps N] [--top K]

Reads the ``trace.json`` that ``engine/profiling.py::trace`` writes.
Device events are the complete events ("ph": "X") of the categories in
:data:`DEVICE_CATEGORIES` (kernels, copies, fills); each is counted once,
so overlapping streams add up.  ``--steps`` divides every total by the
number of profiled calls, so the numbers read as ms per call.  Kernels
are also grouped into families (:func:`family`): the port's hand kernels,
convolutions and matrix products, and the rest.  A trace without device
events (a CPU run) is summarized by its host operators instead (nested
operators overlap there, so the host total counts time more than once).
"""
from __future__ import annotations

import argparse
import json
import re
from collections import defaultdict
from typing import Dict, Optional, Sequence

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATEGORIES = ('cpu_op',)
# the __global__ functions of mmdet3d_gaussian_tpu_torch/csrc (K1 three
# forms, K2 and K7, K3 both ways, K4's two bodies, K5, K6 pack and sweep,
# the empty kernel), as the profiler names them
PORT_KERNELS = re.compile(
    r'(?:^|[\s:])(segment_reduce|segment_mapback|segment_max_winner|splat|'
    r'gd_loss_fwd|gd_loss_bwd|planes|rows|rotated_iou|nms_pack|nms_sweep|'
    r'empty)_kernel\b')
CONV_GEMM = re.compile(r'gemm|conv|cutlass|cudnn|sm90_|sm80_|implicit|'
                       r'wgrad|dgrad|fft|xmma', re.I)


def family(name: str, cat: str) -> str:
    """'port kernel', 'conv/gemm', 'copy/fill' or 'other'."""
    if cat != 'kernel':
        return 'copy/fill'
    if PORT_KERNELS.search(name):
        return 'port kernel'
    if CONV_GEMM.search(name):
        return 'conv/gemm'
    return 'other'


def summarize(path: str, steps: int = 1) -> Dict[str, object]:
    """-> dict(device: bool, by_category {cat: ms}, by_family {family:
    ms}, by_name {name: (ms, calls)}, total_ms), every number per step;
    host operators (``cpu_op``) where the trace has no device event."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    complete = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    dev = [e for e in complete if e.get('cat') in DEVICE_CATEGORIES]
    rows = dev or [e for e in complete if e.get('cat') in HOST_CATEGORIES]
    by_cat, by_fam = defaultdict(float), defaultdict(float)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in rows:
        ms = e['dur'] / 1e3 / steps
        by_cat[e['cat']] += ms
        by_name[e['name']][0] += ms
        by_name[e['name']][1] += 1
        if dev:
            by_fam[family(e['name'], e['cat'])] += ms
    return dict(device=bool(dev), by_category=dict(by_cat),
                by_family=dict(by_fam),
                by_name={k: (v[0], v[1] / steps) for k, v in by_name.items()},
                total_ms=sum(by_cat.values()))


def report(summary: Dict[str, object], top: int = 20) -> str:
    what = 'device' if summary['device'] else \
        'host (no device event in the trace)'
    lines = [f'{what} time {summary["total_ms"]:.4f} ms per step']
    for title, table in (('category', summary['by_category']),
                         ('family', summary['by_family'])):
        for k, ms in sorted(table.items(), key=lambda kv: -kv[1]):
            lines.append(f'  {title} {k:<14} {ms:10.4f} ms')
    ranked = sorted(summary['by_name'].items(), key=lambda kv: -kv[1][0])
    for name, (ms, calls) in ranked[:top]:
        lines.append(f'  {ms:10.4f} ms {calls:7.1f} calls  {name[:100]}')
    return '\n'.join(lines)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('trace')
    p.add_argument('--steps', type=int, default=1)
    p.add_argument('--top', type=int, default=20)
    args = p.parse_args(argv)
    summary = summarize(args.trace, args.steps)
    print(report(summary, args.top))
    return summary


if __name__ == '__main__':
    main()
