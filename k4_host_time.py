#!/usr/bin/env python3
"""Host time of the K4 wrappers (``ops.bn.moments`` and ``grad_moments``)
on one CUDA card, at the 19 BatchNorm shapes of the KITTI batch-4
PointPillars train step (channels-last activations, f32 and bf16).

    python3 k4_host_time.py [--other CHECKOUT]

``--other`` also imports the port of another checkout (an earlier commit
unpacked with ``git archive`` into a git-ignored directory) as a second
package, and times both in the same process, in alternating order round
by round, so that the host's drift falls on both alike.  Per call and
version it prints the host time (``time.perf_counter`` around the 19
calls of a step, nothing synchronised between them: the wrapper's Python
and launch work; median of the rounds) and the time on CUDA events over
the same 19 calls, which is the larger of that host time and the
kernels' device time.
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

# (channels, H, W, BatchNorms) of the step: SECOND's three stages (1 + 3,
# 1 + 5, 1 + 5 convolutions) and SECONDFPN's three deblocks, at batch 4 on
# the 496 x 432 canvas
SHAPES = ((64, 248, 216, 4), (128, 124, 108, 6), (256, 62, 54, 6),
          (128, 248, 216, 3))
BATCH, ROUNDS = 4, 60
ROOT = os.path.dirname(os.path.abspath(__file__))


def load_bn(root: str, name: str):
    """``ops.bn`` of the port in checkout ``root``, imported as package
    ``name`` (its kernels build under that checkout's ``build/``)."""
    pkg = os.path.join(root, 'mmdet3d_gaussian_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, '__init__.py'),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + '.ops.bn')


def step_calls(dtype, gen):
    calls = []
    for c, h, w, n in SHAPES:
        for _ in range(n):
            x = torch.randn((BATCH, c, h, w), device='cuda',
                            generator=gen).to(dtype).contiguous(
                                memory_format=torch.channels_last)
            calls.append((x, torch.randn_like(x),
                          torch.zeros(c, device='cuda'),
                          torch.ones(c, device='cuda')))
    return calls


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--other', help='checkout whose port is timed too')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('k4_host_time: no CUDA device', file=sys.stderr)
        return 1
    versions = {'this': load_bn(ROOT, 'port_this')}
    if args.other:
        versions['other'] = load_bn(os.path.abspath(args.other),
                                    'port_other')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device='cuda').manual_seed(0)
    out = dict(card=card, other=args.other)
    for dtype in (torch.float32, torch.bfloat16):
        calls = step_calls(dtype, gen)
        for name in ('moments', 'grad_moments'):
            fns = {}
            for v, bn in versions.items():
                fns[v] = ((lambda a, bn=bn: bn.moments(a[0]))
                          if name == 'moments' else
                          (lambda a, bn=bn: bn.grad_moments(a[1], a[0],
                                                            a[2], a[3])))
                for a in calls:
                    fns[v](a)
            torch.cuda.synchronize()
            host = {v: [] for v in fns}
            event = {v: [] for v in fns}
            order = list(fns)
            for r in range(ROUNDS):
                for v in (order if r % 2 == 0 else order[::-1]):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    t0 = time.perf_counter()
                    for a in calls:
                        fns[v](a)
                    t1 = time.perf_counter()
                    end.record()
                    torch.cuda.synchronize()
                    host[v].append((t1 - t0) * 1e6 / len(calls))
                    event[v].append(start.elapsed_time(end) * 1e3
                                    / len(calls))
            for v in fns:
                key = f'{name}_{str(dtype)[6:]}_{v}'
                out[key] = dict(host_us=statistics.median(host[v]),
                                event_us=statistics.median(event[v]))
                print(f'{key}: host {out[key]["host_us"]:.2f} us a call, '
                      f'CUDA events {out[key]["event_us"]:.2f} us a call '
                      f'({len(calls)} calls, median of {ROUNDS} rounds) '
                      f'[{card}]')
            if 'other' in fns:
                ratio = statistics.median(
                    a / b for a, b in zip(host['this'], host['other']))
                out[f'{name}_{str(dtype)[6:]}_host_ratio'] = ratio
                print(f'{name} {str(dtype)[6:]}: host time this / other, '
                      f'median over rounds {ratio:.3f} [{card}]')
        del calls
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
