#!/usr/bin/env python3
"""K6 (the NMS suppression sweep, ``ops.nms.suppress_sweep``) on one CUDA
card: the f32 predict's inputs (captured from one full-width KITTI batch-4
predict, as ``chip_smoke.py`` does) and ``chip_smoke.K6_CASES``.

    python3 k6_sweep.py [--other CHECKOUT]

For each input it holds the keep mask exactly to the plain version and
prints the device time (torch.profiler, median of ``ROUNDS`` rounds), the
pack and sweep kernels' times apart and the bound.  ``--other`` also
imports the port of another checkout (an earlier commit unpacked with
``git archive`` into a git-ignored directory) as a second package and
times it on the same inputs in the same process, in turns (this, other,
other, this, ...), so that both versions meet the same card and clocks.

Then it builds an instrumented copy of this checkout's kernel library
under ``build/``: a copy of ``csrc/`` whose sweep kernel reads
``clock64()`` around its phases (thread 0, which is lane 0 of the sweep
warp) and writes them to a device table at its end.  Per input it prints
the mean SM cycles a problem's block spends setting up (the alive words
from ``valid``), staging the packed words, walking the diagonal blocks,
clearing the kept rows' later words, and writing ``keep``.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import shutil
import statistics
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ROUNDS, ITERS = 5, 20
PHASES = ('setup', 'stage', 'walk', 'clear', 'write')
STAMP_BLOCKS = 4096


def instrument(src: str) -> str:
    """``nms_sweep.cu`` with phase stamps in the sweep kernel: g[0] the
    start, g[1] after the setup's barrier, g[2..4] the summed cycles of the
    stages (copy and barrier), the walks (to the broadcast) and the
    clears, g[5] the end.  An empty ``asm volatile`` that reads the phase's
    result holds each clock read behind the work it closes."""
    edits = [
        ('namespace {\n',
         'namespace {\n__device__ long long g_phase[%d][6];\n'
         % STAMP_BLOCKS),
        ('  const long long p = blockIdx.x;\n',
         '  const long long p = blockIdx.x;\n'
         '  const long long c0_ = clock64();\n'
         '  long long c1_ = 0, st_ = 0, wk_ = 0, cl_ = 0, t_ = 0;\n'),
        ('  __syncthreads();\n  u64 alive[kLaneWords];\n',
         '  __syncthreads();\n  c1_ = clock64();\n'
         '  u64 alive[kLaneWords];\n'),
        ('    const uint4* src = ',
         '    t_ = clock64();\n    const uint4* src = '),
        ('    __syncthreads();\n    if (warp == 0) {\n',
         '    __syncthreads();\n    st_ += clock64() - t_;\n'
         '    if (warp == 0) {\n'),
        ('        if (lane == owner) {\n',
         '        t_ = clock64();\n        if (lane == owner) {\n'),
        ('        a = __shfl_sync(kFull, a, owner);\n',
         '        a = __shfl_sync(kFull, a, owner);\n'
         '        asm volatile("" :: "l"(a));\n'
         '        wk_ += clock64() - t_;\n        t_ = clock64();\n'),
        ('        blk += 64LL * stride;\n',
         '        blk += 64LL * stride;\n'
         '        for (int t = 0; t < kLaneWords; ++t)\n'
         '          asm volatile("" :: "l"(alive[t]));  // clears done\n'
         '        cl_ += clock64() - t_;\n'),
        ('    keep_out[p * K + j] = (alive_s[j >> 6] >> (j & 63)) & 1;\n',
         '    keep_out[p * K + j] = (alive_s[j >> 6] >> (j & 63)) & 1;\n'
         '  __syncthreads();\n'
         '  if (tid == 0 && p < %d) {\n'
         '    long long* g = g_phase[p];\n'
         '    g[0] = c0_; g[1] = c1_; g[2] = st_; g[3] = wk_; g[4] = cl_;\n'
         '    g[5] = clock64();\n'
         '  }\n' % STAMP_BLOCKS),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f'nms_sweep.cu changed; no unique {old!r}')
        src = src.replace(old, new)
    return src + '''
KERNEL_API int nms_sweep_phases(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, (size_t)n * 6 * 8);
}
'''


def phases(cases, card):
    """Rebuild the library with :func:`instrument` and print each input's
    mean SM cycles a block of each phase.  -> {input: cycles}."""
    import numpy as np
    from mmdet3d_gaussian_tpu_torch.ops import _cuda, nms
    src = Path(ROOT) / 'build' / 'k6_phases' / 'csrc'
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src)
    cu = src / 'nms_sweep.cu'
    cu.write_text(instrument(cu.read_text()))
    _cuda.CSRC = src
    _cuda.BUILD_DIR = Path(ROOT) / 'build' / 'k6_phases' / 'lib'
    _cuda._lib = None
    lib = _cuda.library()
    lib.nms_sweep_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nms_sweep_phases.restype = ctypes.c_int
    out = {}
    for name, iou, valid, thr in cases:
        for _ in range(3):
            nms.suppress_sweep(iou, valid, thr)
        torch.cuda.synchronize()
        blocks = valid.shape[0]
        g = np.zeros((blocks, 6), np.int64)
        err = lib.nms_sweep_phases(g.ctypes.data, blocks)
        if err:
            raise RuntimeError(f'cudaMemcpyFromSymbol failed: {err}')
        row = dict(setup=float((g[:, 1] - g[:, 0]).mean()),
                   stage=float(g[:, 2].mean()), walk=float(g[:, 3].mean()),
                   clear=float(g[:, 4].mean()),
                   total=float((g[:, 5] - g[:, 0]).mean()))
        row['write'] = row['total'] - row['setup'] - row['stage'] \
            - row['walk'] - row['clear']
        out[name] = row
        print(f'{name}: mean SM cycles a block: '
              + ', '.join(f'{k} {row[k]:.0f}' for k in PHASES + ('total',))
              + f' [{card}]')
    return out


def load_nms(root: str, name: str):
    """``ops.nms`` of the port in checkout ``root``, imported as package
    ``name`` (its kernels build under that checkout's ``build/``)."""
    pkg = os.path.join(root, 'mmdet3d_gaussian_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, '__init__.py'),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + '.ops.nms')


def predict_inputs():
    """(iou, valid, thr) that K6 gets in one f32 predict (the
    ``chip_smoke.py`` model, seed and batch)."""
    import chip_smoke as cs
    from mmdet3d_gaussian_tpu_torch.engine.detector import (
        PointPillarsDetector, synthetic_batch)
    det = PointPillarsDetector(cs.F32_MODEL, device='cuda', seed=0)
    with torch.no_grad():
        det.trunk.bbox_head.conv_cls.bias.zero_()
    batch = synthetic_batch(cs.BATCH, cs.POINTS, 16, seed=cs.SEEDS[0],
                            device='cuda')
    with torch.inference_mode():
        inputs = cs.capture_inputs(det, batch, cs.PREDICT_LAUNCHES)
    return tuple(inputs['nms_sweep'])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--other', help='checkout whose port is timed too')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('k6_sweep: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    from mmdet3d_gaussian_tpu_torch.ops import nms
    versions = {'this': nms}
    if args.other:
        versions['other'] = load_nms(os.path.abspath(args.other),
                                     'port_other')
    card = cs.card_line()
    _cuda.library()
    for kern, text in _cuda.ptxas_summary(
            _cuda.BUILD_INFO['ptxas']).items():
        if 'nms' in kern:
            print(f'ptxas {kern}: {text}')
    cases = [('predict inputs (f32)',) + predict_inputs()]
    for case, k, thr in cs.K6_CASES:
        cases.append((f'{case}, K={k}, thr={thr}',)
                     + cs.k6_matrix(case, k, thr) + (thr,))
    out = dict(card=card, other=args.other, cases={})
    for name, iou, valid, thr in cases:
        ref = nms.suppress_sweep_plain(iou, valid, thr)
        times = {v: [] for v in versions}
        split = {'pack': [], 'sweep': []}
        order = list(versions)
        for r in range(ROUNDS):
            for v in (order if r % 2 == 0 else order[::-1]):
                mod = versions[v]
                got = mod.suppress_sweep(iou, valid, thr)
                cs.check(torch.equal(got, ref),
                         f'{v} disagrees with the plain version on {name}')
                by_name = cs.device_ms_by_name(
                    lambda: mod.suppress_sweep(iou, valid, thr), ITERS)
                times[v].append(sum(by_name.values()))
                if v == 'this':
                    for part in split:
                        split[part].append(sum(
                            ms for n, ms in by_name.items()
                            if f'nms_{part}_kernel' in n))
        b_ms, b_by = cs.bound(*cs.k6_work(valid, ref))
        row = {v: statistics.median(t) for v, t in times.items()}
        row.update({part: statistics.median(t) for part, t in split.items()},
                   bound_ms=b_ms, bound_by=b_by,
                   kept_share=float(ref.float().mean()))
        out['cases'][name] = row
        other = (f', other {row["other"]:.4f} ms'
                 if 'other' in row else '')
        print(f'{name}: exact_equal=True, this {row["this"]:.4f} ms (pack '
              f'{row["pack"]:.4f}, sweep {row["sweep"]:.4f}){other}; bound '
              f'{b_ms:.4f} ms ({b_by}); kept share {row["kept_share"]:.4f} '
              f'(device ms, median of {ROUNDS} rounds of {ITERS} calls) '
              f'[{card}]')
    out['phases'] = phases(cases, card)
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
