#!/usr/bin/env python3
"""Where K5's time goes inside a block: SM cycles of its four phases
(stage the box tables, cull and queue, drain the near pairs through the
polygon, store the tile) on one CUDA card, for the recorded cases of
``chip_smoke.py`` (clustered, all near, none near; 12 problems of 1,024
boxes).

    python3 k5_phases.py [--other CHECKOUT]

``--other`` also imports the port of another checkout (an earlier version
unpacked with ``git archive`` into a git-ignored directory) as a second
package and times both kernels on the same boxes in the same process, in
alternating order round by round, so that the card's drift falls on both
alike.  Per case it prints each kernel's device time (profiler, median
of the rounds).

Then it builds an instrumented copy of this checkout's kernel library under
``build/``: a copy of ``csrc/`` whose ``rotated_iou.cu`` reads ``clock64()``
at the start of a block and after each phase's barrier, and has thread 0
write the stamps and the near-pair count to a device table after the stores
(one more barrier and one 48-byte write a block).  Cycles are those of the
SM's clock while the block runs, and so include the issue slots taken by
the other blocks resident on the SM (3 a SM).  Per case it prints the mean
cycles a block of each phase and the near pairs a block, then one JSON
line.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from mmdet3d_gaussian_tpu_torch.ops import _cuda, rotated_iou  # noqa: E402

PHASES = ('stage', 'cull', 'drain', 'store')
CASES = ('clustered', 'all near', 'none near')
STAMP_BLOCKS = 1 << 17
ROUNDS = 5


def load_iou(root: Path, name: str):
    """``ops.rotated_iou`` of the port in checkout ``root``, imported as
    package ``name`` (its kernels build under that checkout's ``build/``)."""
    pkg = root / 'mmdet3d_gaussian_tpu_torch'
    spec = importlib.util.spec_from_file_location(
        name, pkg / '__init__.py', submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + '.ops.rotated_iou')


def instrument(src: str) -> str:
    """``rotated_iou.cu`` with phase stamps."""
    edits = [
        ('namespace {\n',
         'namespace {\n__device__ long long g_phase[%d][6];\n'
         % STAMP_BLOCKS),
        ('  const int tid = threadIdx.x, lane = tid & 31;\n',
         '  const int tid = threadIdx.x, lane = tid & 31;\n'
         '  const long long c0_ = clock64();\n'),
        ('  if (tid == 0) queued = 0;\n  __syncthreads();\n',
         '  if (tid == 0) queued = 0;\n  __syncthreads();\n'
         '  const long long c1_ = clock64();\n'),
        ('  }\n  __syncthreads();\n\n  const int n_near = queued;',
         '  }\n  __syncthreads();\n  const long long c2_ = clock64();\n\n'
         '  const int n_near = queued;'),
        ('  }\n  __syncthreads();\n\n  float* dst',
         '  }\n  __syncthreads();\n  const long long c3_ = clock64();\n\n'
         '  float* dst'),
        ('      if (i < nr && j < nc) dst[(long long)i * K + j] = '
         'tile[i][j];\n    }\n  }\n}',
         '      if (i < nr && j < nc) dst[(long long)i * K + j] = '
         'tile[i][j];\n    }\n  }\n'
         '  __syncthreads();\n'
         '  if (tid == 0 && blockIdx.x < %d) {\n'
         '    long long* g = g_phase[blockIdx.x];\n'
         '    g[0] = c0_; g[1] = c1_; g[2] = c2_; g[3] = c3_;\n'
         '    g[4] = clock64(); g[5] = n_near;\n'
         '  }\n}' % STAMP_BLOCKS),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f'rotated_iou.cu changed; no unique {old!r}')
        src = src.replace(old, new)
    return src + '''
KERNEL_API int rotated_iou_phases(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, (size_t)n * 6 * 8);
}
'''


def kernel_ms(versions, card):
    """-> {case: {version: median device ms}}, versions alternating."""
    out = {}
    for case in CASES:
        boxes = chip_smoke.k5_boxes(case)
        ms = {v: [] for v in versions}
        order = list(versions)
        for r in range(ROUNDS):
            for v in (order if r % 2 == 0 else order[::-1]):
                ms[v].append(chip_smoke.device_ms(
                    lambda m=versions[v]: m.iou_bev_pairwise(boxes), 20))
        out[case] = {v: float(np.median(ms[v])) for v in versions}
        print(f'{case}: kernel ms, median of {ROUNDS} rounds: '
              + ', '.join(f'{v} {t:.4f}' for v, t in out[case].items())
              + f' [{card}]')
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--other', help='checkout whose K5 is timed too')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('k5_phases: no CUDA device', file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    versions = {'this': rotated_iou}
    if args.other:
        versions['other'] = load_iou(Path(args.other).resolve(),
                                     'port_other')
    times = kernel_ms(versions, card)

    # the instrumented library replaces the plain one for the rest of the run
    src = ROOT / 'build' / 'k5_phases' / 'csrc'
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, src)
    cu = src / 'rotated_iou.cu'
    cu.write_text(instrument(cu.read_text()))
    _cuda.CSRC = src
    _cuda.BUILD_DIR = ROOT / 'build' / 'k5_phases' / 'lib'
    _cuda._lib = None
    lib = _cuda.library()
    lib.rotated_iou_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rotated_iou_phases.restype = ctypes.c_int

    blocks = (chip_smoke.K5_P * (-(-chip_smoke.K5_K // 64))
              * (-(-chip_smoke.K5_K // 128)))
    out = dict(card=card, blocks=blocks, other=args.other)
    for case in CASES:
        boxes = chip_smoke.k5_boxes(case)
        for _ in range(3):
            rotated_iou.iou_bev_pairwise(boxes)
        torch.cuda.synchronize()
        stamps = np.zeros((blocks, 6), np.int64)
        err = lib.rotated_iou_phases(stamps.ctypes.data, blocks)
        if err:
            raise RuntimeError(f'cudaMemcpyFromSymbol failed: {err}')
        cycles = np.diff(stamps[:, :5], axis=1)
        near = stamps[:, 5]
        row = {p: float(cycles[:, n].mean()) for n, p in enumerate(PHASES)}
        row.update(near_mean=float(near.mean()), near_max=int(near.max()),
                   drain_max=int(cycles[:, 2].max()),
                   kernel_ms=times[case])
        out[case] = row
        print(f'{case}: mean cycles a block: '
              + ', '.join(f'{p} {row[p]:.0f}' for p in PHASES)
              + f'; near pairs a block {row["near_mean"]:.1f} (max '
              f'{row["near_max"]}) [{card}]')
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
