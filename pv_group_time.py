#!/usr/bin/env python3
"""PV-RCNN's full-width predict and train step on one CUDA card (the
KITTI 3-class config's model, B = 4 x 16,384 points, random weights from
seed 0) with the two forms of the set abstraction's grouping on a shared
voxel table, timed in turns in one process.

    python3 pv_group_time.py [--other CHECKOUT]

``rows``: the eager form, a ball query per sample on its own rows
(``GuidedSAModuleMSG._group_rows``).  ``static``: the form that
``torch.export`` takes, every sample querying the whole table under its
mask (``_group_static``), put in place of the other on a second detector.
``--other`` adds a third, the port of another checkout (an earlier commit
unpacked with ``git archive`` into a git-ignored directory) imported as a
second package.  All build the same model from the same seed and run the
same batches; the script fails unless every predict gives the ``rows``
one's labels and valid masks and its boxes and scores within 1e-5, and
prints the largest difference of the first step's losses.  Then it times
predicts and train steps on CUDA events, the versions in turns, the order
reversed round by round, so that the host's drift falls on all alike, and
prints the medians with the card's name and power limit.
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

import torch

BATCH, POINTS, SEEDS, LR = 4, 16384, (0, 1), 1e-3
PV_PCR = (0., -40., -3., 70.4, 40., 1.)
ROUNDS = 10
TOL = 1e-5
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
    for sub in ('engine.detector', 'engine.pvrcnn',
                'models.middle_encoders'):
        importlib.import_module(f'{name}.{sub}')
    return mod


def event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def train_batch(port, det):
    """B x 16,384 points over PV-RCNN's range with 4-8 GT boxes a sample,
    the first two made positives (``engine.pvrcnn.positive_batch``)."""
    batch = port.engine.detector.synthetic_batch(
        BATCH, POINTS, 8, seed=0, pc_range=PV_PCR, device='cuda')
    n_gt = torch.tensor([4, 6, 8, 5], device='cuda')
    batch['gt_valid'] = torch.arange(8, device='cuda')[None] < n_gt[:, None]
    return port.engine.pvrcnn.positive_batch(det, batch)


def compare(got, want, what):
    """Integers equal, floats within TOL -> the largest float difference."""
    worst = 0.0
    for a, b in zip(got, want):
        if a.is_floating_point():
            err = float((a - b).abs().max()) if a.numel() else 0.0
            if not err <= TOL:
                raise SystemExit(f'{what}: off by {err:.3g}')
            worst = max(worst, err)
        elif not torch.equal(a, b):
            raise SystemExit(f'{what}: integers differ')
    return worst


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--other', help='checkout whose port is timed too')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('pv_group_time: no CUDA device', file=sys.stderr)
        return 1
    ports = {'this': load_port(ROOT, 'port_this')}
    if args.other:
        ports['other'] = load_port(os.path.abspath(args.other), 'port_other')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dets = {v: p.engine.pvrcnn.PVRCNNDetector(device='cuda', seed=0)
            for v, p in ports.items()}
    dets['rows'] = dets.pop('this')
    dets['static'] = ports['this'].engine.pvrcnn.PVRCNNDetector(
        device='cuda', seed=0)
    sa = ports['this'].models.middle_encoders.GuidedSAModuleMSG
    for m in dets['static'].trunk.modules():
        if isinstance(m, sa):
            m._group_rows = m._group_static
    batches = [ports['this'].engine.detector.synthetic_batch(
        BATCH, POINTS, 16, seed=s, pc_range=PV_PCR, device='cuda')
        for s in SEEDS]
    out = dict(card=card, other=args.other)

    preds = {v: [d.predict(b) for b in batches] for v, d in dets.items()}
    out['predict_max_abs_diff'] = {
        v: max(compare(a, b, f'{v} predict batch {i}') for i, (a, b) in
               enumerate(zip(preds[v], preds['rows'])))
        for v in dets if v != 'rows'}
    del preds
    order = list(dets)
    times = {v: [] for v in dets}
    for r in range(ROUNDS):
        for v in (order if r % 2 == 0 else order[::-1]):
            b = batches[r % len(batches)]
            times[v].append(event_ms(lambda: dets[v].predict(b)))
    out['predict_ms'] = {v: statistics.median(t) for v, t in times.items()}

    tbatch = train_batch(ports['this'], dets['rows'])
    states, losses = {}, {}
    for v, d in dets.items():
        states[v], losses[v] = d.train_step(
            tbatch, d.init_train(LR, total_steps=100))
    out['first_step_max_loss_diff'] = {
        v: max(abs(float(losses[v][k]) - float(losses['rows'][k]))
               for k in losses['rows'] if k in losses[v])
        for v in dets if v != 'rows'}
    times = {v: [] for v in dets}

    def step(v):
        states[v] = dets[v].train_step(tbatch, states[v])[0]
    for r in range(ROUNDS):
        for v in (order if r % 2 == 0 else order[::-1]):
            times[v].append(event_ms(lambda: step(v)))
    out['step_ms'] = {v: statistics.median(t) for v, t in times.items()}
    out['peak_mib'] = torch.cuda.max_memory_allocated() / 2 ** 20
    for what in ('predict_ms', 'step_ms'):
        print(f'{what[:-3]}: ' + ', '.join(
            f'{v} {ms:.3f} ms' for v, ms in out[what].items())
            + f' (median of {ROUNDS} on CUDA events, in turns) [{card}]')
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
