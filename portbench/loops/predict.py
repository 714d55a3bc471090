"""A closed loop with one client: each request is a batch of the pool
(cycled), answered when its boxes, scores, labels and valid flags are on
the host.  End-to-end: ``predict_frames_per_s`` (frames answered in the
window over its time), ``predict_p95_ms`` (the 95th percentile over
every request of the window, from the call to the answer on the host),
``peak_mem_gib`` and ``setup_s``."""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import families, flops, traffic, weights
from ..checks import predict as check
from ..families.common import live_pillars, to_device
from ..reference.layers import precision, set_lowp
from . import common as c


def predict(det, batch):
    return det.predict(batch)


def answer(fn, det, batch):
    out = fn(det, batch)
    return tuple(t.cpu() for t in out)


def judged(answers, frames: int):
    """(pool index, answer on the host) of each request -> (the number of
    malformed answers: not ``frames`` rows or not finite; the answers as
    numpy)."""
    failed, shaped = 0, []
    for idx, out in answers:
        boxes, scores, _labels, _valid = out
        failed += not (boxes.shape[0] == frames
                       and bool(torch.isfinite(boxes).all())
                       and bool(torch.isfinite(scores).all()))
        shaped.append((idx, tuple(t.numpy() for t in out)))
    return failed, shaped


def reference_answers(fam, cfg, w0, pool_np, used, dev, lowp=False):
    """Pool index -> the reference's (final, candidates), as numpy."""
    model = fam.reference(cfg, dev)
    model.load_state_dict(w0, strict=True)
    set_lowp(model, lowp and dev.type == 'cpu')
    refs = {}
    with precision(lowp and dev.type == 'cuda'):
        for idx in sorted(used):
            final, cands = fam.reference_predict(
                model, to_device(pool_np[idx], dev))
            refs[idx] = (tuple(t.cpu().numpy() for t in final),
                         tuple(t.cpu().numpy() for t in cands))
    return refs


def run(run: c.Run) -> Dict:
    cfg, tf, dev = run.cfg, run.traffic, run.device
    fam = families.get(cfg['family'])
    pool_np = traffic.make_pool(tf, run.seed)
    print(f'live pillars a frame: '
          f'{[live_pillars(b, cfg["model"]) for b in pool_np]}',
          file=run.log)
    w0 = weights.make(fam.reference(cfg, 'meta'), cfg['init'], run.seed, dev)
    det = fam.program(cfg, dev, w0)
    pool = [to_device(b, dev) for b in pool_np]
    fn = predict if run.wrap is None else run.wrap(predict)
    for _ in range(int(tf['warm_rounds'])):
        for batch in pool:
            answer(fn, det, batch)
    c.sync(dev)
    setup_s = time.perf_counter() - run.t0
    peak_setup = c.peak(dev)

    answers, lat = [], []
    n_pool, i = len(pool), 0
    c.reset_peak(dev)
    c.sync(dev)
    t = time.perf_counter()
    while time.perf_counter() - t < run.seconds:
        t_req = time.perf_counter()
        out = answer(fn, det, pool[i % n_pool])
        lat.append(time.perf_counter() - t_req)
        answers.append((i % n_pool, out))
        i += 1
    window_s = time.perf_counter() - t
    peak_window = c.peak(dev)
    b = tf['frames']
    metrics = dict(
        predict_frames_per_s=dict(value=len(lat) * b / window_s,
                                  unit='frames/s'),
        predict_p95_ms=dict(value=float(np.percentile(lat, 95)) * 1e3,
                            unit='ms'),
        peak_mem_gib=dict(value=peak_window / 2 ** 30, unit='GiB'),
        setup_s=dict(value=setup_s, unit='s'))
    print(f'window: {len(lat)} requests of {b} frames in {window_s:.6f} s, '
          f'median {float(np.median(lat)) * 1e3:.4f} ms', file=run.log)

    ctx = None
    if run.trace:
        ctx = c.traced(run, 'predict', int(tf['trace_requests']),
                       lambda j: answer(fn, det, pool[j % n_pool]),
                       window_s / len(lat),
                       flops.step(cfg, b, tf['pad_points'], train=False))
        metrics = c.read_per_layer(run, ctx)
    device = c.device_line(run, max(peak_setup, peak_window), ctx)

    del det, pool, fn
    c.release(dev)
    failed, shaped = judged(answers, b)
    refs = reference_answers(fam, cfg, w0, pool_np,
                             {idx for idx, _ in answers}, dev)
    numbers = check.numbers(shaped, refs)
    correct, checks = c.checks_line(numbers, run.limits)
    out = dict(correct=correct and failed == 0, attempted=len(lat),
               failed=failed, metrics=metrics, device=device)
    if ctx is not None:
        out['breakdown'] = c.breakdown(ctx)
    out['checks'] = checks
    return out
