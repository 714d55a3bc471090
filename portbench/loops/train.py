"""Train steps back to back, one trainer, a pool of distinct batches
cycled; the metrics read to the host at the configuration's log
interval, as ``engine/loop.py`` reads them.

Set-up builds the detector and its train state once, from the seed's
weights, drives it through the traffic's ``checked_steps`` (the steps
the reference follows) and ``warm_steps`` more, and hands the same
object to the window.  End-to-end: ``train_frames_per_s`` (frames of
every step completed in the window over its time, closed by a
synchronize), ``peak_mem_gib`` (the window's peak after a reset),
``setup_s``."""
from __future__ import annotations

import math
import time
from typing import Dict

from .. import families, flops, traffic, weights
from ..checks import train as check
from ..families.common import live_pillars, to_device
from . import common as c


def train_step(det, batch, state):
    return det.train_step(batch, state)


def run(run: c.Run) -> Dict:
    cfg, tf, dev = run.cfg, run.traffic, run.device
    fam = families.get(cfg['family'])
    pool_np = traffic.make_pool(tf, run.seed)
    print(f'live pillars a frame: '
          f'{[live_pillars(b, cfg["model"]) for b in pool_np]}',
          file=run.log)
    w0 = weights.make(fam.reference(cfg, 'meta'), cfg['init'], run.seed, dev)
    det = fam.program(cfg, dev, w0)
    state = fam.init_train(det, cfg)
    pool = [to_device(b, dev) for b in pool_np]
    step = train_step if run.wrap is None else run.wrap(train_step)
    n_check, n_pool = int(tf['checked_steps']), len(pool)
    state, prog = check.checked_steps(
        step, det, state, [pool[i % n_pool] for i in range(n_check)], cfg,
        w0)
    for i in range(n_check, n_check + int(tf['warm_steps'])):
        state, m = step(det, pool[i % n_pool], state)
    c.sync(dev)
    setup_s = time.perf_counter() - run.t0
    peak_setup = c.peak(dev)

    # the measured window
    nxt = n_check + int(tf['warm_steps'])
    log_every = int(tf['log_interval'])
    attempted = failed = 0
    c.reset_peak(dev)
    c.sync(dev)
    t = time.perf_counter()
    while time.perf_counter() - t < run.seconds:
        state, m = step(det, pool[nxt % n_pool], state)
        nxt += 1
        attempted += 1
        if attempted % log_every == 0:
            rec = {k: float(v) for k, v in m.items()}
            failed += not all(map(math.isfinite, rec.values()))
    c.sync(dev)
    window_s = time.perf_counter() - t
    peak_window = c.peak(dev)
    rec = {k: float(v) for k, v in m.items()}
    failed += not all(map(math.isfinite, rec.values()))
    b = tf['frames']
    metrics = dict(
        train_frames_per_s=dict(value=attempted * b / window_s,
                                unit='frames/s'),
        peak_mem_gib=dict(value=peak_window / 2 ** 30, unit='GiB'),
        setup_s=dict(value=setup_s, unit='s'))
    print(f'window: {attempted} steps of {b} frames in {window_s:.6f} s',
          file=run.log)

    ctx = None
    if run.trace:
        holder = {'state': state, 'i': nxt}

        def one(_):
            holder['state'], _m = step(det, pool[holder['i'] % n_pool],
                                       holder['state'])
            holder['i'] += 1
        ctx = c.traced(run, 'train', int(tf['trace_steps']), one,
                       window_s / attempted,
                       flops.step(cfg, b, tf['pad_points'], train=True))
        metrics = c.read_per_layer(run, ctx)
        state = holder['state']
    device = c.device_line(run, max(peak_setup, peak_window), ctx)

    # the program's state goes before the reference runs
    del det, state, pool, m, step
    c.release(dev)
    batches = [to_device(pool_np[i % n_pool], dev) for i in range(n_check)]
    ref = check.reference(fam, cfg, w0, batches, dev)
    numbers = check.numbers(prog, ref)
    correct, checks = c.checks_line(numbers, run.limits)
    out = dict(correct=correct, attempted=attempted, failed=failed,
               metrics=metrics, device=device)
    if ctx is not None:
        out['breakdown'] = c.breakdown(ctx)
    out['checks'] = checks
    return out
