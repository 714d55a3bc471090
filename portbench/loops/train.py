"""Train steps back to back, one trainer, a pool of distinct batches
cycled; the metrics read to the host at the configuration's log
interval, as ``engine/loop.py`` reads them.

Set-up builds the detector and its train state once, from the seed's
weights, drives it through the traffic's ``checked_steps`` (the steps
the reference follows) and ``warm_steps`` more, and hands the same
object to the window.  End-to-end: ``train_frames_per_s`` (frames of
every step completed in the window over its time, closed by a
synchronize), ``peak_mem_gib`` (the window's peak after a reset),
``setup_s``.

A cell of R > 1 cards runs R ranks of the port's data parallel, one a
card (:func:`ranked`), each on its contiguous rows of every batch."""
from __future__ import annotations

import math
import time
from typing import Dict

from .. import families, flops, ranks, spans, traffic, weights
from .. import trace as tr
from ..checks import train as check
from ..families.common import live_pillars, to_device
from . import common as c

# the R-rank job's time beyond the window: set-up, the traced passes
RANKS_TIMEOUT_S = 240


def train_step(det, batch, state):
    return det.train_step(batch, state)


def run(run: c.Run) -> Dict:
    if getattr(run, 'world', 1) > 1:
        return ranked(run)
    cfg, tf, dev = run.cfg, run.traffic, run.device
    fam = families.get(cfg['family'])
    pool_np = _pool(run)
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


def _pool(run: c.Run):
    """The traffic's pool of whole batches from the seed (on R ranks rank
    0's, drawn while the other ranks start)."""
    pool_np = traffic.make_pool(run.traffic, run.seed)
    print(f'live pillars a frame: '
          f'{[live_pillars(b, run.cfg["model"]) for b in pool_np]}',
          file=run.log)
    return pool_np


def checked_rank(group, run: c.Run, pool_np):
    """A rank's set-up up to its checked steps: rank 0's pool (``pool_np``;
    None on the others) sent to every rank, the weights from the seed,
    the program data parallel over ``group`` on this rank's rows of each
    batch, driven through the checked steps.  -> (pool_np, w0, det,
    state, pool, step, readings)."""
    import torch.distributed as dist
    from mmdet3d_gaussian_tpu_torch.parallel.mesh import shard_batch
    cfg, tf, dev = run.cfg, run.traffic, group.device
    box = [pool_np]
    dist.broadcast_object_list(box, src=0)
    pool_np = box[0]
    fam = families.get(cfg['family'])
    w0 = weights.make(fam.reference(cfg, 'meta'), cfg['init'], run.seed, dev)
    det = fam.program(cfg, dev, w0)
    det.set_group(group)
    state = fam.init_train(det, cfg)
    pool = [to_device(shard_batch(b, group), dev) for b in pool_np]
    step = train_step if run.wrap is None else run.wrap(train_step)
    n_check = int(tf['checked_steps'])
    state, prog = check.checked_steps(
        step, det, state, [pool[i % len(pool)] for i in range(n_check)],
        cfg, w0)
    return pool_np, w0, det, state, pool, step, prog


def _rank(group, run: c.Run, pool_np):
    """One rank of :func:`ranked`; -> on rank 0 what the check and the
    result line need, on the others None."""
    import torch
    import torch.distributed as dist
    tf, dev = run.traffic, group.device
    cfg, lead = run.cfg, group.rank == 0
    pool_np, w0, det, state, pool, step, prog = checked_rank(group, run,
                                                             pool_np)
    n_check, n_pool = int(tf['checked_steps']), len(pool)
    # the window's steps, from the warm steps' time, sent once
    n_warm = int(tf['warm_steps'])
    c.sync(dev)
    t = time.perf_counter()
    for i in range(n_check, n_check + n_warm):
        state, m = step(det, pool[i % n_pool], state)
    c.sync(dev)
    per_step = (time.perf_counter() - t) / n_warm
    steps = torch.tensor([max(1, round(run.seconds / per_step))],
                         dtype=torch.int64, device=dev)
    dist.broadcast(steps, src=0)
    steps = int(steps.item())
    print(f'window: {steps} steps on every rank (the warm steps: '
          f'{per_step:.6f} s a step)', file=run.log)
    setup_s = time.perf_counter() - run.t0
    peak_setup = c.peak(dev)

    # the measured window: the same steps on every rank, no message
    nxt = n_check + n_warm
    log_every = int(tf['log_interval'])
    attempted = failed = 0
    c.reset_peak(dev)
    c.sync(dev)
    t = time.perf_counter()
    for _ in range(steps):
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
    peaks = torch.tensor([peak_window, max(peak_setup, peak_window)],
                         dtype=torch.int64, device=dev)
    dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
    b = tf['frames']
    metrics = dict(
        train_frames_per_s=dict(value=attempted * b / window_s,
                                unit='frames/s'),
        peak_mem_gib=dict(value=int(peaks[0]) / 2 ** 30, unit='GiB'),
        setup_s=dict(value=setup_s, unit='s'))
    print(f'window: {attempted} steps of {b} frames on {group.world} ranks '
          f'in {window_s:.6f} s', file=run.log)

    ctx = None
    if run.trace:
        holder = {'state': state, 'i': nxt}

        def one(_):
            holder['state'], _m = step(det, pool[holder['i'] % n_pool],
                                       holder['state'])
            holder['i'] += 1
        ctx = c.traced(run, 'train', int(tf['trace_steps']), one,
                       window_s / attempted,
                       flops.step(cfg, b // group.world, tf['pad_points'],
                                  train=True))
        busy = torch.tensor([tr.busy_us(tr.compute(ctx.kernels)
                                        + ctx.other) / 1e6],
                            dtype=torch.float64, device=dev)
        dist.all_reduce(busy)
        ctx.collectives = [None] * group.world
        dist.all_gather_object(ctx.collectives, [
            e - s for s, e, n in ctx.kernels if tr.collective(n)])
        # the span pass on this rank's own objects, the same steps on all
        base, rows = holder['i'], slice(group.rank * (b // group.world),
                                        (group.rank + 1) * (b // group.world))

        def unit(i):
            holder['state'], _m = step(det, pool[(base + i) % n_pool],
                                       holder['state'])

        def live(i):
            frames = {k: v[rows] for k, v in pool_np[(base + i)
                                                     % n_pool].items()}
            return sum(live_pillars(frames, cfg['model']))
        spans.loop_pass(ctx, unit, live, dev, run.log)
        state = holder['state']
    del det, state, pool, m, step
    if not lead:
        return None
    device = c.device_line(run, int(peaks[1]), ctx)
    device['count'] = group.world
    out = dict(prog=prog, w0=w0, pool_np=pool_np, attempted=attempted,
               failed=failed, metrics=metrics)
    if ctx is not None:
        device['busy_s'] = float(busy) / group.world
        out['metrics'] = c.read_per_layer(run, ctx)
        out['breakdown'] = c.breakdown(ctx)
    out['device'] = device
    return out


def ranked(run: c.Run) -> Dict:
    """The cell on ``run.world`` ranks (``portbench/ranks.py``), each
    driving the port's data-parallel train step on its contiguous rows
    of every batch of the pool: the checked steps, the warm steps, then
    a window of as many steps as the warm steps' time gives
    ``--seconds`` (rank 0 sends the count once; no rank waits on a
    message inside it), and with ``--trace 1`` the same traced steps and
    span pass (``spans.loop_pass``) on every rank.  End-to-end as one
    card's, over the whole batch:
    ``train_frames_per_s`` counts every rank's frames, ``peak_mem_gib``
    and ``memory_peak_bytes`` are the fullest rank's, ``busy_s`` the
    ranks' mean, NCCL kernels left out; the per-layer metrics are rank
    0's, its FLOPs those of its own rows, and ``allreduce_ms`` reads every
    rank's NCCL kernels (``ctx.collectives``).  The readings that are checked are rank 0's, which are
    the whole batch's (the gradients and the logged loss are summed over
    the ranks); once every rank has ended, the reference follows them on
    rank 0's card over the whole batches."""
    lead = ranks.run_ranks(run.world, _rank, run,
                           RANKS_TIMEOUT_S + run.seconds, first=_pool)
    cfg, tf, dev = run.cfg, run.traffic, run.device
    fam = families.get(cfg['family'])
    c.release(dev)
    pool_np, n_check = lead['pool_np'], int(tf['checked_steps'])
    batches = [to_device(pool_np[i % len(pool_np)], dev)
               for i in range(n_check)]
    c.reset_peak(dev)
    t = time.perf_counter()
    ref = check.reference(fam, cfg, lead['w0'], batches, dev)
    print(f'reference: {n_check} steps of {tf["frames"]} frames in '
          f'{time.perf_counter() - t:.3f} s, peak {c.peak(dev)} B',
          file=run.log)
    correct, checks = c.checks_line(check.numbers(lead['prog'], ref),
                                    run.limits)
    out = dict(correct=correct, attempted=lead['attempted'],
               failed=lead['failed'], metrics=lead['metrics'],
               device=lead['device'])
    if 'breakdown' in lead:
        out['breakdown'] = lead['breakdown']
    out['checks'] = checks
    return out
