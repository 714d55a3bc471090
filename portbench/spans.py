"""The program's own spans and counters (the port's
``engine/profiling.py``: ``recording``, ``span``, ``count``), read for
the per-layer metrics of a ``--trace 1`` run, and their attribution.

The traced passes of ``loops/common.traced`` run with the program's
recorder off, so the metrics they feed read what they read before it.
The span metrics need units run with the recorder on, and a reader is
handed ``ctx`` alone, so the first span reader of a run makes that pass
itself (:func:`of`): it rebuilds the cell from the run's command line
(``--workload``, ``--seed``) as the loops build it (the configuration,
the pool and the weights from the seed, the loop's own unit: a train
step, or a request answered on the host); a cell of several ranks, which
one card cannot rebuild, makes it on every rank with the loop's own
objects (:func:`loop_pass`).  The pass runs ``ctx.units`` warm units,
then half (a)'s units with the recorder off, and then two halves of
``ctx.units`` units each:

(a) the recorder on, no profiler: each span's host ms (self and total),
    the counters, and the unit's host time against the untraced
    window's (``ctx.step_s``) and the recorder-off units': the
    recorder's overhead, on the log;
(b) the recorder on under ``torch.profiler``, the host's activity
    recorded beside the card's (the spans' ``record_function``
    annotations are recorded with it only): each kernel, copy and fill
    is put, through its CUDA runtime call's correlation id, to the
    innermost span open on the host at the call's start, on any thread
    (autograd's thread launches the backward while ``backward`` is open
    on the main one); each synchronizing runtime call (:data:`SYNCS`)
    likewise; each gap with nothing on the card, between the first
    span's start and the last's end, to the innermost span open at its
    middle.  Work outside every span goes to :data:`OUTSIDE`.

"Self" is inside the span and outside its children.  The table goes on
the log as ``spans a step:`` / ``spans a request:``, JSON of {span:
{device_ms, host_ms, launches, syncs, idle_ms}} a unit and the counters.
A program without the recorder reads None: nothing is rebuilt."""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .trace import collective

PREFIX = 'mmdet3d::'
SYNCS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
         'cudaEventSynchronize', 'cudaMemcpy')
OUTSIDE = '(outside spans)'
ROOTS = {'train': 'train_step', 'predict': 'predict'}
PILLARS = ('voxelize', 'encoder', 'canvas')

Span = Tuple[float, float, str]              # (start us, end us, name)
Call = Tuple[float, str, int]                # (start us, name, correlation)
Activity = Tuple[float, float, int, bool]    # (start, end, corr, a kernel)


def timeline(prof) -> Tuple[List[Span], List[Call], List[Activity]]:
    """From a profile of a recording, read from the profiler's raw
    events: the program's spans (the ``mmdet3d::`` annotations, prefix
    dropped), the CUDA runtime and driver calls, and the card's kernels,
    copies and fills (their annotations' device copies left out, and the
    collectives, whose time is mostly the wait for the slowest rank:
    ``trace.collective``; one card runs none)."""
    from torch.autograd import DeviceType
    results = prof.profiler.kineto_results
    origin = results.trace_start_ns()
    spans, calls, device = [], [], []
    for e in results.events():
        if e.is_hidden_event():
            continue
        start = (e.start_ns() - origin) / 1e3
        end = (e.end_ns() - origin) / 1e3
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and not collective(name):
                device.append((start, end, e.correlation_id(),
                               not name.lower().startswith(('memcpy',
                                                            'memset'))))
        elif name.startswith(PREFIX):
            spans.append((start, end, name[len(PREFIX):]))
        elif name.startswith('cu'):
            calls.append((start, name, e.correlation_id()))
    return spans, calls, device


def innermost(spans: List[Span]) -> Callable[[float], str]:
    """-> the name of the innermost span open at a time (the one opened
    last among those open), or :data:`OUTSIDE`."""
    edges = sorted([(s, 1, i) for i, (s, _e, _n) in enumerate(spans)]
                   + [(e, 0, i) for i, (_s, e, _n) in enumerate(spans)])
    times, names, stack = [], [], []
    for t, opens, i in edges:
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
        times.append(t)
        names.append(spans[stack[-1]][2] if stack else OUTSIDE)

    def at(t: float) -> str:
        k = bisect.bisect_right(times, t) - 1
        return names[k] if k >= 0 else OUTSIDE
    return at


def attribute(spans: List[Span], calls: List[Call],
              device: List[Activity]) -> Dict[str, Dict[str, float]]:
    """{span: {device_ms, launches, syncs, idle_ms}}, summed over the
    trace (see the module's docstring)."""
    rows: Dict[str, Dict[str, float]] = {}

    def row(name):
        return rows.setdefault(name, dict(device_ms=0.0, launches=0,
                                          syncs=0, idle_ms=0.0))
    at = innermost(spans)
    launched = {}
    for start, name, corr in calls:
        launched[corr] = start
        if name in SYNCS:
            row(at(start))['syncs'] += 1
    busy = []
    for start, end, corr, kernel in device:
        r = row(at(launched.get(corr, start)))
        r['device_ms'] += (end - start) / 1e3
        r['launches'] += int(kernel)
        busy.append((start, end))
    if spans and busy:
        t = min(s for s, _e, _n in spans)
        last = max(e for _s, e, _n in spans)
        for start, end in sorted(busy) + [(last, last)]:
            gap_end = min(start, last)
            if gap_end > t:
                row(at((t + gap_end) / 2))['idle_ms'] += (gap_end - t) / 1e3
            t = max(t, end)
    return rows


def table(record, rows: Dict[str, Dict[str, float]],
          units: int) -> Dict[str, Dict[str, float]]:
    """Half (a)'s host self ms (the recording's own sum) and half (b)'s
    attribution, a unit, with the counters of half (a) a unit under
    ``'counters'``."""
    host = record.host_ms()
    out = {}
    for name in sorted(set(host) | set(rows)):
        r = rows.get(name, {})
        out[name] = dict(device_ms=r.get('device_ms', 0.0) / units,
                         host_ms=host.get(name, {}).get('self_ms', 0.0)
                         / units,
                         launches=r.get('launches', 0) / units,
                         syncs=r.get('syncs', 0) / units,
                         idle_ms=r.get('idle_ms', 0.0) / units)
    out['counters'] = {k: v / units for k, v in sorted(record.counts.items())}
    return out


def measure(kind: str, units: int, one: Callable[[int], None],
            step_s: float, device, log=sys.stderr) -> SimpleNamespace:
    """Warm units, then half (a)'s units timed with the recorder off (the
    overhead's base beside ``step_s``: the same batches), then halves (a)
    and (b) of ``units`` calls of ``one(i)`` each (``i`` counts on over
    the pool).  -> the
    readers' numbers: ``table``, ``host_ms`` (the root span's host ms a
    unit, half (a)), ``syncs`` (synchronizing calls a unit inside the
    program's spans, half (b)), ``counters`` (a unit, half (a)),
    ``units`` (the indices each half ran)."""
    from mmdet3d_gaussian_tpu_torch.engine import profiling
    from torch.profiler import ProfilerActivity, profile

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
    def timed(ids):
        t = time.perf_counter()
        for i in ids:
            one(i)
        sync()
        return (time.perf_counter() - t) / len(ids)
    for i in range(units):
        one(i)
    sync()
    half_a = list(range(units, 2 * units))
    off_s = timed(half_a)
    with profiling.recording() as rec:
        on_s = timed(half_a)
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    half_b = list(range(2 * units, 3 * units))
    with profiling.recording(), profile(activities=acts) as prof:
        for i in half_b:
            one(i)
        sync()
    rows = attribute(*timeline(prof))
    tab = table(rec, rows, units)
    syncs = sum(r['syncs'] for name, r in rows.items() if name != OUTSIDE)
    unit = 'step' if kind == 'train' else 'request'
    busy = sum(r['device_ms'] for r in tab.values() if 'device_ms' in r)
    root = tab.get(ROOTS[kind], {}).get('device_ms', 0.0)
    print(f'spans a {unit}: {json.dumps(tab)}', file=log)
    print(f'spans: the recorder on, no profiler: {on_s * 1e3:.4f} ms a '
          f'{unit}, against the untraced window\'s {step_s * 1e3:.4f} ms '
          f'({100.0 * (on_s / step_s - 1.0):+.2f} %) and the same units '
          f'with the recorder off just before it {off_s * 1e3:.4f} ms '
          f'({100.0 * (on_s / off_s - 1.0):+.2f} %); the root span\'s own '
          f'device ms {root:.4f} of {busy:.4f} a {unit}', file=log)
    root_ms = rec.host_ms()[ROOTS[kind]]['total_ms']
    return SimpleNamespace(kind=kind, table=tab, host_ms=root_ms / units,
                           syncs=syncs / units, counters=tab['counters'],
                           units=dict(a=half_a, b=half_b))


def loop_pass(ctx, one: Callable[[int], None], live: Callable[[int], int],
              device, log=sys.stderr) -> SimpleNamespace:
    """:func:`measure` the loop's own ``one(i)`` (unit ``i`` from where
    the traced passes stopped) and keep it on ``ctx`` for the span
    readers: a cell of several ranks, every rank running it alike, where
    the cell cannot be rebuilt on one card.  ``live(i)``: the traffic's
    live pillars of unit ``i``'s rows on this rank."""
    out = measure(ctx.kind, ctx.units, one, ctx.step_s, device, log)
    out.expected_live = sum(live(i) for i in out.units['a']) / ctx.units
    print(f'spans: half (a) ran units {out.units["a"]}, half (b) '
          f'{out.units["b"]}; live pillars a unit '
          f'{out.counters.get("pillars.live")} (the traffic\'s '
          f'{out.expected_live})', file=log)
    ctx.program_spans = out
    return out


def command_line() -> Tuple[Optional[str], Optional[int]]:
    """(--workload, --seed) of the running ``portbench.run`` command."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument('--workload')
    p.add_argument('--seed', type=int)
    args, _rest = p.parse_known_args(sys.argv[1:])
    return args.workload, args.seed


def cell_pass(name: str, seed: int, kind: str, units: int, step_s: float,
              device, cfg=None, traffic_over=None,
              log=sys.stderr) -> Optional[SimpleNamespace]:
    """Rebuild cell ``name`` from ``seed`` as its loop builds it (with a
    test's smaller ``cfg`` and ``traffic_over``) and :func:`measure` it;
    what it built is freed with the loop's own objects, before the
    reference runs.  None where the program has no recorder or the cell
    is not of ``kind``."""
    from mmdet3d_gaussian_tpu_torch.engine import profiling
    from . import configs, families, loops, traffic, weights
    from .families.common import live_pillars, to_device
    from .run import load_bench
    if not hasattr(profiling, 'recording'):
        return None
    cell = next((w for w in load_bench()['workloads']
                 if w['name'] == name), None)
    if cell is None:
        return None
    cfg = cfg or configs.load(cell['config'])
    tf = dict(traffic.load(cell['traffic']), **(traffic_over or {}))
    if tf['loop'] != kind:
        return None
    fam = families.get(cfg['family'])
    loop = loops.get(tf['loop'])
    pool_np = traffic.make_pool(tf, seed)
    det = fam.program(cfg, device, weights.make(
        fam.reference(cfg, 'meta'), cfg['init'], seed, device))
    pool = [to_device(b, device) for b in pool_np]
    n = len(pool)
    if kind == 'train':
        holder = [fam.init_train(det, cfg)]

        def one(i):
            holder[0], _m = loop.train_step(det, pool[i % n], holder[0])
    else:
        def one(i):
            loop.answer(loop.predict, det, pool[i % n])
    out = measure(kind, units, one, step_s, device, log)
    out.expected_live = sum(sum(live_pillars(pool_np[i % n], cfg['model']))
                            for i in out.units['a']) / units
    print(f'spans: half (a) ran pool batches {[i % n for i in out.units["a"]]}'
          f', half (b) {[i % n for i in out.units["b"]]}; live pillars a '
          f'unit {out.counters.get("pillars.live")} (the traffic\'s '
          f'{out.expected_live})', file=log)
    return out


def of(ctx) -> Optional[SimpleNamespace]:
    """The span pass of this run (the loop's own, :func:`loop_pass`, or
    made by the first reader that asks, kept on ``ctx``), or None:
    outside a ``portbench.run`` command, on a program without the
    recorder, or without a card."""
    if not hasattr(ctx, 'program_spans'):
        name, seed = command_line()
        ctx.program_spans = None
        if name is not None and seed is not None \
                and torch.cuda.is_available() and ctx.step_s:
            ctx.program_spans = cell_pass(name, seed, ctx.kind, ctx.units,
                                          ctx.step_s,
                                          torch.device('cuda', 0))
    return ctx.program_spans


def self_device_ms(ctx, kind: str, names) -> Optional[float]:
    """Summed self device ms a unit of the spans ``names``."""
    got = of(ctx) if ctx.kind == kind else None
    if got is None or not any(n in got.table for n in names):
        return None
    return sum(got.table[n]['device_ms'] for n in names if n in got.table)


def host_dispatch_ms(ctx, kind: str) -> Optional[float]:
    got = of(ctx) if ctx.kind == kind else None
    return None if got is None else got.host_ms


def host_syncs(ctx, kind: str) -> Optional[float]:
    got = of(ctx) if ctx.kind == kind else None
    return None if got is None else got.syncs


def live_pillars(ctx, kind: str) -> Optional[float]:
    got = of(ctx) if ctx.kind == kind else None
    return None if got is None else got.counters.get('pillars.live')
