"""Profiling: a ``torch.profiler`` trace to a Chrome trace file, honest
timing of one call, the device-time helpers of the card's smoke run, and
the spans and counters inside the port.

Port of ``mmdet3d_gaussian_tpu/engine/profiling.py`` (``trace``,
``timeit``).  :func:`trace` writes ``trace.json`` (the Chrome trace
format; ``python -m mmdet3d_gaussian_tpu_torch.tools.misc.
summarize_trace`` reads it).  :func:`timeit` is the chained-readback
slope of ``engine/timing.py``.  :func:`device_ms_by_name` and
:func:`device_ms` give the device time of a call (the summed durations of
what it ran on the card, host gaps left out).

Spans and counters: the train step and the predict call open
:func:`span` at each layer boundary (``train_step`` and ``predict`` are
the roots, one unit each) and the pillar layer counts its live and
dropped pillars (:func:`count`).  Both do nothing unless a
:func:`recording` is open: then each span keeps (name, unit, parent, host
start and end ns) and lies on the profiler's timeline as
``mmdet3d::<name>`` (a ``record_function``), and each count keeps its
value, summed on the host when the recording closes.  :func:`span_table`
splits a unit by span: the host's self ms from one recording, and from a
profiled one the device's self ms, launches, synchronizing runtime calls
and idle ms, each put to the innermost span open on the host when it was
launched; :func:`split_by_span` makes both recordings of a callable.
"""
from __future__ import annotations

import bisect
import contextlib
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

__all__ = ['trace', 'timeit', 'cuda_ms', 'cuda_spans', 'spans',
           'device_ms_by_name', 'device_ms', 'TRACE_FILE', 'span', 'count',
           'recording', 'Record', 'SpanRecord', 'timeline', 'attribute',
           'span_table', 'split_by_span']

TRACE_FILE = 'trace.json'


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the ``with`` body (host ops, and the card's kernels, copies
    and fills where CUDA is available) and write ``log_dir/trace.json``
    when it ends.  Yields the profiler."""
    from torch.profiler import profile
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def timeit(fn: Callable, *args, iters: int = 8, name: str = '') -> float:
    """Seconds per call of ``fn(*args)``: the chained-readback slope
    (``engine/timing.py``), whose chains' first runs are the warmup."""
    from .timing import chain_time, make_probe
    dt = chain_time(make_probe(fn, *args), n_lo=2, n_hi=max(4, iters))
    if name:
        print(f'{name}: {dt * 1e3:.3f} ms/iter')
    return dt


# ---------------------------------------------------------------------------
# device time on the card (the smoke run's instruments)

def cuda_ms(fn, iters, warmup=2):
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events,
    after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def spans(prof, device_type):
    """(start us, end us, name) of every activity of ``device_type`` that
    the profiler saw, in the times and names ``prof.events()`` gives them,
    read from the profiler's raw results: ``events()`` first builds an
    event object and a parent tree for every host op too, which takes tens
    of seconds on a trace of some 10^5 launches."""
    results = prof.profiler.kineto_results
    origin = results.trace_start_ns()
    return [((e.start_ns() - origin) / 1000, (e.end_ns() - origin) / 1000,
             e.name())
            for e in results.events()
            if e.device_type() == device_type
            and not getattr(e, 'is_hidden_event', lambda: False)()]


def cuda_spans(prof):
    """(start us, end us, name) of every activity the profiler saw on the
    card."""
    from torch.autograd import DeviceType
    return spans(prof, DeviceType.CUDA)


def device_ms_by_name(fn, iters, warmup=2):
    """{name: mean device ms per call} of the kernels, copies and fills
    that ``iters`` calls of ``fn`` ran on the card (torch.profiler), so
    host time between launches is left out.  The tracer now and then
    records no activity: a pass that comes back empty is made again, up
    to three in all, and then this raises; no host-clock time stands in
    for a device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        found = cuda_spans(prof)
        if found:
            out = {}
            for start, end, name in found:
                out[name] = out.get(name, 0.0) + (end - start) / 1e3 / iters
            return out
    raise RuntimeError('the profiler recorded no device activity')


def device_ms(fn, iters, warmup=2):
    """Mean device ms per call: the summed durations of everything that
    ``iters`` calls of ``fn`` ran on the card (:func:`device_ms_by_name`)."""
    return sum(device_ms_by_name(fn, iters, warmup).values())


# ---------------------------------------------------------------------------
# spans and counters inside the port

ROOTS = ('train_step', 'predict')   # the spans that open a unit
ANNOTATION = 'mmdet3d::'            # a span's name on the profiler's timeline
# runtime calls that wait for the card
SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize', 'cudaMemcpy')
OUTSIDE = '(outside spans)'


class SpanRecord(NamedTuple):
    id: int                  # in the order the spans opened
    name: str
    unit: Optional[int]      # the root span's unit; None outside every root
    parent: Optional[int]    # the enclosing span's id; None at the top
    start_ns: int            # host clock (time.perf_counter_ns)
    end_ns: int


class Record:
    """What one :func:`recording` kept: ``spans`` (closed, by id),
    ``units`` (roots opened) and, once it has closed, ``counts`` ({name:
    total})."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.units = 0
        self.counts: Dict[str, int] = {}
        self._open: List[tuple] = []     # (id, name, unit, parent, start)
        self._values: List[tuple] = []   # (name, int or 0-d tensor)
        self._next = 0

    def _close(self) -> None:
        self.spans.sort()
        for name, value in self._values:
            self.counts[name] = self.counts.get(name, 0) + int(value)
        self._values = []

    def host_ms(self) -> Dict[str, Dict[str, float]]:
        """{span: {'self_ms', 'total_ms'}} summed over the record's spans;
        a span's self time is its time less its children's."""
        child: Dict[int, int] = {}
        for s in self.spans:
            if s.parent is not None:
                child[s.parent] = (child.get(s.parent, 0)
                                   + s.end_ns - s.start_ns)
        out: Dict[str, Dict[str, float]] = {}
        for s in self.spans:
            total = (s.end_ns - s.start_ns) / 1e6
            row = out.setdefault(s.name, dict(self_ms=0.0, total_ms=0.0))
            row['total_ms'] += total
            row['self_ms'] += total - child.get(s.id, 0) / 1e6
        return out


_RECORD: Optional[Record] = None     # the open recording, if any
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ('rec', 'name', 'fn', 'id')

    def __init__(self, rec: Record, name: str):
        self.rec, self.name, self.fn = rec, name, None

    def __enter__(self):
        if torch.compiler.is_exporting():
            return self
        rec = self.rec
        parent = rec._open[-1] if rec._open else None
        if self.name in ROOTS:
            unit = rec.units
            rec.units += 1
        else:
            unit = parent[2] if parent else None
        self.id = rec._next
        rec._next += 1
        self.fn = torch.profiler.record_function(ANNOTATION + self.name)
        self.fn.__enter__()
        rec._open.append((self.id, self.name, unit,
                          parent[0] if parent else None,
                          time.perf_counter_ns()))
        return self

    def __exit__(self, *exc):
        if self.fn is None:
            return False
        end = time.perf_counter_ns()
        sid, name, unit, parent, start = self.rec._open.pop()
        self.fn.__exit__(*exc)
        self.rec.spans.append(SpanRecord(sid, name, unit, parent, start, end))
        return False


def span(name: str):
    """A context manager around one layer's call: a no-op unless a
    :func:`recording` is open (or ``torch.export`` is tracing)."""
    rec = _RECORD
    if rec is None:
        return _OFF
    return _Span(rec, name)


def count(name: str, value) -> None:
    """Add ``value`` (an int or a 0-d tensor, on any device) to counter
    ``name``.  Nothing unless a :func:`recording` is open; a tensor is
    read on the host only when the recording closes, so a count adds no
    kernel and no sync."""
    rec = _RECORD
    if rec is None or torch.compiler.is_exporting():
        return
    rec._values.append((name, value.detach()
                        if isinstance(value, torch.Tensor) else value))


@contextlib.contextmanager
def recording():
    """Record the port's spans and counts over the ``with`` body; yields
    the :class:`Record`, whose counts are summed when the body ends."""
    global _RECORD
    if _RECORD is not None:
        raise RuntimeError('a recording is already open')
    rec = Record()
    _RECORD = rec
    try:
        yield rec
    finally:
        _RECORD = None
        rec._close()


def timeline(prof):
    """From a profile of a recording, read from the profiler's raw events:
    (the program's spans as (start us, end us, name), the CUDA runtime and
    driver calls as (start us, name, correlation id), the card's kernels,
    copies and fills as (start us, end us, correlation id, is a kernel))."""
    from torch.autograd import DeviceType
    results = prof.profiler.kineto_results
    origin = results.trace_start_ns()
    spans_, calls, device = [], [], []
    for e in results.events():
        if e.is_hidden_event():
            continue
        start = (e.start_ns() - origin) / 1e3
        end = (e.end_ns() - origin) / 1e3
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((start, end, e.correlation_id(),
                               not name.lower().startswith(('memcpy',
                                                            'memset'))))
        elif name.startswith(ANNOTATION):
            spans_.append((start, end, name[len(ANNOTATION):]))
        elif name.startswith('cu'):
            calls.append((start, name, e.correlation_id()))
    return spans_, calls, device


def _innermost(spans_):
    """-> a function of a time: the innermost of ``spans_`` open then (the
    one opened last among those open), or :data:`OUTSIDE`."""
    edges = sorted([(s, 1, i) for i, (s, _e, _n) in enumerate(spans_)]
                   + [(e, 0, i) for i, (_s, e, _n) in enumerate(spans_)])
    times, names, stack = [], [], []
    for t, opens, i in edges:
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
        times.append(t)
        names.append(spans_[stack[-1]][2] if stack else OUTSIDE)

    def at(t: float) -> str:
        k = bisect.bisect_right(times, t) - 1
        return names[k] if k >= 0 else OUTSIDE
    return at


def attribute(spans_, calls, device) -> Dict[str, Dict[str, float]]:
    """{span: {'device_ms', 'launches', 'syncs', 'idle_ms'}} summed over a
    :func:`timeline`: each kernel, copy and fill is put, through its
    runtime call's correlation id, to the innermost span open at the
    call's start on any thread (autograd's thread launches the backward
    while ``backward`` is open), each synchronizing call
    (:data:`SYNC_CALLS`) likewise, and each gap with nothing on the card,
    between the first span's start and the last's end, to the innermost
    span open at its middle; work outside every span to :data:`OUTSIDE`."""
    rows: Dict[str, Dict[str, float]] = {}

    def row(name):
        return rows.setdefault(name, dict(device_ms=0.0, launches=0,
                                          syncs=0, idle_ms=0.0))
    at = _innermost(spans_)
    launched = {}
    for start, name, corr in calls:
        launched[corr] = start
        if name in SYNC_CALLS:
            row(at(start))['syncs'] += 1
    busy = []
    for start, end, corr, kernel in device:
        r = row(at(launched.get(corr, start)))
        r['device_ms'] += (end - start) / 1e3
        r['launches'] += int(kernel)
        busy.append((start, end))
    if spans_ and busy:
        t = min(s for s, _e, _n in spans_)
        last = max(e for _s, e, _n in spans_)
        for start, end in sorted(busy) + [(last, last)]:
            gap_end = min(start, last)
            if gap_end > t:
                row(at((t + gap_end) / 2))['idle_ms'] += (gap_end - t) / 1e3
            t = max(t, end)
    return rows


def span_table(record: Record, prof=None,
               units: Optional[int] = None) -> Dict[str, Dict[str, float]]:
    """A unit split by span: {span: {'device_ms', 'host_ms', 'launches',
    'syncs', 'idle_ms'}}, each a self value (inside the span and outside
    its children) a unit, with ``'counters'``: {name: total a unit}.
    ``host_ms`` comes from ``record``; the rest from ``prof``, a profile
    (host and card activity) of another recording of as many units
    (:func:`attribute`)."""
    n = units or record.units or 1
    rows = attribute(*timeline(prof)) if prof is not None else {}
    host = record.host_ms()
    out = {}
    for name in sorted(set(host) | set(rows)):
        r = rows.get(name, {})
        out[name] = dict(device_ms=r.get('device_ms', 0.0) / n,
                         host_ms=host.get(name, {}).get('self_ms', 0.0) / n,
                         launches=r.get('launches', 0) / n,
                         syncs=r.get('syncs', 0) / n,
                         idle_ms=r.get('idle_ms', 0.0) / n)
    out['counters'] = {k: v / n for k, v in sorted(record.counts.items())}
    return out


def split_by_span(run: Callable[[], None], units: int):
    """:func:`span_table` of ``run()``, which runs ``units`` units (train
    steps or predicts) and waits for the card: once recorded alone (the
    host's ms), once recorded under the profiler (the card's)."""
    from torch.profiler import profile
    with recording() as rec:
        run()
    with recording(), profile(activities=_activities()) as prof:
        run()
    return span_table(rec, prof, units)
