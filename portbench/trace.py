"""What the benchmark reads from a ``torch.profiler`` trace: the device's
activity (kernels, copies, fills) and the host's ops, read from the
profiler's raw kineto events (frozen from the port's
``engine/profiling.py::spans``: ``prof.events()`` builds a tree of every
host op first, which takes tens of seconds on long traces), the union of
the device's busy intervals, and the breakdown of the result line.

A trace with no device activity is a failed trace: nothing here stands a
CUDA-event time in for it."""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

Span = Tuple[float, float, str]       # (start us, end us, name)


def read(prof) -> Tuple[List[Span], List[Span], List[Span]]:
    """-> (device kernels, other device activity (copies, fills), host
    ops), each sorted by start, times in microseconds from the trace's
    start.  The device-side copies of host annotations
    (``record_function`` ranges, which the profiler also lays on the
    device's timeline) are neither."""
    from torch.autograd import DeviceType
    results = prof.profiler.kineto_results
    origin = results.trace_start_ns()
    device, host = [], []
    for e in results.events():
        if getattr(e, 'is_hidden_event', lambda: False)():
            continue
        span = ((e.start_ns() - origin) / 1e3, (e.end_ns() - origin) / 1e3,
                e.name())
        if e.device_type() == DeviceType.CUDA:
            device.append(span)
        elif e.device_type() == DeviceType.CPU:
            host.append(span)
    host_names = {n for _s, _e, n in host}
    kernels, other = [], []
    for span in device:
        if span[2] in host_names:
            continue
        low = span[2].lower()
        (other if low.startswith(('memcpy', 'memset')) else
         kernels).append(span)
    return sorted(kernels), sorted(other), sorted(host)


def union(spans) -> List[Tuple[float, float]]:
    """The busy intervals: the union of (start, end) of ``spans``."""
    out: List[Tuple[float, float]] = []
    for start, end, *_ in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def busy_us(spans) -> float:
    return sum(e - s for s, e in union(spans))


def collective(name: str) -> bool:
    """An NCCL kernel: it spins on its card until every rank has reached
    its collective, so its time is the exchange and the wait for the
    slowest rank together."""
    return 'nccl' in name.lower()


def compute(kernels: List[Span]) -> List[Span]:
    """The kernels that are not :func:`collective` (one card runs none):
    the device's busy time, the same in ``busy_s`` and the idle share."""
    return [k for k in kernels if not collective(k[2])]


def base_name(name: str) -> str:
    """A kernel's name without namespaces, template arguments and
    parameters: ``void (anonymous namespace)::rows_kernel<float>(...)``
    -> ``rows_kernel``."""
    head = re.split(r'[<(]', name.replace('(anonymous namespace)', ''), 1)[0]
    return head.strip().split('::')[-1].split(' ')[-1]


def device_ops(kernels, other, top=10) -> List[List]:
    """The device operations that took most time: [[name, seconds], ...]."""
    total: Dict[str, float] = {}
    for s, e, n in list(kernels) + list(other):
        total[n] = total.get(n, 0.0) + (e - s) / 1e6
    return [[n[:200], t] for n, t in sorted(total.items(),
                                            key=lambda kv: -kv[1])[:top]]


def idle_gaps(kernels, other, host, window: Tuple[float, float],
              top=10) -> List[List]:
    """The longest stretches in ``window`` with nothing on the device,
    each named by the innermost host op running at its middle:
    [[name, seconds], ...]."""
    busy = union(list(kernels) + list(other))
    gaps, t = [], window[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, window[1])))
        t = max(t, e)
    if t < window[1]:
        gaps.append((t, window[1]))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: -(g[1] - g[0]))[:top]
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        inner: Optional[Span] = None
        for hs, he, hn in host:
            if hs > mid:
                break
            if he >= mid and not hn.startswith('portbench::') and (
                    inner is None or he - hs < inner[1] - inner[0]):
                inner = (hs, he, hn)
        name = inner[2] if inner else 'host: Python between ops'
        out.append([name[:200], (e - s) / 1e6])
    return out
