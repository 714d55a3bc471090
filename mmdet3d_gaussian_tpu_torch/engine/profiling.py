"""Profiling: a ``torch.profiler`` trace to a Chrome trace file, honest
timing of one call, the PointPillars stage breakdown, and the device-time
helpers of the card's smoke run.

Port of ``mmdet3d_gaussian_tpu/engine/profiling.py`` (``trace``,
``timeit``, ``stage_breakdown``).  :func:`trace` writes ``trace.json``
(the Chrome trace format; ``python -m mmdet3d_gaussian_tpu_torch.tools.
misc.summarize_trace`` reads it).  :func:`timeit` is the chained-readback
slope of ``engine/timing.py``.  :func:`device_ms_by_name` and
:func:`device_ms` give the device time of a call (the summed durations of
what it ran on the card, host gaps left out), with a fallback to CUDA
events when the profiler records nothing.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict

import torch

__all__ = ['trace', 'timeit', 'stage_breakdown', 'cuda_ms', 'cuda_spans', 'spans',
           'device_ms_by_name', 'device_ms', 'EVENTS_KEY', 'PROFILER_MISSES',
           'TRACE_FILE']

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


def stage_breakdown(det, batch) -> Dict[str, float]:
    """Seconds per call of a PointPillars-family detector's stages, eval
    mode: ``voxelize`` (coords and hard voxelize at the trunk's grid and
    capacities, as the JAX package times it), ``forward`` (the trunk) and
    ``fwd+loss`` (the trunk and the loss on ``batch``'s targets)."""
    from ..ops.scatter import batch_coords, compute_voxel_coords
    from ..ops.voxelize import hard_voxelize
    trunk = det.trunk
    points = batch['points'].to(det.device)
    mask = batch['points_mask'].to(det.device)
    b, n, cdim = points.shape
    pcr, vs = trunk.point_cloud_range, trunk.voxel_size
    nz = max(1, int(round((pcr[5] - pcr[2]) / vs[2])))

    def voxelize_only(points, mask):
        flat = points.reshape(b * n, cdim)
        bidx = torch.arange(b, dtype=torch.int32,
                            device=points.device).repeat_interleave(n)
        coords3, _ = compute_voxel_coords(flat[:, :3], pcr, vs)
        coords3 = torch.where(mask.reshape(-1, 1), coords3, -1)
        return hard_voxelize(flat, batch_coords(coords3, bidx),
                             (b, trunk.nx, trunk.ny, nz),
                             trunk.max_points_per_voxel,
                             trunk.max_voxels_per_sample * b).voxels

    def forward(batch):
        return det.apply_eval(batch)[:3]

    def fwd_loss(batch):
        with torch.inference_mode():
            return det.loss(det.apply_eval(batch), batch)[0]

    out = {}
    with torch.inference_mode():
        out['voxelize'] = timeit(voxelize_only, points, mask,
                                 name='voxelize')
    out['forward'] = timeit(forward, batch, name='forward (trunk)')
    out['fwd+loss'] = timeit(fwd_loss, batch, name='fwd+loss')
    return out


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


# the key under which device_ms_by_name returns a CUDA-event time when the
# profiler recorded no activity
EVENTS_KEY = '(no profiler trace: whole calls timed on CUDA events)'
# calls of device_ms_by_name that the profiler left without activity
PROFILER_MISSES = []


def device_ms_by_name(fn, iters, warmup=2):
    """{name: mean device ms per call} of the kernels, copies and fills
    that ``iters`` calls of ``fn`` ran on the card (torch.profiler), so
    host time between launches is left out.  The tracer now and then
    records no activity, and once it has, may record none for the rest
    of the process: after three empty traces (one, once that has
    happened) the calls are timed back to back on CUDA events instead,
    host gaps included, and the result is ``{EVENTS_KEY: ms}``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(1 if PROFILER_MISSES else 3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = cuda_spans(prof)
        if spans:
            out = {}
            for start, end, name in spans:
                out[name] = out.get(name, 0.0) + (end - start) / 1e3 / iters
            return out
    ms = cuda_ms(fn, iters, warmup=0)
    PROFILER_MISSES.append(ms)
    print(f'profiler: no device activity recorded (miss {len(PROFILER_MISSES)});'
          f' {ms:.4f} ms a call on CUDA events, host gaps included')
    return {EVENTS_KEY: ms}


def device_ms(fn, iters, warmup=2):
    """Mean device ms per call: the summed durations of everything that
    ``iters`` calls of ``fn`` ran on the card (:func:`device_ms_by_name`)."""
    return sum(device_ms_by_name(fn, iters, warmup).values())
