"""What both loops share: the run's context, the traced sub-window and
the per-layer readers, the device line and the program's release."""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from .. import trace as tr
from .. import work

METRICS = Path(__file__).resolve().parent.parent / 'metrics'


class Run(SimpleNamespace):
    """One run of a cell: ``name``, ``cell`` and ``bench`` (BENCHMARK.json
    entries), ``cfg`` and ``traffic`` (their files), ``seed``,
    ``seconds``, ``trace``, ``device``, ``t0`` (process start on the host
    clock), ``wrap`` (a test's fault around the program's step: None on
    every measured run), ``log`` (a stream for the earlier lines),
    ``world`` (the ranks, one a card: the cell's ``chips``)."""


def sync(device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)


def peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)


def per_layer_names(run: Run) -> List[str]:
    """The per-layer metrics that this cell reports: those that list it,
    and those without a list whose end-to-end metric the cell reports."""
    e2e = {m['name'] for m in run.bench['end_to_end']
           if run.name in m.get('workloads', [run.name])}
    out = []
    for m in run.bench['per_layer']:
        if 'workloads' in m:
            if run.name in m['workloads']:
                out.append(m['name'])
        elif m['moves'] in e2e:
            out.append(m['name'])
    return out


def reader(name: str) -> Callable:
    path = METRICS / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'portbench.metrics.{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _profiled(run: Run, units: int, one: Callable[[int], None], host: bool):
    """Profile ``units`` calls of ``one(i)``: the card's activity, and with
    ``host`` the host's ops too.  -> (profiler, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] if host else []
    if run.device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    sync(run.device)
    with profile(activities=acts or [ProfilerActivity.CPU]) as prof:
        with record_function('portbench::window'):
            t = time.perf_counter()
            for i in range(units):
                one(i)
            sync(run.device)
            wall_s = time.perf_counter() - t
    return prof, wall_s


def traced(run: Run, kind: str, units: int, one: Callable[[int], None],
           step_s: float, flops: float) -> SimpleNamespace:
    """The per-layer readers' context, from three traced passes of
    ``units`` calls of ``one(i)`` (warm steps or requests).  The first
    records the card's activity alone: the metrics of time, launches and
    idle.  The second records each hand kernel's inputs at its op's entry
    besides, whose copies cost the host time and so are read for the
    roofline alone (the hand kernels' device time and their work).
    Recording the host's ops costs it tens of microseconds an op, so the
    third records them beside the card's, for the breakdown's idle gaps
    alone.  The port's own launch counter over the first pass goes on
    the log beside ``kernel_launches``."""
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    before = dict(_cuda.LAUNCHES)
    prof, wall_s = _profiled(run, units, one, host=False)
    kernels, other, _host = tr.read(prof)
    launches = {k: (v - before.get(k, 0)) / units
                for k, v in _cuda.LAUNCHES.items() if v - before.get(k, 0)}
    print(f'hand-kernel launches a {"step" if kind == "train" else "request"}'
          f' (ops/_cuda.LAUNCHES): {sum(launches.values())} '
          f'{json.dumps(launches, sort_keys=True)}', file=run.log)
    with work.Recorder() as rec:
        prof_r, _wall = _profiled(run, units, one, host=False)
    recorded, _other, _host = tr.read(prof_r)
    prof_h, _wall = _profiled(run, units, one, host=True)
    k_h, o_h, host = tr.read(prof_h)
    marks = [s for s in host if s[2] == 'portbench::window']
    window_h = (marks[0][0], marks[0][1]) if marks else (0.0, 0.0)
    return SimpleNamespace(
        kind=kind, units=units, kernels=kernels, other=other,
        wall_s=wall_s, step_s=step_s, flops=flops, work=rec.work(),
        recorded=recorded, launches=launches,
        host_pass=(k_h, o_h, host, window_h))


def read_per_layer(run: Run, ctx: SimpleNamespace) -> Dict[str, Dict]:
    units = {m['name']: m['unit'] for m in run.bench['per_layer']}
    out = {}
    for name in per_layer_names(run):
        value = reader(name)(ctx)
        if value is not None:
            out[name] = dict(value=value, unit=units[name])
    return out


def device_line(run: Run, memory_peak: int,
                ctx: Optional[SimpleNamespace] = None) -> Dict:
    d = run.device
    line = dict(platform='gpu' if d.type == 'cuda' else d.type,
                kind=(torch.cuda.get_device_name(d) if d.type == 'cuda'
                      else 'cpu'),
                count=1, memory_peak_bytes=int(memory_peak))
    if ctx is not None:
        line['busy_s'] = tr.busy_us(tr.compute(ctx.kernels)
                                    + ctx.other) / 1e6
        line['window_s'] = ctx.wall_s
    return line


def breakdown(ctx: SimpleNamespace) -> Dict:
    """The device operations that took most time (the first pass) and
    the longest idle gaps, each named by the host op running in it (the
    second pass, which records the host's ops)."""
    k_h, o_h, host, window_h = ctx.host_pass
    return dict(device_ops=tr.device_ops(ctx.kernels, ctx.other),
                idle_gaps=tr.idle_gaps(k_h, o_h, host, window_h))


def release(device) -> None:
    """Free what the program left cached once its objects are gone."""
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def checks_line(numbers: Dict[str, float], limits: Dict[str, float]):
    """-> (correct, {name: {value, limit}}): each number at or under its
    limit; a number that is missing or not finite fails, and reads null
    (JSON has no NaN or infinity)."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        finite = v is not None and math.isfinite(v)
        out[name] = dict(value=v if finite else None, limit=limit)
        ok = ok and finite and v <= limit
    return ok, out
