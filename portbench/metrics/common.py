"""Readers' shared arithmetic."""
from __future__ import annotations

from typing import Iterable, Optional

from .. import trace as tr
from .. import work


def device_ms(ctx, names: Iterable[str], kernels=None) -> float:
    """Device ms a unit of the kernels (those of the first traced pass,
    or ``kernels``) whose base name is in ``names``."""
    names = set(names)
    return sum(e - s for s, e, n in (ctx.kernels if kernels is None
                                     else kernels)
               if tr.base_name(n) in names) / 1e3 / ctx.units


def launches(ctx, kind: str) -> Optional[float]:
    if ctx.kind != kind or not ctx.kernels:
        return None
    return len(ctx.kernels) / ctx.units


def mfu(ctx, kind: str) -> Optional[float]:
    """The step's model FLOPs over its time in the untraced window, as a
    share of the H100's f32 peak."""
    if ctx.kind != kind or not ctx.step_s or not ctx.flops:
        return None
    return 100.0 * ctx.flops / ctx.step_s / work.PEAK_F32_FLOPS


def matching_ms(ctx, kind: str, patterns) -> Optional[float]:
    if ctx.kind != kind:
        return None
    total = sum(e - s for s, e, n in ctx.kernels
                if any(p in n.lower() for p in patterns))
    return total / 1e3 / ctx.units if total else None


def roofline(ctx, kind: str) -> Optional[float]:
    """Summed least time of the hand kernels' recorded calls over the
    summed device time of their kernels in the same (recorded) pass, in
    %."""
    if ctx.kind != kind:
        return None
    bound, names = 0.0, set()
    for op, (calls, least_s, _bytes) in ctx.work.items():
        bound += least_s
        names.update(work.OPS[op][2])
    spent_ms = device_ms(ctx, names, ctx.recorded) * ctx.units
    if not bound or not spent_ms:
        return None
    return 100.0 * bound / (spent_ms / 1e3)


def idle(ctx, kind: str) -> Optional[float]:
    """The share of a step's (or request's) time in the untraced window
    in which nothing ran on the card: 1 - the device's busy time a unit
    (kernels, copies and fills; the first traced pass) over the unit's
    time in the untraced window.  The traced pass's own wall time is not
    used: the profiler's per-launch callbacks slow the host that paces
    the card, and would count as idle.  On several cards an NCCL kernel
    spins until every rank has reached its collective, longer in the
    traced pass for the same reason, so NCCL kernels count as idle, as in
    the device line's ``busy_s`` (``trace.compute``; ``allreduce_ms.*``
    reads the exchange); one card runs none."""
    if ctx.kind != kind or not ctx.step_s:
        return None
    busy = tr.busy_us(tr.compute(ctx.kernels) + ctx.other) / 1e6 / ctx.units
    if not busy:
        return None
    return 100.0 * (1.0 - busy / ctx.step_s)


def collective_ms(ctx, kind: str) -> Optional[float]:
    """Device ms a unit of the collectives themselves: each collective's
    NCCL kernel on the rank that reached it last, which waits for no
    other, so the ranks' skew is left out.  ``ctx.collectives`` holds
    each rank's NCCL kernel times of the first traced pass in launch
    order (every rank launches the same collectives in the same order on
    one stream); where the profiler lost a record and the ranks' counts
    differ, the least rank's total stands in.  None on one card."""
    every = getattr(ctx, 'collectives', None)
    if ctx.kind != kind or not every or not all(every):
        return None
    if len({len(k) for k in every}) > 1:
        return min(sum(k) for k in every) / 1e3 / ctx.units
    return sum(min(d) for d in zip(*every)) / 1e3 / ctx.units
