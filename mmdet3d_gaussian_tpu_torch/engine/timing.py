"""Step timing by chains of data-dependent calls.

Port of ``mmdet3d_gaussian_tpu/engine/timing.py`` (the same four names and
signatures).  PyTorch returns from a call on the card before the card has
run it, so a host clock around the call measures the enqueue.  These
helpers therefore

* chain N invocations through a scalar carry (each call's inputs depend on
  the last call's output, so none can be skipped or reordered),
* end a chain with a readback of the carry, a value that depends on all the
  work, and ``torch.cuda.synchronize(device)`` after it (the fence),
* time two chain lengths and report the slope per call, so the fixed cost
  of a chain (its first launch, the readback) cancels.

On the CPU (the tests) the same code runs, and the readback is the fence.
"""
from __future__ import annotations

import time
from typing import Callable

import torch
from torch.utils import _pytree as pytree

__all__ = ['chain_time', 'make_probe', 'chain_time_state',
           'chain_time_state_band']


def _fence(value) -> None:
    """Read ``value`` back to the host, then wait for its device."""
    if isinstance(value, torch.Tensor):
        float(value)
        if value.is_cuda:
            torch.cuda.synchronize(value.device)


def _run_chain(probe: Callable, n: int) -> float:
    """Execute n chained probe calls + the fence; return seconds."""
    c = torch.zeros((), dtype=torch.float32,
                    device=getattr(probe, 'device', None))
    t0 = time.perf_counter()
    for _ in range(n):
        c = probe(c)
    _fence(c)
    return time.perf_counter() - t0


def chain_time(probe: Callable, n_lo: int = 2, n_hi: int = 8,
               reps: int = 3) -> float:
    """Seconds per invocation of ``probe(carry) -> carry`` via the chain
    slope (the best of ``reps`` chains of each length).

    probe takes an f32 scalar carry and returns an f32 scalar that depends
    on the carry and on all the work being timed (:func:`make_probe`); its
    ``device`` attribute, if any, places the first carry.
    """
    _run_chain(probe, 2)            # warm
    t_lo = min(_run_chain(probe, n_lo) for _ in range(reps))
    t_hi = min(_run_chain(probe, n_hi) for _ in range(reps))
    return max(0.0, (t_hi - t_lo) / (n_hi - n_lo))


def make_probe(fn: Callable, *args, inject: Callable = None) -> Callable:
    """Wrap ``fn(*args)`` as a chainable probe.

    ``inject(args, carry) -> args'`` must thread the carry into the inputs
    (default: add ``carry * 1e-30`` to the first floating tensor among the
    args, nested lists, tuples and dicts included).  The probe returns
    ``sum(outputs) * 1e-30``, a scalar that depends on every output element,
    integer and bool outputs too.  It runs on the device of the first
    tensor among the args.
    """
    leaves, spec = pytree.tree_flatten(args)
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    if inject is None:
        def inject(a, c):
            flat = list(leaves)
            for i, leaf in enumerate(flat):
                if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                    flat[i] = leaf + c.to(leaf.dtype) * 1e-30
                    break
            return pytree.tree_unflatten(flat, spec)

    def probe(c):
        out = fn(*inject(args, c))
        tot = torch.zeros((), dtype=torch.float32, device=c.device)
        for leaf in pytree.tree_leaves(out):
            if isinstance(leaf, torch.Tensor):
                tot = tot + leaf.float().sum()
        return tot * 1e-30

    probe.device = tensors[0].device if tensors else None
    return probe


def _timed_chain(step, state, batch, n, loss_key):
    t0 = time.perf_counter()
    m = None
    for _ in range(n):
        state, m = step(state, batch)
    _fence(m[loss_key])
    return time.perf_counter() - t0, state


def chain_time_state(step: Callable, state, batch, n_lo: int = 2,
                     n_hi: int = 8, reps: int = 2,
                     loss_key: str = 'loss'):
    """Seconds per train step for ``step(state, batch) -> (state,
    metrics)``, from the slope of the best of ``reps`` chains of each
    length.  The state threading makes steps data-dependent; reading the
    last step's ``metrics[loss_key]`` fences the whole chain.  Returns
    (seconds_per_step, final_state)."""
    state, m = step(state, batch)
    _fence(m[loss_key])             # warm
    t_lo = t_hi = float('inf')
    for _ in range(reps):
        t, state = _timed_chain(step, state, batch, n_lo, loss_key)
        t_lo = min(t_lo, t)
    for _ in range(reps):
        t, state = _timed_chain(step, state, batch, n_hi, loss_key)
        t_hi = min(t_hi, t)
    return max(0.0, (t_hi - t_lo) / (n_hi - n_lo)), state


def chain_time_state_band(step: Callable, state, batch, n_lo: int = 2,
                          n_hi: int = 8, repeats: int = 3,
                          loss_key: str = 'loss'):
    """Like :func:`chain_time_state` but returns the run-to-run band:
    ``repeats`` independent slope estimates (each one n_lo chain and one
    n_hi chain) -> (median, min, max, final_state)."""
    state, m = step(state, batch)
    _fence(m[loss_key])             # warm
    slopes = []
    for _ in range(repeats):
        t_lo, state = _timed_chain(step, state, batch, n_lo, loss_key)
        t_hi, state = _timed_chain(step, state, batch, n_hi, loss_key)
        slopes.append(max(0.0, (t_hi - t_lo) / (n_hi - n_lo)))
    slopes.sort()
    mid = len(slopes) // 2
    med = slopes[mid] if len(slopes) % 2 else 0.5 * (slopes[mid - 1]
                                                    + slopes[mid])
    return med, slopes[0], slopes[-1], state
