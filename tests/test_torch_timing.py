"""The port's step timer (``engine/timing.py``) on the CPU: the four cases
of ``tests/test_timing.py``.

On the CPU the chained readback's slope is exact, so it must agree with a
plain wall clock on a known workload, and the chain must serialize the
work (the slope scales with the workload's size).
"""
import time

import pytest
import torch

from mmdet3d_gaussian_tpu_torch.engine.timing import (chain_time,
                                                      chain_time_state,
                                                      make_probe)

torch.set_num_threads(2)


def _work(n):
    a = torch.ones((n, n), dtype=torch.float32)

    def f(x):
        return (x @ x).sum()
    return f, a


ROUNDS = 5


def test_chain_time_matches_wall_clock():
    """The chain's slope and a plain wall-clock mean, measured in turns
    over :data:`ROUNDS` rounds (so that a burst of load from other
    processes lands on both clocks), their medians compared."""
    fn, a = _work(600)
    probe = make_probe(fn, a)
    fn(a)
    chains, walls = [], []
    reps = 10
    for _ in range(ROUNDS):
        chains.append(chain_time(probe, n_lo=2, n_hi=10))
        t0 = time.perf_counter()
        for _ in range(reps):
            float(fn(a))
        walls.append((time.perf_counter() - t0) / reps)
    t_chain = sorted(chains)[ROUNDS // 2]
    t_wall = sorted(walls)[ROUNDS // 2]
    # CPU matmul timing is noisy; agree within 3x both ways
    assert t_chain < 3 * t_wall and t_wall < 3 * t_chain, (chains, walls)


def test_chain_time_scales_with_work():
    f_small, a_small = _work(128)
    f_big, a_big = _work(1024)
    t_small = chain_time(make_probe(f_small, a_small), n_lo=2, n_hi=10)
    t_big = chain_time(make_probe(f_big, a_big), n_lo=2, n_hi=10)
    # 8x size -> 512x FLOPs; demand at least 10x measured
    assert t_big > 10 * t_small, (t_small, t_big)


def test_chain_time_state_threads_state():
    def step(state, batch):
        new = state + batch.sum()
        return new, {'loss': new}

    t, final = chain_time_state(step, torch.zeros(()), torch.ones((8,)),
                                n_lo=2, n_hi=6, reps=1)
    assert t >= 0.0
    # 1 warm + (2 + 6) per rep = 9 steps of +8
    assert float(final) == pytest.approx(8.0 * 9)


def test_make_probe_fences_integer_outputs():
    """A fn returning only integer leaves still gives a probe that depends
    on them (a probe of int32 voxel coords alone must not read 0)."""
    def int_only(x):
        return (x * 2.0).to(torch.int32)

    probe = make_probe(int_only, torch.arange(8, dtype=torch.float32))
    base = float(probe(torch.zeros(())))
    probe2 = make_probe(int_only,
                        torch.arange(8, dtype=torch.float32) + 100.0)
    shifted = float(probe2(torch.zeros(())))
    assert base != 0.0
    assert shifted != base
