"""One rank a card: a cell whose ``chips`` is R > 1 runs R processes of
the port's data parallel (``parallel/mesh.py``: ``init_distributed``,
NCCL on cards, gloo on the CPU), rank r on card r.

The process that runs the cell is rank 0, the measuring one.  It loads
or builds the port's hand kernels first, then starts ranks 1 .. R-1
with ``torch.multiprocessing.start_processes`` (spawn), which find them
built, and all R join one process group at ``tcp://127.0.0.1:<a free
port>``.  Every rank then runs the same function, ``fn(group, run,
first)``; rank 0's return is the caller's.  The other ranks write their
standard output to standard error, so that rank 0's last line stays the
result.

A rank that fails or hangs fails the run within its time: a thread of
rank 0 joins the other ranks (``ProcessContext.join``) and, when one
ends with an error or the job outlasts ``timeout_s``, ends them all and
exits with :data:`FAILED` at once (a collective on a lost rank would
wait); each other rank is ended by the kernel when rank 0 is gone
(``PR_SET_PDEATHSIG``); a collective that waits longer than
:data:`COLLECTIVE_TIMEOUT_S` raises."""
from __future__ import annotations

import copy
import ctypes
import datetime
import os
import signal
import socket
import sys
import threading
import time
from typing import Any, Callable, Optional

import torch

FAILED = 4
COLLECTIVE_TIMEOUT_S = 120
POLL_S = 0.2
PR_SET_PDEATHSIG = 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def pin(rank: int, world: int) -> None:
    """Keep this process, and the threads it starts, on the ``rank``-th of
    ``world`` equal runs of the cores it may use, so that the ranks'
    hosts, which pace their cards, do not take cores from each other."""
    cores = sorted(os.sched_getaffinity(0))
    n = max(1, len(cores) // world)
    mine = cores[rank * n:(rank + 1) * n] or cores
    os.sched_setaffinity(0, mine)
    torch.set_num_threads(len(mine))


def join(rank: int, world: int, init: str, device: torch.device):
    """Join the job as ``rank`` (:func:`pin`-ned to its cores): -> the
    port's ``Group`` (its device is card ``rank``, or the CPU)."""
    from mmdet3d_gaussian_tpu_torch.parallel.mesh import init_distributed
    pin(rank, world)
    os.environ['LOCAL_RANK'] = str(rank)
    return init_distributed(
        init_method=init, rank=rank, world_size=world,
        device='cpu' if device.type == 'cpu' else None,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def leave() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _worker(i: int, world: int, init: str, fn: Callable, run,
            parent: int) -> None:
    """Rank ``i`` + 1 (``start_processes`` counts from 0)."""
    ctypes.CDLL(None).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != parent:
        os._exit(FAILED)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    tf32 = bool(run.cfg.get('tf32', False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    group = join(i + 1, world, init, run.device)
    run.device, run.log = group.device, open(os.devnull, 'w')
    try:
        fn(group, run, None)
    finally:
        leave()


class _Watch(threading.Thread):
    """Rank 0's watch over the other ranks' ``ProcessContext`` (see the
    module's docstring); ``stopped`` once rank 0 ends them itself."""

    def __init__(self, ctx, deadline: float):
        super().__init__(daemon=True)
        self.ctx, self.deadline = ctx, deadline
        self.stopped = threading.Event()

    def run(self):
        try:
            while not self.ctx.join(POLL_S, grace_period=1):
                if time.monotonic() > self.deadline:
                    raise TimeoutError('the ranks outlasted their time')
        except Exception as e:  # a rank failed, or the job is late
            if self.stopped.is_set():
                return
            why = str(e).strip().splitlines()
            print(f'portbench: {why[0] if why else type(e).__name__}; '
                  f'ending the run\n{e}', file=sys.stderr, flush=True)
            for p in self.ctx.processes:
                p.kill()
            os._exit(FAILED)


def run_ranks(world: int, fn: Callable, run, timeout_s: float,
              first: Optional[Callable] = None) -> Any:
    """Run ``fn(group, run, first(run))`` on rank 0 (here) and
    ``fn(group, run, None)`` on ranks 1 .. ``world``-1 (each handed a
    copy of ``run`` with ``log`` None; ``fn`` and ``run.wrap`` are
    module-level functions, pickled by name).  ``first`` runs on rank 0
    while the others start.  -> rank 0's return, once every rank has
    ended cleanly."""
    import torch.multiprocessing as mp
    if run.device.type == 'cuda':
        from mmdet3d_gaussian_tpu_torch.ops import _cuda
        _cuda.library()
    init = f'tcp://127.0.0.1:{free_port()}'
    others = copy.copy(run)
    others.log = None
    ctx = mp.start_processes(_worker, (world, init, fn, others, os.getpid()),
                             nprocs=world - 1, join=False,
                             start_method='spawn')
    watch = _Watch(ctx, time.monotonic() + timeout_s)
    watch.start()
    try:
        pre = first(run) if first is not None else None
        group = join(0, world, init, run.device)
        out = fn(group, run, pre)
        # every rank leaves together: NCCL's finalize waits for its peers
        leave()
        # until every other rank has ended cleanly; else the watch exits
        watch.join()
        return out
    finally:
        watch.stopped.set()
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        leave()
