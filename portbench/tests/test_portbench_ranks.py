"""A cell of several cards on the CPU: two gloo ranks of the port's data
parallel through the R-rank path of the train loop (``loops/train.py``,
``ranks.py``), at the tiny size, each run in its own process under a
time limit.  A sound run is correct and reports both ranks; the faults
that only ranks can have (the exchange left out) and those of every
training cell (the state unchanged, half of the batch) come out not
correct; a rank killed mid-run ends the run with an error at once."""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench.run import ROOT

RUN = r'''
import json, sys, torch
from portbench.run import run_cell
from portbench.tests import faults, tiny
trace, fault = int(sys.argv[1]), sys.argv[2]
wrap = getattr(faults, fault) if fault != 'none' else None
out = run_cell('pp_kitti_train_dp4', 2 ** 31 + 9, 0.3, trace,
               torch.device('cpu'), cfg=tiny.pp_config(),
               traffic_over=dict(tiny.PP_TRAFFIC, frames=4), wrap=wrap,
               world=2)
print(json.dumps(out))
'''
LIMIT_S = 240
CONTROL = r'''
import json, torch
from portbench import calibrate, traffic
from portbench.tests import tiny
tf = dict(traffic.load('kitti_train_b48'), **dict(tiny.PP_TRAFFIC, frames=4))
for seed, rec in calibrate.ranked_train_seeds(
        tiny.pp_config(), tf, [2 ** 31 + 11], torch.device('cpu'), 2, 1):
    print(json.dumps(rec))
'''


def two_ranks(trace=0, fault='none'):
    return subprocess.run(
        [sys.executable, '-c', RUN, str(trace), fault], cwd=ROOT,
        capture_output=True, text=True, timeout=LIMIT_S,
        env={'PYTHONPATH': str(ROOT), 'PATH': '/usr/bin:/bin',
             'HOME': str(ROOT / 'build')})


def result(out):
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('trace', [0, 1])
def test_two_ranks_are_correct(trace):
    res = result(two_ranks(trace))
    assert res['correct'], res['checks']
    assert res['device']['count'] == 2
    assert res['attempted'] > 0 and res['failed'] == 0
    assert list(res)[-1] == 'checks'
    # the CPU has no device trace: the span pass, made on every rank with
    # the loop's own objects, and mfu read; the device's metrics do not
    want = {'mfu.train', 'pillars_ms.train', 'targets_ms.train',
            'loss_ms.train', 'backward_ms.train', 'optimizer_ms.train',
            'host_dispatch_ms.train', 'host_syncs.train',
            'live_pillars.train'} if trace else {
        'train_frames_per_s', 'peak_mem_gib', 'setup_s'}
    assert set(res['metrics']) == want


def test_two_ranks_span_pass_reads_rank_0s_rows():
    """The span pass on the ranks' own objects: rank 0's live pillars a
    step are its own rows' as the traffic draws them."""
    out = two_ranks(trace=1)
    res = result(out)
    read, want = re.findall(r'live pillars a unit (\S+) \(the traffic\'s '
                            r'(\S+)\)', out.stderr)[-1]
    assert float(read) == float(want) > 0
    assert res['metrics']['live_pillars.train']['value'] == float(want)


@pytest.mark.parametrize('fault', ['no_exchange', 'unchanged_state',
                                   'half_batch_train'])
def test_fault_on_two_ranks_is_not_correct(fault):
    res = result(two_ranks(fault=fault))
    assert not res['correct'], res['checks']


def test_control_on_two_ranks_is_not_correct():
    """``calibrate``'s path for a cell of several cards, on two gloo
    ranks: the program's readings within the four-card cell's limits; the
    control (the reference with TF32's rounding in the program's place),
    half of the batch and the exchange left out each fail one."""
    from portbench.run import load_limits
    out = subprocess.run([sys.executable, '-c', CONTROL], cwd=ROOT,
                         capture_output=True, text=True, timeout=LIMIT_S,
                         env={'PYTHONPATH': str(ROOT), 'PATH': '/usr/bin:/bin',
                              'HOME': str(ROOT / 'build')})
    rec = result(out)
    lim = load_limits('pp_kitti_train_dp4')
    assert all(rec['program'][k] <= v for k, v in lim.items()), rec
    for key in ('control', 'half_batch', 'no_exchange'):
        assert any(rec[key][k] > v for k, v in lim.items()), (key, rec)


def test_a_killed_rank_ends_the_run():
    t = time.monotonic()
    out = two_ranks(fault='rank_killed')
    # gloo raises on rank 0 at once; NCCL would wait, and the watcher ends
    # the run
    assert out.returncode != 0, out.stdout[-3000:]
    assert not out.stdout.strip()
    assert time.monotonic() - t < LIMIT_S / 2


WATCH = r'''
import sys, time
import torch.multiprocessing as mp
from portbench.ranks import _Watch
from portbench.tests import test_portbench_ranks as t
ctx = mp.start_processes(getattr(t, sys.argv[1]), nprocs=2, join=False,
                         start_method='spawn')
print(' '.join(str(p.pid) for p in ctx.processes), flush=True)
_Watch(ctx, time.monotonic() + float(sys.argv[2])).start()
time.sleep(60)
'''


def stuck(i):
    time.sleep(60)


def failing(i):
    if i == 1:
        raise SystemExit(1)
    time.sleep(60)


@pytest.mark.parametrize('ranks, deadline_s, why', [
    ('failing', 60, 'process 1 terminated with exit code 1'),
    ('stuck', 3, 'the ranks outlasted their time')])
def test_the_watch_ends_a_stuck_job(ranks, deadline_s, why):
    """Rank 0 waiting in a collective on a rank that has failed, or on a
    job past its time: the watch ends every rank and exits."""
    from portbench.ranks import FAILED
    t = time.monotonic()
    out = subprocess.run([sys.executable, '-c', WATCH, ranks,
                          str(deadline_s)], cwd=ROOT, capture_output=True,
                         text=True, timeout=60,
                         env={'PYTHONPATH': str(ROOT), 'PATH': '/usr/bin:/bin'})
    assert out.returncode == FAILED and why in out.stderr, out.stderr
    assert time.monotonic() - t < 30
    for pid in out.stdout.split():
        stat = Path(f'/proc/{int(pid)}/stat')
        # gone, or a zombie that waits for its new parent to reap it
        assert not stat.exists() \
            or stat.read_text().split(')')[1].split()[0] == 'Z'
