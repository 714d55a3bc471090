"""The span metrics: the attribution of ``portbench/spans.py`` on a
hand-built trace (and the port's own, which the operator's tool prints,
giving the same); each new reader returns None where the context has
nothing for it and reads its number where it has; the span pass of each
cell at the tiny sizes on the CPU (no card: host times and counters),
whose live pillars are the traffic's."""
import io
import json
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import spans
from portbench.loops.common import reader
from portbench.run import load_bench
from portbench.tests import tiny

NEW = {m['name']: m['workloads'][0] for m in load_bench()['per_layer']
       if m['name'].split('.')[0] in (
           'pillars_ms', 'targets_ms', 'loss_ms', 'backward_ms',
           'optimizer_ms', 'decode_ms', 'host_dispatch_ms', 'host_syncs',
           'live_pillars')}


def hand_trace():
    """A train step from 0 to 100 us: ``forward`` 5-40 (a kernel launched
    at 10 on the main thread, a pageable copy and its sync), ``backward``
    45-80 (a kernel launched at 50 from autograd's thread), ``optimizer``
    82-98 (a kernel); then a kernel launched outside every span."""
    spans_ = [(0.0, 100.0, 'train_step'), (5.0, 40.0, 'forward'),
              (45.0, 80.0, 'backward'), (82.0, 98.0, 'optimizer')]
    calls = [(10.0, 'cudaLaunchKernel', 1),          # main thread
             (30.0, 'cudaMemcpyAsync', 3),
             (33.0, 'cudaStreamSynchronize', 4),
             (50.0, 'cudaLaunchKernel', 2),          # autograd's thread
             (84.0, 'cudaLaunchKernel', 5),
             (105.0, 'cudaLaunchKernel', 6)]
    device = [(12.0, 20.0, 1, True), (31.0, 32.0, 3, False),
              (55.0, 70.0, 2, True), (86.0, 90.0, 5, True),
              (106.0, 108.0, 6, True)]
    return spans_, calls, device


WANT = {
    # idle, by each gap's middle: 0-12 and 20-31 in forward, 32-55 in
    # train_step (43.5), 70-86 in backward (78), 90-100 in optimizer
    'forward': dict(device_ms=0.009, launches=1, syncs=1, idle_ms=0.023),
    'train_step': dict(device_ms=0.0, launches=0, syncs=0, idle_ms=0.023),
    'backward': dict(device_ms=0.015, launches=1, syncs=0, idle_ms=0.016),
    'optimizer': dict(device_ms=0.004, launches=1, syncs=0, idle_ms=0.010),
    spans.OUTSIDE: dict(device_ms=0.002, launches=1, syncs=0, idle_ms=0.0),
}


def test_attribution_of_a_hand_built_trace():
    rows = spans.attribute(*hand_trace())
    assert set(rows) == set(WANT)
    for name, want in WANT.items():
        assert rows[name] == pytest.approx(want), name


def test_the_ports_attribution_agrees():
    from mmdet3d_gaussian_tpu_torch.engine import profiling
    assert profiling.attribute(*hand_trace()) == \
        spans.attribute(*hand_trace())


def test_innermost_span():
    at = spans.innermost([(0.0, 10.0, 'a'), (2.0, 5.0, 'b'),
                          (5.0, 6.0, 'c')])
    assert [at(t) for t in (-1, 0, 1, 2, 4.9, 5, 5.5, 6, 9, 10, 11)] == [
        spans.OUTSIDE, 'a', 'a', 'b', 'b', 'c', 'c', 'a', 'a',
        spans.OUTSIDE, spans.OUTSIDE]


def ctx_of(kind, **kw):
    return SimpleNamespace(kind=kind, units=2, step_s=0.1, kernels=[],
                           other=[], **kw)


def test_every_new_metric_is_read():
    assert len(NEW) == 13
    assert set(NEW.values()) == {'pp_kitti_train', 'centerpoint_nus_predict'}


@pytest.mark.parametrize('name', sorted(NEW))
def test_reader_reads_none_without_a_span_pass(name, monkeypatch):
    """Outside a ``portbench.run`` command (no ``--workload``), on the
    other loop's context, and on a program without the recorder."""
    monkeypatch.setattr(sys, 'argv', ['pytest'])
    read = reader(name)
    kind = 'train' if NEW[name] == 'pp_kitti_train' else 'predict'
    assert read(ctx_of(kind)) is None
    other = 'predict' if kind == 'train' else 'train'
    assert read(ctx_of(other, program_spans=SimpleNamespace())) is None
    monkeypatch.setattr(sys, 'argv', ['run.py', '--workload', NEW[name],
                                      '--seed', '5'])
    from mmdet3d_gaussian_tpu_torch.engine import profiling
    monkeypatch.delattr(profiling, 'recording')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert read(ctx_of(kind)) is None


def test_readers_read_the_pass():
    table = {n: dict(device_ms=float(i + 1), host_ms=0.0, launches=0.0,
                     syncs=0.0, idle_ms=0.0)
             for i, n in enumerate(['voxelize', 'encoder', 'canvas',
                                    'targets', 'loss', 'backward',
                                    'optimizer', 'decode', 'nms'])}
    got = SimpleNamespace(table=table, host_ms=7.5, syncs=3.0,
                          counters={'pillars.live': 1234.5})
    want = {'pillars_ms': 6.0, 'targets_ms': 4.0, 'loss_ms': 5.0,
            'backward_ms': 6.0, 'optimizer_ms': 7.0, 'decode_ms': 8.0,
            'host_dispatch_ms': 7.5, 'host_syncs': 3.0,
            'live_pillars': 1234.5}
    for name in NEW:
        kind = 'train' if name.endswith('.train') else 'predict'
        ctx = ctx_of(kind, program_spans=got)
        assert reader(name)(ctx) == want[name.split('.')[0]], name


@pytest.mark.parametrize('cell', ['pp_kitti_train', 'centerpoint_nus_predict'])
def test_span_pass_at_the_tiny_size(cell):
    torch.manual_seed(0)
    train = cell == 'pp_kitti_train'
    log = io.StringIO()
    got = spans.cell_pass(
        cell, 2 ** 31 + 11, 'train' if train else 'predict', 2, 0.05,
        torch.device('cpu'), cfg=tiny.pp_config() if train else
        tiny.cp_config(), traffic_over=tiny.PP_TRAFFIC if train else
        tiny.CP_TRAFFIC, log=log)
    trunk = {'forward', 'voxelize', 'encoder', 'canvas', 'backbone', 'neck',
             'head'}
    extra = ({'train_step', 'targets', 'loss', 'backward', 'optimizer'}
             if train else {'predict', 'decode', 'nms'})
    assert set(got.table) == trunk | extra | {'counters'}
    assert got.host_ms > 0 and got.syncs == 0          # no card here
    assert got.counters['pillars.live'] == got.expected_live > 0
    line = [x for x in log.getvalue().splitlines()
            if x.startswith('spans a step: ' if train
                            else 'spans a request: ')]
    assert json.loads(line[0].split(': ', 1)[1]) == got.table
