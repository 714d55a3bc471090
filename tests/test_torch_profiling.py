"""``engine/profiling.py`` and the profiling tools on the CPU: ``trace``
writes a Chrome trace that ``tools/misc/summarize_trace`` reads; the
summarizer's device tables on a trace with kernel, copy and fill events;
``timeit`` and ``stage_breakdown`` on the TINY hard detector;
``profile_train_step`` and ``profile_loss_phase`` end to end at TINY
width; ``bench_eval`` at a few frames."""
import json
import math

import pytest
import torch

from mmdet3d_gaussian_tpu_torch.engine import profiling
from mmdet3d_gaussian_tpu_torch.engine.detector import (PointPillarsDetector,
                                                        synthetic_batch)
from mmdet3d_gaussian_tpu_torch.tools.misc import (bench_eval,
                                                   profile_loss_phase,
                                                   profile_train_step,
                                                   summarize_trace)

from tests.test_torch_predict import TINY_HEAD, TINY_MODEL

TINY_HARD = dict(TINY_MODEL, voxelize_mode='hard')


def test_trace_writes_what_the_summarizer_reads(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        for _ in range(3):
            (x @ x).relu().sum()
    assert prof is not None
    path = tmp_path / profiling.TRACE_FILE
    summary = summarize_trace.main([str(path), '--steps', '3', '--top', '5'])
    assert not summary['device']          # no card here
    assert summary['by_name']['aten::mm'][1] == pytest.approx(1.0)
    assert summary['total_ms'] > 0


def test_spans_read_raw_are_the_processed_events():
    """``spans`` reads the profiler's raw results: the same times and
    names as ``prof.events()`` (here the host ops; the card's kernels go
    the same way), and no processed events are built."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            (x @ x).relu().sum(0)
    got = profiling.spans(prof, DeviceType.CPU)
    assert getattr(prof.profiler, '_function_events', None) is None
    want = [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CPU]
    assert len(got) >= 9 and sorted(got) == sorted(want)
    assert profiling.cuda_spans(prof) == []           # no card here


def test_summarizer_device_tables(tmp_path, capsys):
    """Kernels, copies and fills are counted per category, per family and
    per name, divided by the steps; host events are left out."""
    ev = [dict(ph='X', cat='kernel', dur=30.0,
               name='void (anonymous namespace)::splat_kernel<unsigned '
                    'int, 2, -1>(unsigned int const*, int const*)'),
          dict(ph='X', cat='kernel', name='nms_sweep_kernel<12>', dur=10.0),
          dict(ph='X', cat='kernel', name='sm90_xmma_gemm_f32', dur=100.0),
          dict(ph='X', cat='kernel', name='sm90_xmma_gemm_f32', dur=60.0),
          dict(ph='X', cat='kernel', name='elementwise_kernel', dur=20.0),
          dict(ph='X', cat='gpu_memcpy', name='Memcpy HtoD', dur=30.0),
          dict(ph='X', cat='gpu_memset', name='Memset', dur=10.0),
          dict(ph='X', cat='cpu_op', name='aten::mm', dur=500.0),
          dict(ph='i', cat='kernel', name='marker')]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps(dict(traceEvents=ev)))
    s = summarize_trace.main([str(path), '--steps', '2'])
    assert s['device']
    assert s['total_ms'] == pytest.approx(0.13)
    assert s['by_category'] == pytest.approx(
        {'kernel': 0.11, 'gpu_memcpy': 0.015, 'gpu_memset': 0.005})
    assert s['by_family'] == pytest.approx(
        {'port kernel': 0.02, 'conv/gemm': 0.08, 'other': 0.01,
         'copy/fill': 0.02})
    assert s['by_name']['sm90_xmma_gemm_f32'] == pytest.approx((0.08, 1.0))
    assert 'aten::mm' not in s['by_name']
    assert 'device time 0.1300 ms per step' in capsys.readouterr().out


def test_timeit_and_stage_breakdown():
    det = PointPillarsDetector(TINY_HARD, TINY_HEAD, device='cpu')
    batch = synthetic_batch(2, 1024, 8,
                            pc_range=TINY_MODEL['point_cloud_range'],
                            device='cpu')
    x = torch.randn(512, 512)
    dt = profiling.timeit(lambda a: a @ a @ a, x, iters=8, name='mm')
    assert 0 < dt < 1
    out = profiling.stage_breakdown(det, batch)
    assert set(out) == {'voxelize', 'forward', 'fwd+loss'}
    # the chained slope clamps at 0 where the host's noise swamps a stage
    # (the TINY voxelize takes ~2 ms here)
    assert all(math.isfinite(v) and v >= 0 for v in out.values())
    assert out['fwd+loss'] > 0


TINY_ARGS = ['--batch', '2', '--points', '1024', '--steps', '2',
             '--device', 'cpu', '--top', '5',
             '--model-cfg', json.dumps(TINY_HARD)]


def test_profile_train_step(tmp_path):
    out = profile_train_step.main(TINY_ARGS + ['--out-dir', str(tmp_path)])
    # chained slopes clamp at 0 where a loaded host's noise swamps the work
    assert out['host_batch_s'] >= 0 and out['device_batch_s'] >= 0
    assert (tmp_path / profiling.TRACE_FILE).exists()
    assert out['summary']['total_ms'] > 0


@pytest.mark.parametrize('dense', [False, True])
def test_profile_loss_phase(tmp_path, dense):
    out = profile_loss_phase.main(TINY_ARGS + ['--out-dir', str(tmp_path)]
                                  + (['--dense'] if dense else []))
    assert out['loss_s'] >= 0 and out['loss_grad_s'] >= 0
    assert (tmp_path / profiling.TRACE_FILE).exists()
    assert out['summary']['by_name']


def test_bench_eval_small():
    rep = bench_eval.main(['--frames', '20', '--nproc', '1'])
    assert 0.0 <= rep['mAP'] <= 1.0


def test_stamp_lines():
    """``stamp_lines.py`` prefixes each output line with its second and
    passes the command's exit code on."""
    import os
    import subprocess
    import sys
    script = os.path.join(os.path.dirname(__file__), '..', 'stamp_lines.py')
    run = subprocess.run(
        [sys.executable, script, sys.executable, '-c',
         'import sys; print("a"); print("b", file=sys.stderr); sys.exit(3)'],
        capture_output=True, text=True)
    lines = run.stdout.splitlines()
    assert run.returncode == 3 and len(lines) == 3
    assert sorted(x.split()[1:] for x in lines[:2]) == [['a'], ['b']]
    assert all(float(x.split()[0]) >= 0 for x in lines)
    assert lines[2].split()[1:3] == ['exit', '3,']
