"""A new cell, configuration, traffic mix, traffic generator and per-layer
metric are new files and new entries only: in a temporary copy of the
benchmark, add each and run the new cell (at the tiny size, on the CPU)
with no edit to a file that is there."""
import json
import shutil
import subprocess
import sys

from portbench.run import ROOT
from portbench.tests import tiny

GENERATOR = '''"""KITTI frames of half the reflectance."""
from portbench.traffic import kitti_frames

MIXES = kitti_frames.MIXES


def make_batch(p, rng, sizes):
    out = kitti_frames.make_batch(p, rng, sizes)
    out['points'][..., 3] *= 0.5
    return out
'''
RUN_NEW = r'''
import json, torch
from portbench.run import run_cell
out = run_cell('tiny_train', 5, 0.3, 1, torch.device('cpu'))
print(json.dumps({k: out[k] for k in ('correct', 'metrics')}))
'''


def test_new_cell_from_files_only(tmp_path):
    shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    before = {p: p.read_bytes() for p in tmp_path.rglob('*')
              if p.is_file() and p.name != 'BENCHMARK.json'}
    pb = tmp_path / 'portbench'
    cfg = dict(tiny.pp_config(), name='tiny_pp')
    (pb / 'configs' / 'tiny_pp.json').write_text(json.dumps(cfg))
    (pb / 'traffic' / 'dim_kitti.py').write_text(GENERATOR)
    tf = dict(json.loads((pb / 'traffic' / 'kitti_train_b12.json')
                         .read_text()), **tiny.PP_TRAFFIC,
              generator='dim_kitti')
    (pb / 'traffic' / 'tiny_kitti.json').write_text(json.dumps(tf))
    (pb / 'limits' / 'tiny_train.json').write_text(json.dumps(
        {'limits': {'loss_gap': 1e-3, 'grad_gap': 1e-2, 'delta_gap': 1e-1}}))
    (pb / 'metrics' / 'traced_steps.tiny.py').write_text(
        '"""Steps in the traced sub-window."""\n\n\n'
        'def read(ctx):\n    return ctx.units\n')
    bench = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    bench['configs'].append(dict(
        name='tiny_pp', source='https://example.org/tiny',
        file='portbench/configs/tiny_pp.json', reduced=[], why='a test'))
    bench['workloads'].append(dict(name='tiny_train', config='tiny_pp',
                                   traffic='tiny_kitti', chips=1,
                                   why='a test'))
    bench['end_to_end'][0]['workloads'].append('tiny_train')
    bench['per_layer'].append(dict(
        name='traced_steps.tiny', unit='count', better='higher',
        source='device_trace', layer='entry', moves='train_frames_per_s',
        workloads=['tiny_train']))
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    env = dict(PYTHONPATH=f'{tmp_path}:{ROOT}', PATH='/usr/bin:/bin',
               HOME=str(tmp_path))
    out = subprocess.run([sys.executable, '-c', RUN_NEW], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['correct']
    assert res['metrics']['traced_steps.tiny']['value'] == \
        tiny.PP_TRAFFIC['trace_steps']
    after = {p: p.read_bytes() for p in before}
    assert after == before
