"""A new cell, configuration, traffic mix, traffic generator, per-layer
metric and model family are new files and new entries only: in a
temporary copy of the benchmark, add each and run the new cells (at the
tiny size, on the CPU) with no edit to a file that is there."""
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
FAMILY = '''"""PointPillars under another name, counting its forward pass as a
single 1 x 1 convolution over the BEV grid."""
from portbench.families.pointpillars import (  # noqa: F401
    init_train, program, reference, reference_anchors, reference_loss)
from portbench.flops import conv, grid


def forward_flops(cfg, b, points_per_frame):
    return float(b * conv(*grid(cfg['model']), 1, 1, 1))
'''
RUN_NEW = r'''
import json, sys, torch
from portbench.run import run_cell
out = run_cell(sys.argv[1], 5, 0.3, 1, torch.device('cpu'))
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
    (pb / 'families' / 'toy.py').write_text(FAMILY)
    (pb / 'configs' / 'tiny_toy.json').write_text(json.dumps(
        dict(cfg, name='tiny_toy', family='toy')))
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
    (pb / 'metrics' / 'flops_a_step.tiny.py').write_text(
        '"""A step\'s FLOPs, as flops.step counts them."""\n\n\n'
        'def read(ctx):\n    return ctx.flops\n')
    bench = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    (pb / 'limits' / 'tiny_toy_train.json').write_text(
        (pb / 'limits' / 'tiny_train.json').read_text())
    for name in ('tiny_pp', 'tiny_toy'):
        bench['configs'].append(dict(
            name=name, source='https://example.org/tiny',
            file=f'portbench/configs/{name}.json', reduced=[], why='a test'))
    bench['workloads'].append(dict(name='tiny_train', config='tiny_pp',
                                   traffic='tiny_kitti', chips=1,
                                   why='a test'))
    bench['workloads'].append(dict(name='tiny_toy_train', config='tiny_toy',
                                   traffic='tiny_kitti', chips=1,
                                   why='a test'))
    bench['end_to_end'][0]['workloads'] += ['tiny_train', 'tiny_toy_train']
    bench['per_layer'].append(dict(
        name='traced_steps.tiny', unit='count', better='higher',
        source='device_trace', layer='entry', moves='train_frames_per_s',
        workloads=['tiny_train']))
    bench['per_layer'].append(dict(
        name='flops_a_step.tiny', unit='count', better='higher',
        source='host_clock', layer='model step', moves='train_frames_per_s',
        workloads=['tiny_toy_train']))
    mfu = next(m for m in bench['per_layer'] if m['name'] == 'mfu.train')
    mfu['workloads'].append('tiny_toy_train')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    env = dict(PYTHONPATH=f'{tmp_path}:{ROOT}', PATH='/usr/bin:/bin',
               HOME=str(tmp_path))
    res = {}
    for name in ('tiny_train', 'tiny_toy_train'):
        out = subprocess.run([sys.executable, '-c', RUN_NEW, name],
                             cwd=tmp_path, capture_output=True, text=True,
                             timeout=600, env=env)
        assert out.returncode == 0, out.stderr[-3000:]
        res[name] = json.loads(out.stdout.strip().splitlines()[-1])
        assert res[name]['correct']
    assert res['tiny_train']['metrics']['traced_steps.tiny']['value'] == \
        tiny.PP_TRAFFIC['trace_steps']
    # the new family counts its own FLOPs: 3 forwards of a train step
    from portbench import flops
    h, w = flops.grid(cfg['model'])
    assert res['tiny_toy_train']['metrics']['flops_a_step.tiny']['value'] \
        == 3 * tiny.PP_TRAFFIC['frames'] * 2 * h * w
    assert res['tiny_toy_train']['metrics']['mfu.train']['value'] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
