"""``correct`` at the tiny sizes on the CPU: sound runs of both cells
agree with the reference within the cells' limits; the control (the
reference in the program's place with TF32's rounding of every product)
and each fault planted under the timed path come out not correct."""
import json

import pytest
import torch

from portbench import calibrate, traffic
from portbench.run import ROOT, run_cell
from portbench.tests import faults, tiny

SEED = 2 ** 31 + 101
CPU = torch.device('cpu')
CELLS = {'pp_kitti_train': (tiny.pp_config, tiny.PP_TRAFFIC),
         'centerpoint_nus_predict': (tiny.cp_config, tiny.CP_TRAFFIC)}


def limits(name):
    return json.loads((ROOT / 'portbench' / 'limits'
                       / f'{name}.json').read_text())['limits']


def cell(name, wrap=None, trace=0, seed=SEED):
    cfg, over = CELLS[name]
    return run_cell(name, seed, 0.5, trace, CPU, cfg=cfg(),
                    traffic_over=over, wrap=wrap)


@pytest.mark.parametrize('name', sorted(CELLS))
def test_sound_run_is_correct(name):
    out = cell(name, trace=1)
    assert out['correct'], out['checks']
    assert out['attempted'] > 0 and out['failed'] == 0
    assert list(out)[-1] == 'checks'
    assert set(out['checks']) == set(limits(name))


@pytest.mark.parametrize('name', sorted(CELLS))
def test_control_is_not_correct(name):
    cfg, over = CELLS[name]
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    spec = next(w for w in bench['workloads'] if w['name'] == name)
    tf = dict(traffic.load(spec['traffic']), **over)
    fn = calibrate.train_seed if tf['loop'] == 'train' \
        else calibrate.predict_seed
    rec = fn(cfg(), tf, SEED, CPU)
    lim = limits(name)
    assert all(rec['program'][k] <= v for k, v in lim.items()), rec
    assert any(rec['control'][k] > v for k, v in lim.items()), rec


@pytest.mark.parametrize('name, fault', [
    ('pp_kitti_train', faults.unchanged_state),
    ('pp_kitti_train', faults.half_batch_train),
    ('centerpoint_nus_predict', faults.half_batch_predict),
    ('centerpoint_nus_predict', faults.altered_answer),
])
def test_fault_is_not_correct(name, fault):
    out = cell(name, wrap=fault)
    assert not out['correct'], out['checks']


def test_a_quarter_turned_rectangle_is_the_same_box():
    import numpy as np
    from portbench.checks import predict as pc
    box = np.array([[3.0, -6.0, -0.8, 6.9, 0.34, 0.14, -0.25, 1.0, -0.6,
                     0.97]])
    turned = box.copy()
    turned[0, [3, 4]] = box[0, [4, 3]]
    turned[0, 6] += np.pi / 2
    assert pc._dist(turned, box)[0, 0] < 1e-12
    moved = box.copy()
    moved[0, 0] += 1.0
    assert pc._dist(moved, box)[0, 0] >= 1.0 / 3.0


def test_the_reference_in_blocks_reads_the_same():
    """The reference with its targets assigned in blocks of frames, as a
    batch of more than ``TARGET_FRAMES`` frames assigns them, gives the
    same readings bit for bit."""
    from portbench import families, weights
    from portbench.checks import train as tc
    from portbench.families.common import to_device
    from portbench.reference import pointpillars
    cfg = tiny.pp_config()
    tf = dict(traffic.load('kitti_train_b48'), **dict(tiny.PP_TRAFFIC,
                                                      frames=4, pool=2))
    fam = families.get(cfg['family'])
    w0 = weights.make(fam.reference(cfg, 'meta'), cfg['init'], SEED, CPU)
    batches = [to_device(b, CPU) for b in traffic.make_pool(tf, SEED)]
    plain = tc.reference(fam, cfg, w0, batches, CPU)
    old = pointpillars.TARGET_FRAMES
    pointpillars.TARGET_FRAMES = 1
    try:
        blocks = tc.reference(fam, cfg, w0, batches, CPU)
    finally:
        pointpillars.TARGET_FRAMES = old
    assert blocks == plain
