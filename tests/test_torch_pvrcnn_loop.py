"""PV-RCNN through the port's config path, loop and CLIs on the CPU.

The PV-RCNN KITTI config builds the full-width detector (its featmap,
anchors and class count; ``--bf16`` dropped, f32 only); then a TINY PV-RCNN
config (``tests/test_pvrcnn.py``'s widths over ``tests/test_torch_loop.py``'s
KITTI tree and seeded pipeline) trains 2 steps through ``tools.train`` and
is evaluated by ``tools.test`` from its checkpoint: finite loss terms with
the sparse overflow metric, every AP finite in [0, 100].  JAX's own CLIs
cannot train or restore PV-RCNN (its loop indexes ``variables['params']``
of a ``{'first', 'second'}`` tree), so nothing here runs against them; the
step itself is held to JAX's in ``tests/test_torch_pvrcnn.py``.
"""
import json
import os

import numpy as np
import pytest
import torch

from mmdet3d_gaussian_tpu_torch.engine.loop import detector_num_classes
from mmdet3d_gaussian_tpu_torch.engine.pvrcnn import PVRCNNDetector
from mmdet3d_gaussian_tpu_torch.tools import common

from tests.test_pvrcnn import TINY_PVRCNN, TINY_RPN
from tests.test_torch_loop import PCR, _cli, read_log
from tests.test_torch_loop import config as loop_config
from tests.test_train_loop import make_kitti_tree

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'configs', 'kitti',
                      'hv_pvrcnn_secfpn_4x4_80e_kitti-3d-3class.py')
STEPS = 2


@pytest.mark.parametrize('overrides', [None, dict(compute_dtype='bfloat16')])
def test_pvrcnn_config_builds(overrides):
    """The config's model and head build ``PVRCNNDetector`` at full width
    (f32 whatever the override says, as JAX's ``tools/test.py``)."""
    cfg = common.load_config(CONFIG)
    det = common.build_detector(cfg, 'cpu', model_overrides=overrides)
    assert isinstance(det, PVRCNNDetector)
    assert det.featmap_size == (200, 176)
    assert tuple(det.anchors.shape) == (200, 176, 3, 2, 7)
    assert detector_num_classes(det) == 3
    assert det.cfg['num_keypoints'] == 2048 and det.cfg['num_proposals'] == 128
    assert det.trunk.first.middle_encoder.bev_channels == 256
    assert det.trunk.second.bbox_head.shared[0].linear.in_features == 216 * 128
    assert all(p.dtype == torch.float32 for p in det.trunk.parameters())


def pvrcnn_config(root):
    """A TINY PV-RCNN config over the loop test's KITTI tree: 0.8 x 0.8 x
    1/6 m voxels on its 25.6 x 25.6 x 4 m range (sparse shape 24 x 32 x
    32), the TINY widths and RPN test settings, anchors over the range."""
    cfg = loop_config(root)
    model = dict(TINY_PVRCNN, type='PVRCNN', voxel_size=(0.8, 0.8, 1 / 6),
                 point_cloud_range=tuple(PCR), sparse_shape=(24, 32, 32))
    lo, hi = PCR[:2], PCR[3:5]
    head = dict(TINY_RPN, anchor_generator=dict(
        TINY_RPN['anchor_generator'],
        ranges=[[lo[0] + 0.4, lo[1] + 0.4, z, hi[0] - 0.4, hi[1] - 0.4, z]
                for z in (-1.0, -1.0, -1.0)]))
    cfg.update(model=model, head=head)
    cfg['data']['val'] = dict(cfg['data']['train'], pipeline=[
        t for t in cfg['data']['train']['pipeline']
        if t['type'] in ('LoadPointsFromFile', 'PointsRangeFilter',
                         'Pad3D')])
    return cfg


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('pvrcnn_loop')
    root = tmp / 'kitti'
    make_kitti_tree(root)
    cfg = pvrcnn_config(root)
    cfg_path = tmp / 'tiny_pvrcnn_cfg.py'
    cfg_path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    work = tmp / 'work'
    train = ['mmdet3d_gaussian_tpu_torch.tools.train', str(cfg_path),
             '--work-dir', str(work), '--max-steps', str(STEPS),
             '--log-interval', '1']
    out_train = _cli(train + ['--device', 'cpu'], tmp)
    test = ['mmdet3d_gaussian_tpu_torch.tools.test', str(cfg_path),
            str(work / f'ckpt_{STEPS}.pt')]
    out_test = _cli(test + ['--device', 'cpu', '--bf16'], tmp)
    return dict(tmp=tmp, work=work, train=train, test=test,
                out_train=out_train, out_test=out_test)


def test_pvrcnn_train_cli(cli_runs):
    out = cli_runs['out_train']
    assert out.returncode == 0, out.stderr[-3000:]
    log = read_log(cli_runs['work'])
    assert [r['step'] for r in log] == list(range(1, STEPS + 1))
    terms = ('rpn.loss_cls', 'rpn.loss_bbox', 'rpn.loss_dir',
             'loss_semantic', 'loss_roi_cls', 'loss_roi_bbox', 'loss_corner',
             'loss', 'grad_norm', 'metric.sparse_overflow')
    for r in log:
        assert all(np.isfinite(r[k]) for k in terms), r
    assert log[0]['loss'] != log[1]['loss']
    with open(cli_runs['work'] / f'meta_{STEPS}.json') as f:
        assert json.load(f)['config']['model']['type'] == 'PVRCNN'


def test_pvrcnn_test_cli(cli_runs):
    """The checkpoint restores strictly and evaluates (``--bf16`` is
    dropped for PV-RCNN): every AP finite in [0, 100]."""
    out = cli_runs['out_test']
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'frames 6,' in out.stdout
    report = json.loads(out.stdout[out.stdout.index('{'):])
    aps = {k: v for k, v in report.items() if 'AP' in k}
    assert aps and all(0 <= v <= 100 for v in aps.values()), aps


def test_pvrcnn_clis_need_a_device(cli_runs):
    """No card here: without ``--device`` both CLIs raise."""
    for args in (cli_runs['train'], cli_runs['test']):
        out = _cli(args, cli_runs['tmp'])
        assert out.returncode != 0
        assert 'CUDA is not available' in out.stderr, out.stderr[-2000:]
