"""The three KITTI MVF configs through the port's converters and CLIs on
the CPU.

``tests/test_data_converter.py``'s raw KITTI tree goes through the port's
``kitti_converter`` and ``create_gt_database``; each of
``configs/kitti/pillarmvf_*`` is loaded from its file with its data paths
moved onto that tree, its widths cut to TINY ones (feature channels 16,
one layer a SECOND stage; the views, canvases, pipelines, heads' losses
and schedules as written) and 2 samples a batch, then trained one step by
``tools.train`` and evaluated by ``tools.test`` with ``--device cpu``.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from mmdet3d_gaussian_tpu_torch.tools import test as test_cli
from mmdet3d_gaussian_tpu_torch.tools import train as train_cli
from mmdet3d_gaussian_tpu_torch.tools.data_converter.create_gt_database \
    import create_groundtruth_database
from mmdet3d_gaussian_tpu_torch.tools.data_converter.kitti_converter import \
    create_kitti_infos
from mmdet3d_gaussian_tpu_torch.utils.config import Config

from tests.test_data_converter import make_raw_kitti

torch.set_num_threads(2)

CONFIGS = os.path.join(os.path.dirname(__file__), '..', 'configs', 'kitti')
NAMES = ('pillarmvf_pointpillars_secfpn_8x4_160e_kitti-3d-3class.py',
         'pillarmvf_pointpillars_secfpn_bd5tau1_8x4_160e_kitti-3d-3class.py',
         'pillarmvf_centerpoint_secfpn_8x4_160e_kitti-3d-3class.py')


@pytest.fixture(scope='module')
def kitti_root(tmp_path_factory):
    root = make_raw_kitti(tmp_path_factory.mktemp('mvf_cfg') / 'kitti')
    for split, name in (('training', 'train'), ('val', 'val')):
        with open(root / f'kitti_infos_{name}.pkl', 'wb') as f:
            pickle.dump(create_kitti_infos(str(root), split), f)
    create_groundtruth_database(str(root),
                                str(root / 'kitti_infos_train.pkl'))
    return root


def tiny_config(name, root):
    """The config file's dict, data paths under ``root``, TINY widths."""
    cfg = Config.fromfile(os.path.join(CONFIGS, name)).to_dict()
    model = cfg['model']
    model['encoder_cfg']['feat_channels'] = 16
    model['backbone_cfg'].update(in_channels=16, out_channels=(16, 32, 64),
                                 layer_nums=(1, 1, 1))
    model['neck_cfg'].update(in_channels=(16, 32, 64),
                             out_channels=(16, 16, 16))
    if model.get('head_type') == 'center':
        cfg['head']['test_cfg'].update(max_per_img=16, post_max_size=16)
    else:
        model['head_cfg']['feat_channels'] = 48
        cfg['head'].setdefault('test_cfg', {}).update(nms_pre=64,
                                                      max_num=16)
    data = cfg['data']
    data.update(samples_per_gpu=2, workers_per_gpu=1)
    train = data['train'].get('dataset', data['train'])
    for d, ann in ((train, 'kitti_infos_train.pkl'),
                   (data['val'], 'kitti_infos_val.pkl')):
        d.update(data_root=str(root), ann_file=str(root / ann))
    for t in train['pipeline']:
        if t['type'] == 'ObjectSample':
            t['db_sampler'].update(
                data_root=str(root),
                info_path=str(root / 'kitti_dbinfos_train.pkl'))
    return cfg


@pytest.mark.parametrize('name', NAMES)
def test_mvf_config_trains_and_tests(name, kitti_root, tmp_path, capsys):
    cfg = tiny_config(name, kitti_root)
    assert cfg['model']['voxelize_mode'] == 'mvf'
    path = tmp_path / 'cfg.py'
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    work = tmp_path / 'work'
    train_cli.main([str(path), '--work-dir', str(work), '--max-steps', '1',
                    '--log-interval', '1', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert os.path.exists(work / 'ckpt_1.pt')
    with open(work / 'train_log.jsonl') as f:
        log = [line for line in f]
    assert len(log) == 1 and 'NaN' not in log[0]
    report = test_cli.main([str(path), str(work / 'ckpt_1.pt'),
                            '--device', 'cpu', '--metric', 'kitti'])
    out = capsys.readouterr().out
    assert 'frames 3,' in out and 'AP11' in out
    assert report and all(np.isfinite(v) for v in report.values())
