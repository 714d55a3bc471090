"""The port's KITTI converters against the JAX package's on the CPU.

``tests/test_data_converter.py``'s raw KITTI tree (velodyne bins, calib and
label_2 txts, planes) is converted twice, by the JAX tools
(``tools/data_converter/``) and by the port's copies
(``mmdet3d_gaussian_tpu_torch/tools/data_converter/``, run as
``python -m``): the info and GT-database pickles must be equal (the same
keys, arrays equal), the reduced clouds and the database's patches equal
byte for byte, and the port's ``KittiDataset`` loads the port's infos.
"""
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np

from tests.test_data_converter import make_raw_kitti

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools', 'data_converter'))


def assert_same(got, want, where='info'):
    """Nested dicts, lists and arrays equal, with the same keys."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f'{where}/{k}')
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{where}[{i}]')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_converters_match_jax(tmp_path):
    import mmdet3d_gaussian_tpu  # noqa: F401
    import kitti_converter as jkc
    from create_gt_database import create_groundtruth_database as jdb

    jroot = make_raw_kitti(tmp_path / 'jax')
    (tmp_path / 'jax' / 'ImageSets').mkdir()
    (tmp_path / 'jax' / 'ImageSets' / 'train.txt').write_text(
        '000000\n000001\n')
    (tmp_path / 'jax' / 'ImageSets' / 'val.txt').write_text('000002\n')
    troot = tmp_path / 'port'
    shutil.copytree(jroot, troot)

    # the JAX tools, in this process: infos of both splits, the database
    for split, name in (('training', 'train'), ('val', 'val')):
        with open(jroot / f'kitti_infos_{name}.pkl', 'wb') as f:
            pickle.dump(jkc.create_kitti_infos(str(jroot), split), f)
    jdb(str(jroot), str(jroot / 'kitti_infos_train.pkl'))

    # the port's, as their command lines
    env = dict(os.environ, PYTHONPATH=ROOT)
    for tool in ('kitti_converter', 'create_gt_database'):
        out = subprocess.run(
            [sys.executable, '-m',
             f'mmdet3d_gaussian_tpu_torch.tools.data_converter.{tool}',
             str(troot)], cwd=tmp_path, env=env, capture_output=True,
            text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
    assert 'Car: 2 patches' in out.stdout

    for name in ('kitti_infos_train.pkl', 'kitti_infos_val.pkl',
                 'kitti_dbinfos_train.pkl'):
        with open(jroot / name, 'rb') as f:
            want = pickle.load(f)
        with open(troot / name, 'rb') as f:
            got = pickle.load(f)
        assert_same(got, want, name)
    written = [f for f in _files(jroot)
               if f.startswith(('training/velodyne_reduced',
                                'kitti_gt_database'))]
    assert len(written) == 3 + 2
    assert written == [f for f in _files(troot)
                       if f.startswith(('training/velodyne_reduced',
                                        'kitti_gt_database'))]
    for f in written:
        assert (troot / f).read_bytes() == (jroot / f).read_bytes(), f

    from mmdet3d_gaussian_tpu_torch.datasets.kitti import KittiDataset
    ds = KittiDataset(data_root=str(troot),
                      ann_file=str(troot / 'kitti_infos_train.pkl'),
                      pipeline=[dict(type='LoadPointsFromFile', load_dim=4,
                                     use_dim=4),
                                dict(type='Pad3D', num_points=1024,
                                     num_gt=8)])
    assert len(ds) == 2
    item = ds[0]
    box = item['gt_bboxes'][item['gt_valid']][0]
    np.testing.assert_allclose(box[:3], [10, 0, -1.0], atol=1e-3)
