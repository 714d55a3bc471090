"""The port's export CLI (twin of ``tests/test_export.py::
test_export_cli``): ``python -m mmdet3d_gaussian_tpu_torch.tools.export``
on a TINY KITTI config with ``--device cpu`` writes a bundle whose
program serves the predict of the detector the config builds, from its
seeded init and from a checkpoint."""
import json
import os
import subprocess
import sys

import torch

from tests.test_train_loop import _cfg, make_kitti_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _export(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-m',
                        'mmdet3d_gaussian_tpu_torch.tools.export', *args],
                       capture_output=True, text=True, env=env, cwd=cwd,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


def _write_cfg(tmp_path):
    make_kitti_tree(tmp_path)
    d = _cfg(tmp_path).to_dict()
    path = tmp_path / 'cfg.py'
    with open(path, 'w') as f:
        for k in ('model', 'head', 'data', 'optimizer'):
            f.write(f'{k} = {d[k]!r}\n')
    return path


def _first_batch(cfg):
    from mmdet3d_gaussian_tpu_torch.engine.loop import (build_dataloader,
                                                        to_device)
    _, make_iter = build_dataloader(cfg, 'train')
    it = make_iter(0)
    batch = next(it)
    it.close()
    return to_device(batch, torch.device('cpu'))


def test_export_cli(tmp_path):
    from mmdet3d_gaussian_tpu_torch.engine.export import load_exported
    from mmdet3d_gaussian_tpu_torch.tools.common import (build_detector,
                                                         load_config)
    cfg_path = _write_cfg(tmp_path)
    out_dir = tmp_path / 'bundle'
    _export([str(cfg_path), '--out-dir', str(out_dir), '--device', 'cpu'],
            str(tmp_path))
    assert (out_dir / 'predict.pt2').exists()
    meta = json.loads((out_dir / 'meta.json').read_text())
    assert meta['device'] == 'cpu'
    assert meta['classes'] == ['Pedestrian', 'Cyclist', 'Car']
    assert meta['batch_spec']['points'] == [[2, 1024, 4], 'float32']
    assert 'mmdet3d_torch::bev_splat' in meta['ops']

    cfg = load_config(str(cfg_path))
    det = build_detector(cfg, 'cpu')
    batch = _first_batch(cfg)
    served = load_exported(str(out_dir))
    for a, b in zip(served(batch), det.predict(batch)):
        assert torch.equal(a, b)


def test_export_cli_restores_checkpoint(tmp_path):
    """A checkpoint's weights go into the program (the cls bias moved
    off its focal prior, so the served scores change)."""
    from mmdet3d_gaussian_tpu_torch.engine.export import load_exported
    from mmdet3d_gaussian_tpu_torch.tools.common import (build_detector,
                                                         load_config)
    cfg_path = _write_cfg(tmp_path)
    cfg = load_config(str(cfg_path))
    det = build_detector(cfg, 'cpu')
    with torch.no_grad():
        det.trunk.bbox_head.conv_cls.bias.zero_()
    ckpt = tmp_path / 'ckpt_1.pt'
    torch.save({'state_dict': det.trunk.state_dict()}, ckpt)
    out_dir = tmp_path / 'bundle'
    _export([str(cfg_path), str(ckpt), '--out-dir', str(out_dir),
             '--device', 'cpu'], str(tmp_path))
    batch = _first_batch(cfg)
    got = load_exported(str(out_dir))(batch)
    want = det.predict(batch)
    assert int(want[3].sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_loader_runs_under_the_exported_tf32_switches():
    """A bundle records the TF32 switches it was exported under and the
    loaded callable runs with them, restoring the caller's after (an f32
    program exported with TF32 off stays f32 on a server whose defaults
    turn it on)."""
    from mmdet3d_gaussian_tpu_torch.engine.export import _Loaded

    class Program:
        def module(self):
            return lambda batch: (torch.backends.cuda.matmul.allow_tf32,
                                  torch.backends.cudnn.allow_tf32)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        served = _Loaded(Program(), dict(tf32=dict(matmul=False,
                                                   cudnn=False)))
        assert served({}) == (False, False)
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (True, True)
        assert _Loaded(Program(), {})({}) == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]
