"""The port's misc CLIs against the JAX package's (twins of
``tests/test_misc_cli.py``): ``tools.misc.browse_dataset`` and
``tools.misc.visualize_result`` write the same ``.obj`` files as JAX's
scripts on the same config and results, and ``tools.test --format-only
--show-dir`` writes the same overlays as JAX's ``tools/test.py`` with the
same weights (points byte-equal, boxes to the files' 4 decimals); the
launchers hand their arguments to torchrun as documented."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tests.test_train_loop import _cfg, make_kitti_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, 'mmdet3d_gaussian_tpu_torch', 'tools')


@pytest.fixture()
def kitti_cfg(tmp_path):
    make_kitti_tree(tmp_path)
    cfg = _cfg(tmp_path)
    cfg.data['val'] = dict(cfg.data['train'])
    cfg_path = tmp_path / 'cfg.py'
    d = cfg.to_dict()
    with open(cfg_path, 'w') as f:
        for k in ('model', 'head', 'data', 'optimizer'):
            f.write(f'{k} = {d[k]!r}\n')
    return tmp_path, cfg_path


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    r = subprocess.run([sys.executable] + args, capture_output=True,
                       text=True, env=env, timeout=300, cwd=cwd)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


def _objs(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith('.obj'):
                with open(os.path.join(dirpath, f), 'rb') as fh:
                    out[os.path.relpath(os.path.join(dirpath, f),
                                        root)] = fh.read()
    return out


def _same_objs(got, want, box_tol=0.0):
    """Same files; points files byte-equal; box files with the same
    lines, their numbers within ``box_tol``."""
    assert got and sorted(got) == sorted(want)
    for name, data in want.items():
        if name.endswith('_points.obj') or box_tol == 0.0:
            assert got[name] == data, name
            continue
        g, w = got[name].decode().split('\n'), data.decode().split('\n')
        assert len(g) == len(w), name
        for a, b in zip(g, w):
            fa, fb = a.split(), b.split()
            assert fa[:1] == fb[:1], name
            np.testing.assert_allclose(np.float64(fa[1:]), np.float64(fb[1:]),
                                       rtol=0, atol=box_tol, err_msg=name)


def test_browse_dataset_cli(kitti_cfg, tmp_path):
    root, cfg_path = kitti_cfg
    _run(['-m', 'mmdet3d_gaussian_tpu_torch.tools.misc.browse_dataset',
          str(cfg_path), '--out-dir', str(tmp_path / 'port'), '--num', '2'],
         str(tmp_path))
    _run([f'{REPO}/tools/misc/browse_dataset.py', str(cfg_path),
          '--out-dir', str(tmp_path / 'jax'), '--num', '2'], str(tmp_path))
    got, want = _objs(tmp_path / 'port'), _objs(tmp_path / 'jax')
    assert any(k.endswith('_gt.obj') for k in got)
    _same_objs(got, want)


def test_visualize_result_cli(kitti_cfg, tmp_path):
    root, cfg_path = kitti_cfg
    det = np.array([[5.0, 0.0, -1.0, 3.9, 1.6, 1.56, 0.0, 0.9],
                    [9.0, 2.0, -1.2, 0.8, 0.6, 1.7, 0.4, 0.3]], np.float32)
    results = [[det, det[:0], det[1:]] for _ in range(4)]
    pkl = tmp_path / 'results.pkl'
    with open(pkl, 'wb') as f:
        pickle.dump(results, f)
    port = 'mmdet3d_gaussian_tpu_torch.tools.misc.visualize_result'
    for name, script in (('port', ['-m', port]),
                         ('jax', [f'{REPO}/tools/misc/visualize_result.py'])):
        _run(script + [str(cfg_path), str(pkl), '--out-dir',
                       str(tmp_path / name), '--num', '2', '--score-thr',
                       '0.5'], str(tmp_path))
    got, want = _objs(tmp_path / 'port'), _objs(tmp_path / 'jax')
    assert any(k.endswith('_pred.obj') for k in got)
    _same_objs(got, want)


def test_test_cli_format_only_and_show_dir(kitti_cfg, tmp_path):
    """Both test CLIs with the weights JAX's CLI builds (its init with
    PRNGKey(0) on the first val batch), every candidate kept
    (score_thr 0): the same frames and files; points byte-equal, box
    corners within 2e-4 (the files keep 4 decimals)."""
    import mmdet3d_gaussian_tpu  # noqa: F401
    from mmdet3d_gaussian_tpu.engine import detector as jdet
    from mmdet3d_gaussian_tpu.engine.loop import build_dataloader
    from mmdet3d_gaussian_tpu.utils.config import Config
    from mmdet3d_gaussian_tpu_torch.weights import jax_variables_to_torch
    root, cfg_path = kitti_cfg
    cfg = Config.fromfile(str(cfg_path))
    det = jdet.PointPillarsDetector(model_cfg=dict(cfg.model),
                                    head_cfg=dict(cfg.head))
    _, make_iter = build_dataloader(cfg, 'val')
    it = make_iter(0)
    first = next(it)
    it.close()
    first.pop('metas', None)
    variables = jax.jit(det.init)(jax.random.PRNGKey(0), first)
    ckpt = tmp_path / 'ckpt_0.pt'
    torch.save({'state_dict': jax_variables_to_torch(
        jax.tree_util.tree_map(np.asarray, variables))}, ckpt)
    opts = ['--cfg-options', 'head.test_cfg.score_thr=0.0']
    port = ['-m', 'mmdet3d_gaussian_tpu_torch.tools.test', str(cfg_path),
            str(ckpt), '--device', 'cpu']
    jax_cli = [f'{REPO}/tools/test.py', str(cfg_path)]
    for name, cli in (('port', port), ('jax', jax_cli)):
        out_pkl = tmp_path / f'{name}.pkl'
        r = _run(cli + ['--format-only', '--out', str(out_pkl), '--show-dir',
                        str(tmp_path / name), '--show-score-thr', '0.0']
                 + opts, str(tmp_path))
        assert 'formatted' in r.stdout, r.stdout[-300:]
        assert out_pkl.exists()
    got, want = _objs(tmp_path / 'port'), _objs(tmp_path / 'jax')
    assert sum(k.endswith('_points.obj') for k in got) >= 4
    assert any(k.endswith('_pred.obj') for k in got)
    _same_objs(got, want, box_tol=2e-4)


@pytest.mark.parametrize('script,args,want', [
    ('dist_train.sh', ['cfg.py', '4', '--max-steps', '3'],
     '--standalone --nproc_per_node=4 --master_port=29500 -m '
     'mmdet3d_gaussian_tpu_torch.tools.train cfg.py --distributed '
     '--max-steps 3'),
    ('dist_test.sh', ['cfg.py', 'ckpt.pt', '2', '--metric', 'cowa'],
     '--standalone --nproc_per_node=2 --master_port=29500 -m '
     'mmdet3d_gaussian_tpu_torch.tools.test cfg.py ckpt.pt --metric cowa'),
])
def test_launchers(tmp_path, script, args, want):
    """Each launcher execs torchrun with the CLI module and its arguments
    (a stand-in torchrun on the PATH prints what it was given)."""
    fake = tmp_path / 'bin'
    fake.mkdir()
    (fake / 'torchrun').write_text('#!/bin/sh\necho "$@"\n')
    (fake / 'torchrun').chmod(0o755)
    env = dict(os.environ, PATH=f'{fake}:{os.environ["PATH"]}')
    env.pop('PORT', None)
    r = subprocess.run(['bash', os.path.join(TOOLS, script), *args],
                       capture_output=True, text=True, env=env, timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == want


def test_test_cli_other_ranks_return(tmp_path, monkeypatch, capsys):
    """Under torchrun the test CLI runs on rank 0; another rank returns
    before it builds anything."""
    from mmdet3d_gaussian_tpu_torch.tools import test
    monkeypatch.setenv('RANK', '1')
    assert test.main([str(tmp_path / 'missing.py'), '--device', 'cpu']) \
        is None
    assert 'runs on rank 0' in capsys.readouterr().out
