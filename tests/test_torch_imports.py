"""The PyTorch port and chip_smoke.py import neither JAX nor the JAX
package (the machine with the card has no JAX)."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import mmdet3d_gaussian_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r'''
import importlib, pkgutil, sys
import mmdet3d_gaussian_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ('jax', 'flax', 'jaxlib', 'mmdet3d_gaussian_tpu')
             or m.split('.')[0] in ('jax', 'flax', 'jaxlib')
             or m.startswith('mmdet3d_gaussian_tpu.'))
print(len(names), bad)
'''


def test_port_modules_listed():
    names = {m.name for m in pkgutil.walk_packages(
        mmdet3d_gaussian_tpu_torch.__path__, 'mmdet3d_gaussian_tpu_torch.')}
    for mod in ('ops.segment', 'ops.voxelize', 'ops.rotated_iou', 'ops.nms',
                'ops.scatter', 'engine.detector', 'weights'):
        assert 'mmdet3d_gaussian_tpu_torch.' + mod in names


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(' ', 1)
    assert int(count) >= 20
    assert bad == '[]', bad


def test_registry_builds_port_modules():
    """Modules register on import and build from a config dict."""
    from mmdet3d_gaussian_tpu_torch.models.detectors import voxelnet  # noqa
    from mmdet3d_gaussian_tpu_torch.registry import MODELS
    enc = MODELS.build(dict(type='DynamicPillarFeatureNet',
                            feat_channels=(8,)))
    assert enc.pfn_layers[0].linear.out_features == 8
    assert 'PointPillarsNet' in MODELS and 'SECONDFPN' in MODELS
    with pytest.raises(KeyError):
        MODELS.get('NotAModule')
    with pytest.raises(TypeError):
        MODELS.build(dict(feat_channels=(8,)))
