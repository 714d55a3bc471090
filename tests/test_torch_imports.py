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
                'ops.scatter', 'engine.detector', 'weights', 'ops.bn',
                'ops.gd_loss', 'ops.scan', 'models.losses.gaussian',
                'models.losses.common', 'core.bbox.assigners',
                'core.bbox.coders', 'core.schedules',
                'parallel.train_state', 'models.backbones',
                'models.detectors.voxelnet',
                'models.dense_heads.anchor3d_head', 'utils.config',
                'datasets.pipelines', 'datasets.dbsampler', 'datasets.kitti',
                'datasets.mem_util', 'datasets.other_datasets',
                'core.evaluation.geometry_np', 'core.evaluation.native',
                'core.evaluation.affinity', 'core.evaluation.breakdown',
                'core.evaluation.matcher', 'core.evaluation.mean_ap',
                'core.evaluation.kitti_official', 'engine.loop',
                'engine.prefetch', 'tools.train', 'tools.test',
                'tools.common', 'ops.heatmap',
                'models.dense_heads.centerpoint_head',
                'core.evaluation.nuscenes_metrics', 'models.mvf_encoder',
                'engine.timing', 'tools.data_converter.kitti_converter',
                'tools.data_converter.create_gt_database',
                'ops.sparse_conv', 'ops.vsa', 'models.middle_encoders',
                'models.roi_heads', 'engine.pvrcnn', 'models.img_fusion',
                'models.detectors.mvx_faster_rcnn', 'engine.mvx',
                'parallel.mesh', 'core.evaluation.waymo_metrics',
                'parallel.point_sharding', 'parallel.sharded_model',
                'ops.library', 'engine.export', 'engine.profiling',
                'tools.export', 'tools.misc.summarize_trace',
                'tools.misc.profile_train_step',
                'tools.misc.profile_loss_phase', 'tools.misc.bench_eval',
                'tools.misc.browse_dataset', 'tools.misc.visualize_result',
                'core.visualizer', 'core.visualizer.geometry',
                'core.visualizer.plot_bev', 'core.visualizer.open3d_vis'):
        assert 'mmdet3d_gaussian_tpu_torch.' + mod in names


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(' ', 1)
    assert int(count) >= 90
    assert bad == '[]', bad


def test_registry_builds_port_modules():
    """Modules register on import and build from a config dict."""
    from mmdet3d_gaussian_tpu_torch.models.detectors import voxelnet  # noqa
    from mmdet3d_gaussian_tpu_torch.registry import MODELS
    enc = MODELS.build(dict(type='DynamicPillarFeatureNet',
                            feat_channels=(8,)))
    assert enc.pfn_layers[0].linear.out_features == 8
    assert 'PointPillarsNet' in MODELS and 'SECONDFPN' in MODELS
    from mmdet3d_gaussian_tpu_torch.engine import pvrcnn  # noqa: F401
    for name in ('MlvlSparseEncoder', 'VoxelSetAbstraction',
                 'PointwiseMaskHead', 'Batch3DRoIGridExtractor',
                 'PVRCNNBboxHead'):
        assert name in MODELS
    sa = MODELS.build(dict(type='VoxelSetAbstraction', num_keypoints=8,
                           point_channels=4, bev_channels=8,
                           bev_sa_config=dict(scale_factor=8)))
    assert sa.fusion.linear.in_features == 8
    with pytest.raises(KeyError):
        MODELS.get('NotAModule')
    with pytest.raises(TypeError):
        MODELS.build(dict(feat_channels=(8,)))
