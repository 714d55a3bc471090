"""The port's ``CowaDataset`` (twin of ``tests/test_cowa_dataset.py``):
8 classes, out-of-eval-range GT ignored, the range-breakdown report; items,
annotations and reports equal to the JAX package's on the same tree and
results."""
import numpy as np

import mmdet3d_gaussian_tpu  # noqa: F401  (registers the JAX datasets)
from mmdet3d_gaussian_tpu.registry import DATASETS as JDATASETS

from mmdet3d_gaussian_tpu_torch import datasets  # noqa: F401
from mmdet3d_gaussian_tpu_torch.registry import DATASETS as TDATASETS

from tests.test_cowa_dataset import make_cowa_tree


def _cfg(root, info_path):
    return dict(type='CowaDataset', data_root=str(root),
                ann_file=str(info_path),
                eval_point_cloud_range=[0, -40, -3, 70.4, 40, 1],
                pipeline=[dict(type='LoadPointsFromFile', load_dim=4,
                               use_dim=4),
                          dict(type='Pad3D', num_points=1024, num_gt=8)])


def _results(ds, drop=('truck',), score=0.9, jitter=0.0):
    rng = np.random.RandomState(0)
    out = []
    for i in range(len(ds)):
        a = ds.get_ann_info(i)
        per_cls = [np.zeros((0, 8), np.float32) for _ in ds.CLASSES]
        for ci, cls in enumerate(ds.CLASSES):
            if cls in drop:
                continue
            det = a['gt_bboxes'][a['gt_labels'] == ci]
            det = det + jitter * rng.randn(*det.shape)
            per_cls[ci] = np.c_[det, np.full((len(det), 1), score)].astype(
                np.float32)
        out.append(per_cls)
    return out


def test_cowa_dataset_eval(tmp_path):
    info_path = make_cowa_tree(tmp_path)
    ds = TDATASETS.build(_cfg(tmp_path, info_path))
    assert len(ds) == 4
    assert len(ds.CLASSES) == 8
    ann = ds.get_ann_info(0)
    ig = ann['gt_attrs']['ignore']
    names = [ds.CLASSES[lab] for lab in ann['gt_labels']]
    assert ig[names.index('truck')]
    assert not ig[names.index('car')]
    rep = ds.evaluate(_results(ds))
    assert 'mAP' in rep and 'mAP_near' in rep
    assert np.isclose(rep['mAP'], 1.0), rep
    assert np.isclose(rep['mAP_near'], 1.0), rep


def test_cowa_dataset_matches_jax(tmp_path):
    """Items, annotations (ignore flags included) and the report on
    imperfect detections equal to the JAX package's."""
    info_path = make_cowa_tree(tmp_path, num_frames=5, seed=3)
    tds = TDATASETS.build(_cfg(tmp_path, info_path))
    jds = JDATASETS.build(_cfg(tmp_path, info_path))
    assert tds.CLASSES == jds.CLASSES
    for i in range(len(jds)):
        ta, ja = tds.get_ann_info(i), jds.get_ann_info(i)
        for k in ('gt_bboxes', 'gt_labels'):
            np.testing.assert_array_equal(ta[k], ja[k])
        np.testing.assert_array_equal(ta['gt_attrs']['ignore'],
                                      ja['gt_attrs']['ignore'])
        ti, ji = tds[i], jds[i]
        for k in ji:
            if isinstance(ji[k], np.ndarray):
                np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
    results = _results(jds, drop=('cone',), score=0.7, jitter=0.3)
    trep = tds.evaluate(results)
    jrep = jds.evaluate(results)
    assert set(trep) == set(jrep)
    for k in jrep:
        np.testing.assert_allclose(trep[k], jrep[k], err_msg=k)
