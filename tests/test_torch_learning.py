"""The port learns to an AP (twin of ``tests/test_learning.py::
test_train_to_ap_regression_band``, slow): the TINY hard PointPillars from
JAX's init weights trained 1,000 steps on the same fixed-seed scenes, then
its predictions through the port's official KITTI evaluator.  Car/Mod R40
3D AP must land in the JAX test's band."""
import numpy as np
import pytest
import torch

import jax

from mmdet3d_gaussian_tpu.engine.detector import PointPillarsDetector as JDet

from mmdet3d_gaussian_tpu_torch.core.evaluation.kitti_official import \
    kitti_eval
from mmdet3d_gaussian_tpu_torch.datasets.kitti import KittiDataset
from mmdet3d_gaussian_tpu_torch.engine.detector import PointPillarsDetector
from mmdet3d_gaussian_tpu_torch.parallel.train_state import make_optimizer
from mmdet3d_gaussian_tpu_torch.weights import jax_variables_to_torch

from tests.test_learning import (_AP_CALIB, AP_BAND, TINY, TINY_HEAD,
                                 scene)


def _fixed_batches():
    """The JAX test's 6 batches of 4 scenes of 6 cars (numpy)."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(6):
        b = dict(points=[], points_mask=[], gt_bboxes=[], gt_labels=[],
                 gt_valid=[])
        for _ in range(4):
            p, bx, lb, vl = scene(rng, num_gt=6)
            b['points'].append(p)
            b['points_mask'].append(np.ones(len(p), bool))
            b['gt_bboxes'].append(bx)
            b['gt_labels'].append(lb)
            b['gt_valid'].append(vl)
        out.append({k: np.stack(v) for k, v in b.items()})
    return out


@pytest.mark.slow
def test_train_to_ap_regression_band():
    fixed = _fixed_batches()
    variables = jax.jit(JDet(model_cfg=TINY, head_cfg=TINY_HEAD).init)(
        jax.random.PRNGKey(0), fixed[0])
    det = PointPillarsDetector(TINY, TINY_HEAD, device='cpu')
    det.trunk.load_state_dict(jax_variables_to_torch(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in fixed]
    state = det.init_train(optimizer=make_optimizer(
        3e-3, total_steps=1000, target_ratio=(3.0, 1e-2)))
    for i in range(1000):
        state, m = det.train_step(batches[i % 6], state)
    assert np.isfinite(float(m['loss']))

    classes = ('Pedestrian', 'Cyclist', 'Car')
    to_anno = KittiDataset.lidar_det_to_kitti_anno
    gt_annos, dt_annos = [], []
    for tb in batches:
        boxes, scores, labels, valid = (t.numpy() for t in det.predict(tb))
        for i in range(boxes.shape[0]):
            per_cls, per_cls_gt = [], []
            gt = tb['gt_bboxes'][i].numpy()
            gv, gl = tb['gt_valid'][i].numpy(), tb['gt_labels'][i].numpy()
            for c in range(3):
                sel = valid[i] & (labels[i] == c)
                per_cls.append(np.concatenate(
                    [boxes[i][sel][:, :7], scores[i][sel][:, None]],
                    -1).astype(np.float32))
                gsel = gv & (gl == c)
                per_cls_gt.append(np.concatenate(
                    [gt[gsel][:, :7], np.ones((gsel.sum(), 1))],
                    -1).astype(np.float32))
            dt_annos.append(to_anno(per_cls, _AP_CALIB, classes=classes))
            gt_annos.append(to_anno(per_cls_gt, _AP_CALIB, classes=classes))
    res, report = kitti_eval(gt_annos, dt_annos, list(classes),
                             eval_types=('bev', '3d'))
    ap = res['Car_3d_moderate_strict_AP40']
    print('Car/Mod 3D AP40:', ap)
    assert AP_BAND[0] <= ap <= AP_BAND[1], (ap, report)
    ap_bev = res['Car_bev_moderate_strict_AP40']
    assert ap_bev >= ap - 1e-6, (ap_bev, ap)
