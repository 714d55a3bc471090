"""Affinity calculators for the flexible evaluator (reference
``core/evaluation/affinity.py:5-32``).  ``LARGER_CLOSER`` tells the matcher
whether larger affinity means a better match (IoU) or worse (distance)."""
from __future__ import annotations

import numpy as np

from ...registry import EVAL_AFFINITY_CALS
from . import geometry_np as G
from . import native


def _geom():
    """The native library where it builds, else the numpy versions (which
    ``MMDET3D_TPU_REQUIRE_NATIVE=1`` refuses)."""
    if native.available():
        return native
    native.refuse_fallback('box geometry')
    return G


@EVAL_AFFINITY_CALS.register_module()
class LidarIOU3D:
    LARGER_CLOSER = True

    def __init__(self, z_offset: float = 0.5):
        self.z_offset = z_offset

    def __call__(self, det_bboxes, gt_bboxes, gt_iscrowd=None):
        assert gt_iscrowd is None, 'crowd annotations not supported yet'
        return _geom().iou_3d(np.asarray(det_bboxes, np.float32),
                              np.asarray(gt_bboxes, np.float32),
                              self.z_offset)


@EVAL_AFFINITY_CALS.register_module()
class LidarIOUBEV:
    LARGER_CLOSER = True

    def __call__(self, det_bboxes, gt_bboxes, gt_iscrowd=None):
        assert gt_iscrowd is None, 'crowd annotations not supported yet'
        return _geom().iou_bev(np.asarray(det_bboxes, np.float32),
                               np.asarray(gt_bboxes, np.float32))


@EVAL_AFFINITY_CALS.register_module()
class LidarCenterTransBEV:
    LARGER_CLOSER = False

    def __call__(self, det_bboxes, gt_bboxes, gt_iscrowd=None):
        assert gt_iscrowd is None, 'crowd annotations not supported yet'
        return G.trans_bev(np.asarray(det_bboxes, np.float32),
                           np.asarray(gt_bboxes, np.float32))
