"""Greedy COCO-protocol matcher (reference ``ops/eval/matcher.cpp:8-75`` +
adapter ``core/evaluation/matcher.py:6-36``).

Score-descending detections greedily claim the lowest-cost unmatched GT per
threshold, with ignore/crowd semantics:
  * a det provisionally matched to an *ignore* GT upgrades to any non-ignore
    GT under the threshold;
  * crowd GTs may absorb multiple detections.

Pure-NumPy implementation with an optional C++ fast path
(csrc/eval_ops.cpp, loaded in ``native.py``).
"""
from __future__ import annotations

import numpy as np

from ...registry import EVAL_MATCHERS
from . import native


def match_coco_np(cost_mat: np.ndarray, cost_thrs: np.ndarray,
                  is_ignore: np.ndarray, is_crowd: np.ndarray) -> np.ndarray:
    """cost_mat (D, G) lower = better; returns matched gt idx (T, D), -1 =
    unmatched.  Iteration order over detections is the row order (callers
    pre-sort by descending score)."""
    num_det, num_gt = cost_mat.shape
    num_thr = len(cost_thrs)
    out = np.full((num_thr, num_det), -1, np.int32)
    for t in range(num_thr):
        thr = cost_thrs[t]
        gt_matched = np.zeros(num_gt, bool)
        for d in range(num_det):
            cost = thr
            match = -1
            for g in range(num_gt):
                if gt_matched[g] and not is_crowd[g]:
                    continue
                c = cost_mat[d, g]
                if match == -1:
                    if c <= cost:
                        cost, match = c, g
                elif is_ignore[match]:
                    if not is_ignore[g]:
                        if c <= thr:
                            cost, match = c, g
                    elif c <= cost:
                        cost, match = c, g
                else:
                    if not is_ignore[g] and c <= cost:
                        cost, match = c, g
            if match != -1:
                gt_matched[match] = True
            out[t, d] = match
    return out


def _match_impl():
    """The native matcher where the library builds, else the numpy one
    (which ``MMDET3D_TPU_REQUIRE_NATIVE=1`` refuses)."""
    if native.available():
        return native.match_coco_native
    native.refuse_fallback('matcher')
    return match_coco_np


class BaseMatcher:
    def __init__(self, match_thrs, affinity_cost_negate: bool = True):
        self._match_thrs = list(match_thrs)
        self.negate = affinity_cost_negate

    @property
    def match_thrs(self):
        return self._match_thrs

    def __call__(self, affinity, gt_isignore=None, gt_iscrowd=None):
        affinity = np.asarray(affinity, np.float32)
        if gt_iscrowd is None:
            gt_iscrowd = np.zeros(affinity.shape[1], bool)
        if gt_isignore is None:
            gt_isignore = np.zeros(affinity.shape[1], bool)
        thrs = np.asarray(self.match_thrs, np.float32)
        if self.negate:
            return self.match(-affinity, -thrs, gt_isignore, gt_iscrowd)
        return self.match(affinity, thrs, gt_isignore, gt_iscrowd)

    def match(self, cost, thrs, gt_isignore, gt_iscrowd):
        raise NotImplementedError


@EVAL_MATCHERS.register_module()
class MatcherCoCo(BaseMatcher):
    def match(self, cost, thrs, gt_isignore, gt_iscrowd):
        return _match_impl()(np.ascontiguousarray(cost, np.float32),
                             np.asarray(thrs, np.float32),
                             np.asarray(gt_isignore, bool),
                             np.asarray(gt_iscrowd, bool))
