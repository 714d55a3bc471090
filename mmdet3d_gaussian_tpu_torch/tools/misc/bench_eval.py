"""Time the flexible evaluator at validation-set scale (the port's
counterpart of the JAX package's ``tools/misc/bench_eval.py``).

    python -m mmdet3d_gaussian_tpu_torch.tools.misc.bench_eval \
        [--frames 3769] [--nproc 4]

Draws KITTI-val-scale detections from a seed (3,769 frames of 3 classes
by default, ~12 GT boxes and 25 detections a frame), runs
``core/evaluation/mean_ap.py::eval_map_flexible`` with the native C++
affinity and matcher (``MMDET3D_TPU_REQUIRE_NATIVE=1`` refuses the numpy
path) and prints the wall time and the report.  Host only.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np


def synth_frame(rng, num_gt=12, num_det=25):
    """(per-class (N, 8) detections, annotation dict) of one frame."""
    ctr = np.c_[rng.uniform(0, 70, (num_gt, 1)),
                rng.uniform(-40, 40, (num_gt, 1)),
                rng.uniform(-2, 0, (num_gt, 1))]
    dims = rng.uniform([1.5, 0.5, 1.4], [4.5, 2.0, 1.8], (num_gt, 3))
    yaw = rng.uniform(-np.pi, np.pi, (num_gt, 1))
    gt = np.c_[ctr, dims, yaw].astype(np.float32)
    labels = rng.randint(0, 3, num_gt).astype(np.int64)
    base = gt[rng.randint(0, num_gt, num_det)]
    det = base + rng.normal(0, 0.15, base.shape).astype(np.float32)
    det_labels = rng.randint(0, 3, num_det)
    scores = rng.uniform(0.05, 1.0, (num_det, 1)).astype(np.float32)
    det8 = np.concatenate([det, scores], -1)
    per_class = [det8[det_labels == c] for c in range(3)]
    return per_class, dict(gt_bboxes=gt, gt_labels=labels, gt_attrs={})


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--frames', type=int, default=3769)
    p.add_argument('--nproc', type=int, default=4)
    args = p.parse_args(argv)
    os.environ.setdefault('MMDET3D_TPU_REQUIRE_NATIVE', '1')
    from ...core.evaluation import native
    from ...core.evaluation.mean_ap import eval_map_flexible

    if not native.available():
        raise RuntimeError('the native eval library did not build')
    rng = np.random.RandomState(0)
    results, annos = [], []
    for _ in range(args.frames):
        r, a = synth_frame(rng)
        results.append(r)
        annos.append(a)
    t0 = time.perf_counter()
    rep = eval_map_flexible(
        results, annos, match_thrs=[0.5, 0.7],
        affinity_calculator=dict(type='LidarIOU3D', z_offset=0.5),
        classes=['Pedestrian', 'Cyclist', 'Car'], nproc=args.nproc,
        report_config=[('mAP', lambda k: k['breakdown'] == 'All')])
    dt = time.perf_counter() - t0
    print(f'frames={args.frames} nproc={args.nproc} wall={dt:.2f}s '
          f'({args.frames / dt:.0f} frames/s) report={rep}')
    return rep


if __name__ == '__main__':
    main()
