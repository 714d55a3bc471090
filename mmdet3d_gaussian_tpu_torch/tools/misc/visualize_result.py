"""Dump prediction results (the pkl of ``tools.test --out``) as ``.obj``
overlays on the val frames (the port's counterpart of the JAX package's
``tools/misc/visualize_result.py``).

    python -m mmdet3d_gaussian_tpu_torch.tools.misc.visualize_result \
        CONFIG RESULTS.pkl [--out-dir DIR] [--score-thr 0.3] [--num 5]
"""
from __future__ import annotations

import argparse
import pickle
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('config')
    p.add_argument('results', help='pkl from tools.test --out')
    p.add_argument('--out-dir', default='work_dirs/vis')
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--num', type=int, default=5)
    args = p.parse_args(argv)
    from ... import datasets  # noqa: F401  (registers the datasets)
    from ...core.visualizer import show_result
    from ...registry import DATASETS
    from ..common import load_config

    cfg = load_config(args.config)
    ds = DATASETS.build(dict(cfg.data['val']))
    with open(args.results, 'rb') as f:
        results = pickle.load(f)
    paths = []
    for i in range(min(args.num, len(ds), len(results))):
        item = ds[i]
        ann = ds.get_ann_info(i)
        preds = np.concatenate([r for r in results[i]], 0)
        preds = preds[preds[:, -1] >= args.score_thr][:, :7]
        pts = item['points'][item['points_mask']] if item else None
        paths.append(show_result(pts, ann['gt_bboxes'], preds, args.out_dir,
                                 f'frame{i:04d}'))
        print('wrote', paths[-1])
    return paths


if __name__ == '__main__':
    main()
